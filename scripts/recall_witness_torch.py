"""Recall@10 of the two-tower twin's path B (``chip_smoke.py`` phase 9c) at
its own configuration, three ways: on the card, over the same 2,048 item
embeddings and 1,024 user vectors on the CPU through the plain kernel
versions, and on the card over Gaussian vectors of the same shape.  The
first two holding the same recall puts a low recall on the data rather than
on the CUDA kernels; the third shows the index's recall at this
configuration on data that is not a random tower's.  Needs one card:

    python3 scripts/recall_witness_torch.py

Prints one JSON object, also written to ``chiprun_out/recall_witness.json``.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SEED = 0          # chip_smoke.py's default --seed
N_ITEMS = 2048    # path B's live count: 256 serial + 1,792 streamed


def run(name, cand, users, dev, oracle):
    """Path B over ``cand`` and ``users`` on ``dev``; Recall@10 against
    kernel 4 over ``oracle`` = (users, catalogue) on the card."""
    import chip_smoke as cs

    t0 = time.perf_counter()
    rec, answers = cs.path_b(cand, users, dev)
    rec.pop("launches")
    for key, (ids, live) in answers.items():
        rec[f"recall_at_10_{key}"] = cs.recall_vs_exact(ids, *oracle, live)
    rec["s"] = time.perf_counter() - t0
    cs.log(f"{name}: Recall@10 {rec['recall_at_10_before']:.4f} before the "
           f"deletes, {rec['recall_at_10_after']:.4f} after "
           f"({rec['s']:.1f} s)")
    return rec, {k: v[0] for k, v in answers.items()}


def spread(x):
    """Norms and the mean pairwise cosine of the rows of ``x``."""
    import torch

    nrm = x.norm(dim=1)
    u = x / nrm[:, None]
    return {"norm_min": float(nrm.min()), "norm_max": float(nrm.max()),
            "mean_pairwise_cos": float((u @ u.T).mean())}


def main():
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("recall_witness_torch: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda", 0)
    spec = cs.recsys_spec("two-tower-retrieval")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state = spec.init_state(spec.shapes()["retrieval_cand"], dev, gen)
    users = cs.twin_users(spec, state, SEED)
    cand = state["cand_embs"]
    del state
    out = {"items": spread(cand[:N_ITEMS]), "users": spread(users)}
    card, ids_card = run("card", cand, users, dev, (users, cand))
    cpu, ids_cpu = run("cpu", cand[:N_ITEMS].cpu(), users.cpu(),
                       torch.device("cpu"), (users, cand))
    out.update(card=card, cpu=cpu, ids_equal_share={
        k: float(np.mean(ids_card[k] == ids_cpu[k])) for k in ids_card})
    del cand, users
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(SEED + 44)
    gcand = torch.randn((N_ITEMS, 256), generator=g, device=dev)
    gusers = torch.randn((1024, 256), generator=g, device=dev)
    out["gaussian"], _ = run("gaussian", gcand, gusers, dev, (gusers, gcand))
    out["device"] = torch.cuda.get_device_name(0)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    line = json.dumps(out)
    (out_dir / "recall_witness.json").write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
