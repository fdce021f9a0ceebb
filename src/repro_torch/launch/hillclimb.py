"""The hillclimb runner for the three chosen cells
(``repro/launch/hillclimb.py``), on the fake production mesh.

Each experiment runs a cell's step once with one candidate change
(``dryrun.run_cell``: host-only, nothing allocated) and records its memory,
collectives and roofline terms (H100 model, ``cost.py``) to
``experiments/hillclimb_torch/<cell>__<variant>.json``.

    python -m repro_torch.launch.hillclimb --cell moe_train
    python -m repro_torch.launch.hillclimb --cell decode
    python -m repro_torch.launch.hillclimb --cell retrieval

``--reduced`` runs each variant on the arch's reduced spec on a fake (2, 2)
mesh (a check of the variants, seconds on a host).

``retrieval__ann_index`` serves candidates from the IP-DiskANN graph.  The
port's ``greedy_search`` reads the host every hop (``core/search.py:93``),
which a step over meta tensors cannot, so that record holds the exact
per-device bytes of the graph state under its placements and the
reference's FLOP estimate (float32, at that peak), and says that its
collectives and step were not measured.

Every variant runs in this one process, after the baseline: a cell's
counts do not depend on what ran before it (``cost.StepCost``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
from pathlib import Path

from ..configs import get_arch
from ..configs.base import P, axes_of, shard_shape
from .cost import HARDWARE, PEAKS
from .dryrun import run_cell
from .mesh import PRODUCTION

OUT = (Path(__file__).resolve().parents[3] / "experiments"
       / "hillclimb_torch")
REDUCED_MESH = ((2, 2), ("data", "model"))
VARIANTS = ("baseline", "accum4", "ep_only", "bf16_gather", "tp_params",
            "local_topk", "ann_index")


def _mesh(reduced: bool):
    return REDUCED_MESH if reduced else PRODUCTION[False]


def _write(rec, out_dir) -> dict:
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{rec['tag']}.json").write_text(json.dumps(rec,
                                                               indent=1))
    if rec["status"] == "ok" and rec["roofline"]["dominant"] is None:
        print(f"[{rec['tag']}] args/dev={rec['memory']['argument_bytes']} "
              f"comp={rec['roofline']['compute_s']:.3g}; collectives "
              f"{rec['collectives']}", flush=True)
    elif rec["status"] == "ok":
        r = rec["roofline"]
        print(f"[{rec['tag']}] peak={rec['peak_gib']}GiB "
              f"dominant={r['dominant']} comp={r['compute_s']:.4f} "
              f"mem={r['memory_s']:.4f} coll={r['collective_s']:.4f} "
              f"frac={r['roofline_fraction']:.4f}", flush=True)
    else:
        print(f"[{rec['tag']}] {rec['status']}: "
              f"{rec.get('error', rec.get('reason'))}", flush=True)
    return rec


def measure(tag, spec, shape, *, reduced=False, out_dir=OUT) -> dict:
    mesh_shape, names = _mesh(reduced)
    rec = run_cell(spec, shape, mesh_shape=mesh_shape, axis_names=names,
                   verbose=False)
    rec["tag"] = tag
    if rec["status"] == "ok":
        rec["peak_gib"] = round(
            rec["memory"]["peak_bytes_per_device"] / 2**30, 2)
    return _write(rec, out_dir)


def _lm(name, reduced, **dims):
    spec = get_arch(name)
    return dataclasses.replace(spec.reduced(), **dims) if reduced else spec


# ---------------------------------------------------------------------------
# Cell 1: qwen3-moe-235b train_4k — most collective-bound
# ---------------------------------------------------------------------------


def moe_train(variants, reduced=False, out_dir=OUT):
    # reduced: a batch whose accum4 microbatches (4 * 32 / dp_size of
    # them) still split over the data axis
    spec = _lm("qwen3-moe-235b-a22b", reduced, train_batch=128)
    shape = spec.shapes()["train_4k"]
    out = []
    if "baseline" in variants:
        out.append(measure("moe_train__baseline", spec, shape,
                           reduced=reduced, out_dir=out_dir))
    if "accum4" in variants:
        # fewer microbatches trade memory for fewer collective rounds
        out.append(measure("moe_train__accum4",
                           dataclasses.replace(spec, accum_steps=4), shape,
                           reduced=reduced, out_dir=out_dir))
    if "bf16_gather" in variants:
        # cast fp32 master weights to bf16 before the layers run, so the
        # fsdp all-gathers move bf16
        out.append(measure("moe_train__bf16_gather",
                           dataclasses.replace(spec, bf16_weight_gather=True,
                                               moe_fsdp_dim="ff"), shape,
                           reduced=reduced, out_dir=out_dir))
    if "ep_only" in variants:
        # the expert fsdp axis on d_ff rather than d_model
        out.append(measure("moe_train__ep_ff_fsdp",
                           dataclasses.replace(spec, moe_fsdp_dim="ff"),
                           shape, reduced=reduced, out_dir=out_dir))
    return out


# ---------------------------------------------------------------------------
# Cell 2: qwen2-72b decode_32k — worst roofline family (memory-bound)
# ---------------------------------------------------------------------------


def decode(variants, reduced=False, out_dir=OUT):
    spec = _lm("qwen2-72b", reduced)
    shape = spec.shapes()["decode_32k"]
    out = []
    if "baseline" in variants:
        out.append(measure("decode__baseline", spec, shape, reduced=reduced,
                           out_dir=out_dir))
    if "tp_params" in variants:
        # model-only (TP) serving params: weights resident, no per-token
        # all-gather
        out.append(measure("decode__tp_params",
                           dataclasses.replace(spec, serve_param_fsdp=False),
                           shape, reduced=reduced, out_dir=out_dir))
    return out


# ---------------------------------------------------------------------------
# Cell 3: two-tower retrieval_cand — the paper's serving scenario
# ---------------------------------------------------------------------------


def ann_index_record(d: int, n: int, mesh_shape, names) -> dict:
    """The graph-index variant: the IP-DiskANN state for ``n`` candidates
    of dim ``d`` sharded over the whole mesh like the tables, its exact
    per-device bytes, and the reference's FLOP estimate of one search
    (~hops * R * d * 2)."""
    from ..core import init_state
    from ..core.types import ANNConfig

    cfg = ANNConfig(dim=d, n_cap=n, r=64, l_build=128, l_search=128,
                    metric="ip")
    state = init_state(cfg, device="meta")
    sizes = dict(zip(names, mesh_shape))
    axes = axes_of(sizes)
    every = axes.all
    specs = {
        "vectors": P(every, None), "norms": P(every), "adj": P(every, None),
        "active": P(every), "tombstone": P(every), "quarantine": P(every),
        "free_stack": P(every), "free_top": P(), "start": P(),
        "n_active": P(), "n_pending": P(),
    }
    arg = 0
    for field, spec in specs.items():
        x = getattr(state, field)
        arg += math.prod(shard_shape(x.shape, spec, sizes)) * x.element_size()
    arg += 4 * d                               # the query, replicated
    flops = 176 * 64 * d * 2.0
    n_dev = math.prod(mesh_shape)
    return {
        "status": "ok",
        "memory": {"argument_bytes": arg, "output_bytes": None,
                   "temp_bytes": None, "alias_bytes": None,
                   "peak_bytes_per_device": None},
        "collectives": "not measured: the port's greedy_search reads the "
                       "host every hop (core/search.py:93), which a step "
                       "over meta tensors cannot",
        # the search's distances are float32 (``ANNConfig``'s vectors)
        "roofline": {"compute_s": flops / n_dev / PEAKS["fp32"],
                     "model_flops": flops,
                     "flops_per_device": flops / n_dev,
                     "flops_by_class": {"fp32": flops / n_dev},
                     "memory_s": None, "collective_s": None,
                     "dominant": None, "roofline_fraction": None,
                     "hardware": HARDWARE},
        "mesh": "x".join(map(str, mesh_shape)),
        "n_devices": n_dev,
        "n_candidates": n,
        "host_only": True,
    }


def retrieval(variants, reduced=False, out_dir=OUT):
    spec = get_arch("two-tower-retrieval")
    if reduced:
        spec = spec.reduced()
    shape = spec.shapes()["retrieval_cand"]
    out = []
    if "baseline" in variants:
        out.append(measure("retrieval__baseline", spec, shape,
                           reduced=reduced, out_dir=out_dir))
    if "local_topk" in variants:
        # a two-phase top-k (per-shard k, then merge k * shards) in place
        # of the top-k over the whole sharded score row
        out.append(measure("retrieval__local_topk",
                           dataclasses.replace(spec, two_phase_topk=True),
                           shape, reduced=reduced, out_dir=out_dir))
    if "ann_index" in variants:
        # beyond-paper composition: candidates from the graph index
        mesh_shape, names = _mesh(reduced)
        d = spec.cfg.tower_mlp[-1]
        n = 1_000_448 if not reduced else 1024
        rec = ann_index_record(d, n, mesh_shape, names)
        rec.update(tag="retrieval__ann_index", arch=spec.name,
                   shape=shape.name)
        out.append(_write(rec, out_dir))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True,
                    choices=["moe_train", "decode", "retrieval"])
    ap.add_argument("--variants", default="all")
    ap.add_argument("--reduced", action="store_true",
                    help="each variant on the reduced spec, fake (2, 2) "
                         "mesh")
    args = ap.parse_args(argv)
    v = (args.variants.split(",") if args.variants != "all"
         else list(VARIANTS))
    cell = {"moe_train": moe_train, "decode": decode,
            "retrieval": retrieval}[args.cell]
    return cell(v, reduced=args.reduced)


if __name__ == "__main__":
    main()
