"""End-to-end runbook driver on the PyTorch/CUDA port (the paper's §4
evaluation loop): replay an update stream against a streaming index under
one update policy, printing per-step recall.  The twin of
``examples/streaming_runbook.py``; the index lives on the card unless
``--device cpu`` is given (the plain PyTorch versions of the kernels).

    PYTHONPATH=src python examples/streaming_runbook_torch.py \
        [--mode ip|fresh|local] [--segmented] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import test_scale
from repro_torch.core import StreamingIndex, make_runbook, run_runbook

NAMES = {"ip": "IP-DiskANN", "fresh": "FreshDiskANN",
         "local": "localized repair"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runbook", default="sliding_window",
                    choices=["sliding_window", "expiration_time", "clustered"])
    ap.add_argument("--mode", default="ip", choices=sorted(NAMES))
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--segmented", action="store_true",
                    help="replay each eval window as whole-segment update "
                         "streams (StreamingIndex.apply_segments)")
    ap.add_argument("--device", default=None,
                    help="where the index lives (default: the card)")
    args = ap.parse_args(argv)

    kw = dict(n=args.n, dim=args.dim, seed=0)
    if args.runbook != "clustered":
        kw["t_max"] = args.steps
    else:
        kw.update(n_clusters=8, rounds=2)
    rb = make_runbook(args.runbook, **kw)

    cfg = test_scale(args.dim, int(rb.max_active * 1.6) + 64)
    idx = StreamingIndex(cfg, mode=args.mode, max_external_id=args.n + 1,
                         device=args.device)
    print(f"=== {args.runbook} / {NAMES[args.mode]} on {idx.device}"
          f"{' (segmented)' if args.segmented else ''} ===")
    rep = run_runbook(idx, rb, k=10, eval_every=2, segmented=args.segmented,
                      verbose=True)
    print("\nsummary:", rep.summary())


if __name__ == "__main__":
    main()
