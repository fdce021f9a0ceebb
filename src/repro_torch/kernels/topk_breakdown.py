"""Where the time of the ``topk_score`` kernel goes, on the card.

Times ``topk_score_cuda`` at the recall oracle's shape (B queries against an
N-row table, D = 128, k = 10, 10% of rows biased out, Gaussian data made
from ``--seed``) in four builds and inputs, and splits its time by
difference:

  * ``compute``: a build that stages only the first slices and keeps no
    lists (``TOPK_SKIP_LOADS`` + ``TOPK_SKIP_EPILOGUE``): the FMA loop fed
    from shared memory;
  * ``staging``: a build that keeps no lists (``TOPK_SKIP_EPILOGUE``),
    less ``compute``: the cp.async copies of the row and query tiles;
  * ``epilogue``: the regular kernel with every row biased out (no score
    passes a threshold, so nothing is merged), less the two above: scores,
    the shared score tile and the threshold tests;
  * ``merges``: the regular kernel on the real bias, less all of the above:
    the rank merges of the passing scores.

Beside them, ``addmm_ms``: the (B, N) fp32 product alone through one
``torch.addmm`` (no top-k), what the card's fp32 library gives for the
same products.

The diagnostic builds give wrong results and are loaded only here.  Prints
one JSON object with the card's name and power limit.  Usage:
``PYTHONPATH=src python -m repro_torch.kernels.topk_breakdown [--seed S]``.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from . import build
from . import topk_score as tk


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def breakdown(seed=0, b=1024, n=1_000_000, d=128, k=10, reps=5):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    vec = torch.randn((n, d), generator=gen, device="cuda")
    norms = (vec * vec).sum(1)
    qi = torch.randint(0, n, (b,), generator=gen, device="cuda")
    queries = (vec[qi] + torch.randn((b, d), generator=gen, device="cuda")
               / 16).contiguous()
    bias = torch.where(torch.rand((n,), generator=gen, device="cuda") < 0.1,
                       float("inf"), 0.0).to(torch.float32)
    dead = torch.full_like(bias, float("inf"))
    regular = build.lib("topk_score")
    libs = {
        "regular": regular,
        "skip_epilogue": build.build_variant("topk_score",
                                             ["TOPK_SKIP_EPILOGUE"]),
        "skip_both": build.build_variant(
            "topk_score", ["TOPK_SKIP_LOADS", "TOPK_SKIP_EPILOGUE"]),
    }
    ms = {}
    try:
        for name, lib in libs.items():
            build._LIBS["topk_score"] = lib
            ms[name] = _time_ms(lambda: tk.topk_score_cuda(
                queries, vec, norms, bias, k=k), reps)
            if name == "regular":
                ms["all_biased_out"] = _time_ms(lambda: tk.topk_score_cuda(
                    queries, vec, norms, dead, k=k), reps)
    finally:
        build._LIBS["topk_score"] = regular
    parts = {
        "compute": ms["skip_both"],
        "staging": ms["skip_epilogue"] - ms["skip_both"],
        "epilogue": ms["all_biased_out"] - ms["skip_epilogue"],
        "merges": ms["regular"] - ms["all_biased_out"],
    }
    addmm_ms = _time_ms(lambda: torch.addmm(norms + bias, queries, vec.T,
                                            alpha=-2.0), reps)
    return {"shape": {"B": b, "N": n, "D": d, "k": k}, "ms": ms,
            "parts_ms": parts, "addmm_ms": addmm_ms,
            "chunks": regular.topk_n_chunks(b, n, k),
            "chunks_one_query": regular.topk_n_chunks(1, n, k)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("topk_breakdown: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()
    out = breakdown(args.seed)
    out["device"] = smi
    print(json.dumps(out))


if __name__ == "__main__":
    main()
