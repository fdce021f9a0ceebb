"""Kernel 5 (``csrc/quant_gather.cu``) against an earlier version of its
source, on one card, in turns.

``PYTHONPATH=src python -m repro_torch.kernels.quant_gather_compare
--baseline DIR``, where DIR holds the earlier ``quant_gather.cu`` and its
headers (e.g. ``git archive <commit> src/repro_torch/csrc`` unpacked under
the git-ignored ``build/``).  At a hop's (B, R) tile and at the batched
search's start column (K = 1), over n_cap = 10^6 int8 rows of D = 128 with
10% INVALID ids, it checks that both give the same bits and prints one JSON
line: per version and shape the device time per launch (``torch.profiler``
over launches in the order earlier, current, current, earlier) and the
median time of one call on CUDA events (the current one through
``BoundQuantGather``), beside the card's name and power limit.  The earlier
launcher takes no launch shape (``quant_gather_launch(ids, queries, codes,
scales, qnorms, out, B, K, N, D, l2, stream)``).  Nothing on the port's
path loads it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

_P, _I = ctypes.c_void_p, ctypes.c_int
EARLIER_SIGNATURE = [("quant_gather_launch", [_P] * 6 + [_I] * 5 + [_P])]
# the kernels' names in a profiler trace
NAMES = {"earlier": "quant_gather_kernel", "current":
         "quant_gather_block_kernel"}


def _in_turns(fns, reps):
    """Median ms of one call (CUDA events) of each of ``fns``, called in the
    order earlier, current, current, earlier."""
    import torch

    times = {key: [] for key in fns}
    for _ in range(reps):
        for key in ("earlier", "current", "current", "earlier"):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fns[key]()
            e1.record()
            torch.cuda.synchronize()
            times[key].append(e0.elapsed_time(e1))
    return {key: statistics.median(ts) for key, ts in times.items()}


def _device_ms(fns, reps):
    """Mean device ms per launch of each version's kernel, from one trace of
    launches in turns."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for key in ("earlier", "current", "current", "earlier"):
                fns[key]()
        torch.cuda.synchronize()
    us = dict.fromkeys(fns, 0.0)
    for ev in prof.key_averages():
        for key, name in NAMES.items():
            # "quant_gather_kernel" is no part of the current kernel's name
            if name in ev.key:
                us[key] += getattr(ev, "self_device_time_total", None) or \
                    getattr(ev, "self_cuda_time_total", 0.0)
    return {key: v / (2 * reps) / 1e3 for key, v in us.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True,
                    help="directory of the earlier quant_gather.cu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args(argv)

    import torch

    from . import build
    from . import quant_gather as qg

    if not torch.cuda.is_available():
        print("quant_gather_compare: no CUDA device", file=sys.stderr)
        return 2
    base = Path(args.baseline)
    earlier_fn = build.build_variant(
        "quant_gather", [], source=base / "quant_gather.cu",
        includes=(base,), signatures=EARLIER_SIGNATURE).quant_gather_launch
    n, d, b = 1_000_000, 128, 512
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    codes = torch.randint(-127, 128, (n, d), generator=gen, device="cuda",
                          dtype=torch.int8)
    scales = torch.rand((n,), generator=gen, device="cuda") / 64
    qnorms = torch.rand((n,), generator=gen, device="cuda") * 100
    queries = torch.randn((b, d), generator=gen, device="cuda")
    stream = build.stream(queries)
    out = {"device": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "baseline": str(base), "shapes": {}}
    for k in (64, 1):
        ids = torch.randint(0, n, (b, k), generator=gen, device="cuda",
                            dtype=torch.int32)
        ids[torch.rand((b, k), generator=gen, device="cuda") < 0.1] = -1
        bound = qg.BoundQuantGather(queries, codes, scales, qnorms)

        def earlier(ids=ids, k=k):
            res = torch.empty((b, k), dtype=torch.float32, device="cuda")
            err = earlier_fn(ids.data_ptr(), queries.data_ptr(),
                             codes.data_ptr(), scales.data_ptr(),
                             qnorms.data_ptr(), res.data_ptr(), b, k, n, d,
                             1, stream)
            build.check(err, "earlier quant_gather")
            return res

        fns = {"earlier": earlier,
               "current": lambda ids=ids, bound=bound: bound(ids)}
        same = torch.equal(earlier(), fns["current"]())
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        out["shapes"][f"{b}x{k}"] = {
            "bitwise_equal": same,
            "device_ms": _device_ms(fns, args.reps),
            "call_ms": _in_turns(fns, args.reps)}
        if not same:
            print(json.dumps(out))
            print(f"quant_gather_compare: the versions differ at K = {k}",
                  file=sys.stderr)
            return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
