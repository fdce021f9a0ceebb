"""Run one cell of the benchmark of ``repro_torch`` on this machine's card.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The last line of standard output is the
result as one JSON object; the numbers that decide ``correct`` are also the
last lines of standard error, each beside its limit.  Exits with another code
than 0, and prints no result, when there is no CUDA device (or fewer than the
cell asks for), when the program cannot be imported, or when JAX or the JAX
package has been loaded.  Kernels build once into ``build/`` of the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# run as a script, Python puts bench/ first on the path, where its modules
# would shadow others of the same name: the harness imports them as bench.*
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path.pop(0)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if args.seed < 0:
        print("--seed must be non-negative", file=sys.stderr)
        return 2
    # every build and kernel cache at a fixed path inside the checkout, so
    # that only a checkout's first run builds
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from bench import guard, manifest
    from bench.harness import cell_files

    import torch
    import repro_torch  # noqa: F401  (the program; fails without it)

    guard.check("after importing the program")
    m = manifest.load()
    cell, _, _ = cell_files(m, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    from bench.harness import run_cell

    result = run_cell(m, args.workload, seed=args.seed,
                      seconds=args.seconds, trace_on=bool(args.trace),
                      device="cuda", t_start=T_START)
    guard.check("after the window")
    print(f"correct = {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['holds']} "
              f"{c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
