"""The control: the plain reference put in the program's place, computed one
precision step below what the configuration states, and judged as a run's
answers are.  It has to come out not correct; its readings set the upper end
of each limit (``PERF.md``).  The benchmark's own runs never run it.

    python3 bench/control.py --workload <name> --seeds <n> [<n> ...]

The configurations state float32 distances computed without TF32 (the
program's kernels use no tensor cores), so the nearest precision below is
TF32.  The control turns the cell's own closed loop (``bench/loop.py``) over
an index that does nothing, for whole cycles holding at least
``MIN_BATCHES`` query batches: the same op stream, query batches and probe
rows a run makes.  The reference then answers the batches a run's judge
would sample.  It needs no graph.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):
    # run as a script: import the harness as bench.*, not from bench/
    _root = Path(__file__).resolve().parent.parent
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != _root / "bench"]
    sys.path.insert(0, str(_root))

from bench import datagen, judge, manifest  # noqa: E402
from bench.harness import cell_files  # noqa: E402
from bench.loop import ClosedLoop  # noqa: E402
from bench.reference.exact import exact_topk  # noqa: E402

PRECISION = "tf32"
MIN_BATCHES = 256


class NullIndex:
    """Takes every call and answers nothing: the loop's schedule alone."""

    def __init__(self, device, k: int):
        self.device = device
        self.k = k

    def insert(self, ids, vectors) -> None:
        pass

    def delete(self, ids) -> None:
        pass

    def search(self, queries, k, l):
        empty = np.full((len(queries), k), -1, np.int64)
        return empty, np.full(empty.shape, np.inf, np.float32), None


def control_run(config: dict, traffic: dict, seed: int, device,
                min_batches: int = MIN_BATCHES) -> tuple:
    """``(checks, correct)`` of the reference in TF32 in the program's
    place, over whole cycles of the traffic holding at least
    ``min_batches`` query batches.  Only the batches a run's judge would
    sample are answered."""
    dev = torch.device(device)
    k = int(traffic["k"])
    inputs = datagen.make_inputs(config, traffic, seed, dev)
    loop = ClosedLoop(NullIndex(dev, k), inputs.table, inputs.n_start,
                      inputs.queries, traffic)
    while len(loop.answers) < min_batches or loop.op_i % len(loop.ops):
        loop.step()
    live = judge.replay(loop.updates, inputs.n_rows, inputs.n_start)
    picks = judge.sample_batches(len(loop.answers),
                                 int(traffic["sample_batches"]), seed)
    answers = [loop.answers[i] for i in picks]
    for a in answers:
        q = judge.batch_queries(inputs, a)
        mask = torch.as_tensor(live.live_at(a.t), device=dev)
        ids, dists = exact_topk(q, inputs.table, mask, k, config["metric"],
                                PRECISION)
        a.ext = ids.cpu().numpy()
        a.dists = dists.cpu().numpy()
    return judge.judge(answers, loop.updates, inputs, config, traffic, seed)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    _, config, traffic = cell_files(manifest.load(), args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks, correct = control_run(config, traffic, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": PRECISION, "correct": correct,
                          "seconds": time.perf_counter() - t0,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
