"""Tiny shapes of the benchmark's cells for the CPU tests: the cells'
own files with the table, the degree, the beam and the batch shrunk."""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness, manifest  # noqa: E402

SEED = 2 ** 31 + 11


def tiny(workload: str) -> tuple:
    """``(config, traffic)`` of ``workload`` at a size the CPU runs in
    seconds."""
    _, cfg, tr = harness.cell_files(manifest.load(), workload)
    cfg = dict(cfg, n_live=2000, n_cap=4096, dim=min(cfg["dim"], 32), r=16,
               l_build=32, l_search=32, l_delete=32, k_delete=16,
               builder=dict(knn=24, in_edges=12, long_edges=4, cells=8),
               data=dict(cfg["data"], n_clusters=8))
    cycle = [dict(c, repeat=min(int(c.get("repeat", 1)), 4))
             if c["op"] == "query" else c for c in tr["cycle"]]
    tr = dict(tr, query_batch=min(int(tr["query_batch"]), 64), l=32,
              query_pool_batches=4, sample_batches=6, cycle=cycle,
              max_update_steps=min(int(tr["max_update_steps"]), 64))
    return cfg, tr


def run_tiny(workload: str, *, trace_on: bool = False, seconds: float = 1.5,
             seed: int = SEED, device: str = "cpu") -> dict:
    cfg, tr = tiny(workload)
    return harness.run_cell(manifest.load(), workload, seed=seed,
                            seconds=seconds, trace_on=trace_on,
                            device=device, t_start=time.perf_counter(),
                            config=cfg, traffic=tr)
