"""One run of one cell: set-up, the measured window, the traced stretch,
the judgement, the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration file, its traffic file, and one reader per per-layer
metric (``bench/metrics/<name>.py``, a function ``read(ctx)`` that returns a
number, or None when the run holds nothing for it to read).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import statistics
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from . import datagen, graph, judge, loader, tracing
from .loop import ClosedLoop

BENCH = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(manifest: dict, workload: str) -> tuple:
    """``(cell, config, traffic)`` of a workload named in the manifest."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = load_json(BENCH.parent / conf["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def metric_reader(name: str):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Context:
    """What a per-layer metric reader may read."""

    config: dict
    traffic: dict
    device_name: str
    updates: list            # the loop's ``Update`` records of the window
    queries: list            # the observer's per-batch records
    write_s: Optional[float]
    trace: Optional[tracing.TraceSummary]


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(manifest: dict, workload: str, *, seed: int, seconds: float,
             trace_on: bool, device, t_start: float,
             config: Optional[dict] = None,
             traffic: Optional[dict] = None) -> dict:
    """One run; returns the result line as a dict.  ``config`` /
    ``traffic`` replace the cell's files (the CPU tests shrink them)."""
    _, config0, traffic0 = cell_files(manifest, workload)
    config = config or config0
    traffic = traffic or traffic0
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    # ---- set-up ------------------------------------------------------------
    marks = [("start", t_start)]

    def mark(name):
        if cuda:
            torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    mark("imports")
    inputs = datagen.make_inputs(config, traffic, seed, dev)
    mark("inputs")
    b = config["builder"]
    base = inputs.table[:inputs.n_start]
    adj, start = graph.build_graph(
        base, metric=config["metric"], r=int(config["r"]),
        alpha=float(config["alpha"]), knn=int(b["knn"]),
        in_edges=int(b["in_edges"]), long_edges=int(b["long_edges"]),
        cells=int(b["cells"]), gen=datagen.generator(seed, dev, stream=1))
    mark("graph")
    state = loader.numpy_state(config, base, adj, start,
                               loader.max_external_id(config))
    del adj, base
    mark("to_host")
    idx = loader.load_index(config, state, dev)
    del state
    mark("load")
    observer = tracing.Observer() if trace_on else None
    loop = ClosedLoop(idx, inputs.table, inputs.n_start, inputs.queries,
                      traffic, observer)
    try:
        loop.warmup()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        mark("warmup")
        setup_s = marks[-1][1] - t_start

        # ---- the measured window -------------------------------------------
        w_before = observer.write_seconds() if observer else None
        n_warm = (len(loop.answers), len(loop.updates))
        t0, t1 = loop.run(seconds)
        w_after = observer.write_seconds() if observer else None
        window = (loop.answers[n_warm[0]:], loop.updates[n_warm[1]:])
        summary = None
        if trace_on:
            observer.profiling = True
            summary = tracing.profile(lambda: loop.run(2.0, "traced"), dev)
            observer.profiling = False
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        if observer:
            observer.close()
    answers, updates = loop.answers, loop.updates
    del loop, idx
    if cuda:
        torch.cuda.empty_cache()

    # ---- correctness -----------------------------------------------------
    checks, correct = judge.judge(answers, updates, inputs, config, traffic,
                                  seed)

    # ---- metrics -----------------------------------------------------------
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    w_answers, w_updates = window
    if not trace_on:
        n_q = sum(len(a.ext) for a in w_answers)
        n_u = sum(len(u.inserted) + len(u.deleted) for u in w_updates)
        values = {
            "search_qps": n_q / (t1 - t0),
            "updates_per_s": n_u / (t1 - t0),
            "setup_s": setup_s,
        }
        wanted = [m for m in manifest["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    else:
        ctx = Context(config=config, traffic=traffic, device_name=name,
                      updates=w_updates,
                      queries=observer.queries,
                      write_s=(None if w_before is None or w_after is None
                               else w_after - w_before),
                      trace=summary)
        wanted = [m for m in manifest["per_layer"]
                  if workload in m.get("workloads", [workload])]
        values = {m["name"]: metric_reader(m["name"])(ctx) for m in wanted}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if values.get(m["name"]) is not None}
    n_req = (sum(len(a.ext) for a in answers)
             + sum(len(u.inserted) + len(u.deleted) for u in updates))
    result = {
        "correct": correct,
        "attempted": n_req,
        "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": name,
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if trace_on and summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    if cuda:
        result["device"]["power_limit_w"] = power_limit_w()
    result["setup"] = {step: t - t_prev for (_, t_prev), (step, t)
                       in zip(marks, marks[1:])}
    result["window"] = {
        "seconds": t1 - t0, "query_batches": len(w_answers),
        "queries": sum(len(a.ext) for a in w_answers),
        "update_steps": len(w_updates),
        "updates": sum(len(u.inserted) + len(u.deleted) for u in w_updates),
        "query_ms_median": 1e3 * statistics.median(
            [a.seconds for a in w_answers]) if w_answers else None,
        "update_s": [u.seconds for u in w_updates][:64]}
    result["checks"] = checks
    return result

