"""Runbook driver (``repro/core/driver.py``): replay an update stream against
a ``StreamingIndex`` and record per-step recall, distance computations and
throughput (the paper's §4 loop, Figure 1).

The per-op path, for a ``StreamingIndex`` under any policy or, with
``baseline="hnsw"``, an ``HNSWIndex``; and with ``segmented=True`` the
segment path (``StreamingIndex.apply_segments``), one eval window at a
time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from .runbook import Runbook, runbook_update_stream


@dataclasses.dataclass
class StepMetrics:
    step: int
    n_active: int
    recall: float
    comps_per_query: float
    qps: float


@dataclasses.dataclass
class RunbookReport:
    name: str
    mode: str
    steps: List[StepMetrics]
    counters: "object"            # serving-side OpCounters
    avg_recall: float = 0.0
    eval_counters: "object" = None  # evaluation-side accounting

    def summary(self) -> dict:
        """Serving-side load only; evaluation sweeps are reported under
        separate ``eval_*`` keys."""
        c = self.counters
        out = {
            "runbook": self.name,
            "mode": self.mode,
            "avg_recall@10": round(self.avg_recall, 4),
            "insert_s": round(c.insert_s, 3),
            "delete_s": round(c.delete_s, 3),
            "segment_s": round(c.segment_s, 3),
            "search_s": round(c.search_s, 3),
            "n_consolidations": c.n_consolidations,
        }
        if self.eval_counters is not None:
            out["eval_search_s"] = round(self.eval_counters.search_s, 3)
            out["eval_queries"] = self.eval_counters.n_queries
        return out


def run_runbook(index, rb: Runbook, *, k: int = 10,
                eval_every: int = 1, max_steps: Optional[int] = None,
                segmented: bool = False, segment_t: int = 32,
                verbose: bool = False,
                baseline: Optional[str] = None) -> RunbookReport:
    """Replay ``rb`` against ``index`` (a ``StreamingIndex``, or an
    ``HNSWIndex`` with ``baseline="hnsw"``): per step, the inserts then the
    deletes, and every ``eval_every``-th step a Recall@k evaluation over
    the runbook's queries (booked into ``index.eval_counters``).

    ``segmented=True`` replays each eval window (step 0 alone, then
    ``eval_every`` steps) as kind-major ops through
    ``index.apply_segments(max_t=segment_t, sequential=True)``: evals fall
    at the per-op path's steps and see the same applied prefix.  Fresh's
    Alg 4 then lands on segment boundaries, and unknown delete ids are
    silent no-ops rather than exceptions.  It needs
    ``batch_updates=False`` (the batched shell's serial bootstrap has no
    segment form) and refuses the hnsw baseline."""
    if baseline is not None:
        if baseline != "hnsw":
            raise ValueError(f"unknown baseline {baseline!r}")
        from .hnsw import HNSWIndex

        if not isinstance(index, HNSWIndex):
            raise TypeError(
                "baseline='hnsw' expects an HNSWIndex, got "
                f"{type(index).__name__}"
            )
        if segmented:
            raise ValueError(
                "the hnsw baseline is host-orchestrated per op: segmented "
                "replay is not supported"
            )
    if segmented and index.batch_updates:
        raise ValueError(
            "segmented replay requires batch_updates=False: the batched "
            "shell's serial-bootstrap windowing is per-op only"
        )
    metrics: List[StepMetrics] = []
    steps = rb.steps[:max_steps] if max_steps else rb.steps

    def eval_at(t: int) -> None:
        if index.n_active <= k:
            return
        t0 = time.perf_counter()
        comps0 = index.eval_counters.search_comps
        r = index.recall(rb.queries, k=k)
        dt = time.perf_counter() - t0
        dcomps = index.eval_counters.search_comps - comps0
        metrics.append(StepMetrics(
            step=t, n_active=index.n_active, recall=r,
            comps_per_query=dcomps / len(rb.queries),
            qps=len(rb.queries) / max(dt, 1e-9),
        ))
        if verbose:
            m = metrics[-1]
            print(f"[{rb.name}:{index.mode}] step {t:4d} "
                  f"active={m.n_active:6d} recall@{k}={m.recall:.3f} "
                  f"comps/q={m.comps_per_query:.0f}")

    if segmented:
        t = 0
        while t < len(steps):
            window = steps[t:t + (1 if t == 0 else eval_every)]
            batches, splits = runbook_update_stream(rb, window,
                                                    device=index.device)
            index.apply_segments(batches, splits=splits, max_t=segment_t,
                                 sequential=True)
            t_last = t + len(window) - 1
            if t_last % eval_every == 0:
                eval_at(t_last)
            t += len(window)
    else:
        for t, step in enumerate(steps):
            if len(step.insert_ids):
                index.insert(step.insert_ids, rb.data[step.insert_ids])
            if len(step.delete_ids):
                index.delete(step.delete_ids)
            if t % eval_every == 0:
                eval_at(t)
    evald = [m for m in metrics if m.step >= rb.eval_from]
    avg = float(np.mean([m.recall for m in evald])) if evald else float("nan")
    return RunbookReport(
        name=rb.name, mode=index.mode, steps=metrics,
        counters=index.counters, avg_recall=avg,
        eval_counters=index.eval_counters,
    )


__all__ = ["RunbookReport", "StepMetrics", "run_runbook"]
