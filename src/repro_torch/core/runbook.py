"""Runbooks (§4): SlidingWindow, ExpirationTime, Clustered — a numpy copy
of ``repro/core/runbook.py`` so that both packages generate bit-identical
data from the same seed.

A runbook is a dataset plus a sequence of steps; each step inserts and/or
deletes dataset points.  Datasets are Gaussian mixtures so that the
Clustered runbook's k-means structure is non-trivial.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class RunbookStep:
    insert_ids: np.ndarray  # external ids into the dataset
    delete_ids: np.ndarray


@dataclasses.dataclass
class Runbook:
    name: str
    data: np.ndarray        # (N, D) float32
    queries: np.ndarray     # (Q, D) float32
    metric: str
    steps: List[RunbookStep]
    eval_from: int = 0      # first step index included in recall averaging

    @property
    def max_active(self) -> int:
        active: set = set()
        best = 0
        for s in self.steps:
            active.update(s.insert_ids.tolist())
            active.difference_update(s.delete_ids.tolist())
            best = max(best, len(active))
        return best


def make_dataset(
    n: int,
    dim: int,
    metric: str = "l2",
    n_queries: int = 128,
    n_clusters: int = 64,
    seed: int = 0,
):
    """Gaussian-mixture dataset + held-out queries from the same mixture."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 1.0, size=(n_clusters, dim)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n + n_queries)
    pts = centers[assign] + 0.35 * rng.normal(
        0.0, 1.0, size=(n + n_queries, dim)
    ).astype(np.float32)
    if metric == "ip":
        # Cohere-style embeddings are ~unit-norm; normalise so inner-product
        # ordering is well behaved for the alpha-prune (see DESIGN.md §2).
        pts /= np.linalg.norm(pts, axis=1, keepdims=True) + 1e-9
    perm = rng.permutation(n + n_queries)
    pts = pts[perm]
    return pts[:n].astype(np.float32), pts[n:].astype(np.float32)


def sliding_window_runbook(
    n: int = 10_000,
    dim: int = 100,
    metric: str = "l2",
    t_max: int = 200,
    seed: int = 0,
    name: str = "SlidingWindow",
) -> Runbook:
    data, queries = make_dataset(n, dim, metric, seed=seed)
    rng = np.random.default_rng(seed + 1)
    order = rng.permutation(n)
    parts = np.array_split(order, t_max)
    half = t_max // 2
    steps = []
    for t in range(t_max):
        dels = parts[t - half] if t >= half else np.array([], np.int64)
        steps.append(RunbookStep(parts[t].astype(np.int64), dels.astype(np.int64)))
    return Runbook(name, data, queries, metric, steps, eval_from=half + 1)


def expiration_time_runbook(
    n: int = 10_000,
    dim: int = 100,
    metric: str = "l2",
    t_max: int = 100,
    seed: int = 0,
    name: str = "ExpirationTime",
) -> Runbook:
    """Lifespans t_max / t_max/2 / t_max/10 with proportions 1:2:10."""
    data, queries = make_dataset(n, dim, metric, seed=seed)
    rng = np.random.default_rng(seed + 1)
    order = rng.permutation(n)
    parts = np.array_split(order, t_max)
    lifespans = np.array([t_max, t_max // 2, max(1, t_max // 10)])
    probs = np.array([1.0, 2.0, 10.0])
    probs /= probs.sum()
    expire: dict = {}
    steps = []
    for t in range(t_max):
        ins = parts[t].astype(np.int64)
        cls = rng.choice(3, size=len(ins), p=probs)
        for pid, c in zip(ins, cls):
            expire.setdefault(t + int(lifespans[c]), []).append(int(pid))
        dels = np.array(sorted(expire.pop(t, [])), np.int64)
        steps.append(RunbookStep(ins, dels))
    return Runbook(name, data, queries, metric, steps, eval_from=t_max // 4)


def _kmeans(data: np.ndarray, k: int, iters: int = 8, seed: int = 0):
    rng = np.random.default_rng(seed)
    centers = data[rng.choice(len(data), size=k, replace=False)].copy()
    assign = np.zeros(len(data), np.int64)
    for _ in range(iters):
        # chunked distance to keep memory bounded
        for lo in range(0, len(data), 65536):
            chunk = data[lo : lo + 65536]
            d = (
                (chunk * chunk).sum(1)[:, None]
                - 2.0 * chunk @ centers.T
                + (centers * centers).sum(1)[None, :]
            )
            assign[lo : lo + 65536] = d.argmin(1)
        for j in range(k):
            m = assign == j
            if m.any():
                centers[j] = data[m].mean(0)
    return assign


def clustered_runbook(
    n: int = 10_000,
    dim: int = 100,
    metric: str = "l2",
    n_clusters: int = 64,
    rounds: int = 5,
    seed: int = 0,
    name: str = "Clustered",
) -> Runbook:
    """NeurIPS'23 style clustered runbook [39]: per-round random proportions
    of each k-means cluster are inserted, then deleted."""
    data, queries = make_dataset(n, dim, metric, n_clusters=n_clusters, seed=seed)
    assign = _kmeans(data, n_clusters, seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    clusters = [np.nonzero(assign == j)[0].astype(np.int64) for j in range(n_clusters)]
    active = [np.array([], np.int64) for _ in range(n_clusters)]
    remaining = [c.copy() for c in clusters]
    steps = []
    for _ in range(rounds):
        for j in range(n_clusters):
            if len(remaining[j]) == 0:
                continue
            frac = rng.uniform(0.2, 0.8)
            take = max(1, int(frac * len(remaining[j])))
            ins = remaining[j][:take]
            remaining[j] = remaining[j][take:]
            active[j] = np.concatenate([active[j], ins])
            steps.append(RunbookStep(ins, np.array([], np.int64)))
        for j in range(n_clusters):
            if len(active[j]) == 0:
                continue
            frac = rng.uniform(0.2, 0.8)
            take = max(1, int(frac * len(active[j])))
            sel = rng.permutation(len(active[j]))[:take]
            dels = active[j][sel]
            keep = np.setdiff1d(np.arange(len(active[j])), sel)
            active[j] = active[j][keep]
            # deleted points may be re-inserted in a later round
            remaining[j] = np.concatenate([remaining[j], dels])
            steps.append(RunbookStep(np.array([], np.int64), dels))
    return Runbook(name, data, queries, metric, steps, eval_from=len(steps) // 5)


def make_runbook(kind: str, **kw) -> Runbook:
    return {
        "sliding_window": sliding_window_runbook,
        "expiration_time": expiration_time_runbook,
        "clustered": clustered_runbook,
    }[kind](**kw)


# ---------------------------------------------------------------------------
# Runbook -> unified op stream (the payload of compiled update segments)
# ---------------------------------------------------------------------------


def step_update_batch(rb: Runbook, step: RunbookStep, device=None):
    """One runbook step as a kind-major ``UpdateBatch``: bucket-padded
    insert lanes first, bucket-padded delete lanes after.  Returns
    ``(batch, split)``."""
    from .api import mixed_update_batch  # api does not import runbook

    ins = np.asarray(step.insert_ids, np.int64)
    dim = rb.data.shape[1]
    return mixed_update_batch(ins, rb.data[ins], step.delete_ids, dim,
                              device=device)


def runbook_update_stream(rb: Runbook, steps: Optional[List[RunbookStep]]
                          = None, device=None):
    """A slice of runbook steps as ``(batches, splits)`` lists."""
    batches, splits = [], []
    for step in (rb.steps if steps is None else steps):
        batch, split = step_update_batch(rb, step, device=device)
        batches.append(batch)
        splits.append(split)
    return batches, splits


def runbook_segment_plan(rb: Runbook,
                         steps: Optional[List[RunbookStep]] = None, *,
                         max_t: int = 64, device=None):
    """A runbook (slice) straight to a ``SegmentPlan``: pure host-side
    planning of op tensors on ``device`` (default: the card), the unit
    ``core.persist.run_segments_supervised`` checkpoints and replays."""
    from .api import plan_segments  # api does not import runbook

    batches, splits = runbook_update_stream(rb, steps, device=device)
    return plan_segments(batches, splits=splits, max_t=max_t)
