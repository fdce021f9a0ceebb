"""How ``correct`` is decided: the answers of the timed path against the
plain reference (``bench/reference/exact.py``).

Every number is printed beside its limit:

- ``bad_ids``: over every answer of the run, returned ids that were not live
  when the batch was submitted (deleted, never inserted, or missing), or
  that repeat within one answer.  Exact: limit 0.
- ``insert_found``: over every answer that carries fresh rows (the vectors
  of the last insert), the share whose own id came back among its k ids.
  Limit: the configuration's recall floor.
- ``recall_at_<k>``: over the sampled batches (drawn from the seed), the
  share of the exact k nearest live points, as the reference finds them in
  float32, that came back, on every row but the deleted vectors'.  Limit:
  the configuration's recall floor.
- ``repair_recall_at_<k>``: the same over the rows that are the vectors of
  the last delete, whose exact neighbours are the points that delete repair
  rewired.  Limit: the configuration's recall floor.
- ``dist_gap``: over the sampled batches, the largest gap between a reported
  distance and the reference's float64 distance of that query to that id,
  over the size of the terms the distance is made of (``||q||^2 + ||x||^2``
  for l2, ``||q|| ||x||`` for ip).  Limit: set between the program's
  readings and the control's (``PERF.md``).
"""
from __future__ import annotations

import numpy as np
import torch

from .loop import probe_ids
from .reference.exact import (LiveSet, distance_scale64, exact_topk,
                              pair_distances64)


def replay(updates, n_rows: int, n_start: int) -> LiveSet:
    live = LiveSet(n_rows, n_start)
    for u in updates:
        live.apply(u.inserted, u.deleted)
    return live


def batch_queries(inputs, answer) -> torch.Tensor:
    """The queries of one answered batch, as the loop built them."""
    q = inputs.queries[answer.pool]
    ids = probe_ids(answer.fresh, answer.gone)
    if ids is None:
        return q
    q = q.clone()
    q[:len(ids)] = inputs.table[torch.as_tensor(ids, device=q.device)]
    return q


def sample_batches(n: int, count: int, seed: int) -> list:
    """Indices of the batches the reference recomputes, drawn from the
    seed."""
    rng = np.random.default_rng([int(seed), 17])
    return sorted(rng.choice(n, size=min(n, count), replace=False).tolist())


def bad_id_count(answers, live: LiveSet) -> int:
    bad = 0
    for a in answers:
        ids = np.asarray(a.ext, np.int64)
        srt = np.sort(ids, axis=1)
        dup = int((srt[:, 1:] == srt[:, :-1]).sum())
        bad += int((~live.is_live(ids, a.t)).sum()) + dup
    return bad


def insert_found(answers):
    found, total = 0, 0
    for a in answers:
        if a.fresh is None:
            continue
        f = len(a.fresh)
        found += int((np.asarray(a.ext[:f]) == a.fresh[:, None]).any(1).sum())
        total += f
    return found / total if total else None


def compare_sampled(answers, picks, inputs, live: LiveSet, metric: str,
                    k: int) -> tuple:
    """``(recall, repair_recall, dist_gap)`` of the sampled answers against
    the reference; ``repair_recall`` is None where no sampled batch has a
    deleted vector's row."""
    hits = [0, 0]     # [other rows, deleted vectors' rows]
    slots = [0, 0]
    gap = 0.0
    for i in picks:
        a = answers[i]
        q = batch_queries(inputs, a)
        mask = torch.as_tensor(live.live_at(a.t), device=q.device)
        true_ids, _ = exact_topk(q, inputs.table, mask, k, metric)
        true_ids = true_ids.cpu().numpy()
        got = np.asarray(a.ext, np.int64)
        g0 = 0 if a.fresh is None else len(a.fresh)
        g1 = g0 + (0 if a.gone is None else len(a.gone))
        for row, (g, t) in enumerate(zip(got, true_ids)):
            kind = int(g0 <= row < g1)
            tset = set(int(x) for x in t if x >= 0)
            hits[kind] += len(tset.intersection(int(x) for x in g if x >= 0))
            slots[kind] += len(tset)
        ok = (got >= 0) & (got < inputs.n_rows)
        ids = torch.as_tensor(np.where(ok, got, 0), device=q.device)
        rows = inputs.table[ids]
        ref = pair_distances64(q, rows, metric)
        scale = distance_scale64(q, rows, metric)
        rep = torch.as_tensor(np.asarray(a.dists, np.float64),
                              device=q.device)
        g = (rep - ref).abs() / scale
        g = torch.where(torch.isfinite(g), g, torch.full_like(g, np.inf))
        okt = torch.as_tensor(ok, device=q.device)
        if okt.any():
            gap = max(gap, float(g[okt].max()))
    recall = hits[0] / slots[0] if slots[0] else 0.0
    repair = hits[1] / slots[1] if slots[1] else None
    return recall, repair, gap


def judge(answers, updates, inputs, config: dict, traffic: dict,
          seed: int) -> tuple:
    """``(checks, correct)``: checks maps a short name to ``{"value",
    "limit", "holds"}`` ("holds" is ``<=`` or ``>=``)."""
    k = int(traffic["k"])
    limits = config["checks"]
    live = replay(updates, inputs.n_rows, inputs.n_start)
    checks = {}

    def put(name, value, limit, holds):
        checks[name] = {"value": value, "limit": limit, "holds": holds}

    put("bad_ids", bad_id_count(answers, live), 0, "<=")
    found = insert_found(answers)
    if found is not None:
        put("insert_found", found, limits["recall_min"], ">=")
    picks = sample_batches(len(answers), int(traffic["sample_batches"]), seed)
    recall, repair, gap = compare_sampled(answers, picks, inputs, live,
                                          config["metric"], k)
    put(f"recall_at_{k}", recall, limits["recall_min"], ">=")
    if repair is not None:
        put(f"repair_recall_at_{k}", repair, limits["recall_min"], ">=")
    put("dist_gap", gap, limits["dist_gap_max"], "<=")
    correct = bool(answers) and all(
        (c["value"] <= c["limit"]) if c["holds"] == "<="
        else (c["value"] >= c["limit"]) for c in checks.values())
    return checks, correct
