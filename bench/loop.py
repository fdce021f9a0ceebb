"""The one general traffic generator: a closed loop over a traffic file's
cycle of operations, against a ``StreamingIndex``.

A traffic file (``bench/traffic/<name>.json``) holds only parameters:

- ``cycle``: the operations of one turn of the loop, in order; each is
  ``{"op": "insert", "count": i}`` (one ``StreamingIndex.insert`` of the next
  ``i`` points of the insert pool), ``{"op": "delete", "count": j}`` (one
  ``delete`` of the ``j`` oldest live ids: with inserts, a sliding window) or
  ``{"op": "query", "repeat": n}`` (``n`` query batches, one after the
  other);
- ``query_batch``, ``k``, ``l``: the shape of one ``StreamingIndex.search``;
- ``fresh_queries``: how many rows of each query batch are the vectors of
  the last insert (a user reading what was just written: its own id has to
  come back); ``deleted_queries``: how many rows next are the vectors of the
  last delete (their neighbours are the points that delete repair rewired,
  and the deleted id must not come back); the other rows are held-out
  queries;
- ``query_pool_batches``: distinct held-out query batches drawn from the
  seed, used in turn; ``max_update_steps``: cycles' worth of inserts in the
  insert pool;
- ``sample_batches``: query batches whose answers the reference recomputes.

Each client call waits for the previous one (one client, closed loop), so
a call's latency is its own service time, from its submission to its answers
on the host.  The loop logs every insert and delete for the reference's
replay and every answer for the judge.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Answer:
    """One query batch: submitted after ``t`` update steps."""

    t: int
    pool: int
    fresh: Optional[np.ndarray]   # ids whose vectors are the first rows
    gone: Optional[np.ndarray]    # deleted ids whose vectors follow them
    ext: np.ndarray               # (B, k) external ids returned
    dists: np.ndarray             # (B, k) reported distances
    seconds: float


@dataclasses.dataclass
class Update:
    """One update step (an insert or a delete call)."""

    inserted: np.ndarray
    deleted: np.ndarray
    seconds: float


def expand_cycle(traffic: dict) -> list:
    ops = []
    for op in traffic["cycle"]:
        if op["op"] in ("insert", "delete"):
            ops.append((op["op"], int(op["count"])))
        elif op["op"] == "query":
            ops.extend([("query",)] * int(op["repeat"]))
        else:
            raise ValueError(f"unknown traffic op {op['op']!r}")
    return ops


def probe_ids(fresh, gone) -> Optional[np.ndarray]:
    """The ids whose vectors fill the first rows of a query batch: the
    ``fresh`` ids, then the ``gone`` ids; the held-out queries follow.  None
    when there are none."""
    probes = [np.asarray(ids, np.int64) for ids in (fresh, gone)
              if ids is not None and len(ids)]
    return np.concatenate(probes) if probes else None


class ClosedLoop:
    """Drives one index with one traffic file."""

    def __init__(self, idx, table: torch.Tensor, n_start: int,
                 queries: torch.Tensor, traffic: dict, observer=None):
        self.idx = idx
        self.ops = expand_cycle(traffic)
        self.k = int(traffic["k"])
        self.l = int(traffic["l"])
        self.n_fresh = int(traffic.get("fresh_queries", 0))
        self.n_gone = int(traffic.get("deleted_queries", 0))
        self.table = table
        self.n_rows = table.shape[0]
        self.queries = queries.cpu().numpy()
        self.observer = observer
        self.answers: List[Answer] = []
        self.updates: List[Update] = []
        self.last_insert = None
        self.last_delete = None
        self.next_insert = n_start
        self.next_delete = 0
        self.op_i = 0
        self.q_i = 0
        self.phase = "warmup"

    # -- operations ----------------------------------------------------------

    def _timed(self, call) -> float:
        t0 = time.perf_counter()
        call()
        if self.idx.device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    def insert(self, n: int) -> None:
        ins = np.arange(self.next_insert, self.next_insert + n)
        if ins[-1] >= self.n_rows:
            raise RuntimeError("the traffic's insert pool is used up")
        vecs = self.table[self.next_insert:self.next_insert + n].cpu().numpy()
        dt = self._timed(lambda: self.idx.insert(ins, vecs))
        self.next_insert += n
        self.last_insert = ins
        self.updates.append(Update(ins, ins[:0], dt))

    def delete(self, n: int) -> None:
        dels = np.arange(self.next_delete, self.next_delete + n)
        dt = self._timed(lambda: self.idx.delete(dels))
        self.next_delete += n
        self.last_delete = dels
        self.updates.append(Update(dels[:0], dels, dt))

    def query(self) -> None:
        pool = self.q_i % len(self.queries)
        fresh = gone = None
        if self.n_fresh and self.last_insert is not None:
            fresh = self.last_insert[:self.n_fresh]
        if self.n_gone and self.last_delete is not None:
            gone = self.last_delete[:self.n_gone]
        q = self.queries[pool]
        ids = probe_ids(fresh, gone)
        if ids is not None:
            q = q.copy()
            q[:len(ids)] = self.table[torch.as_tensor(
                ids, device=self.table.device)].cpu().numpy()
        t0 = time.perf_counter()
        ext, dists, _ = self.idx.search(q, self.k, self.l)
        dt = time.perf_counter() - t0
        self.q_i += 1
        self.answers.append(Answer(len(self.updates), pool, fresh, gone, ext,
                                   dists, dt))

    def step(self) -> None:
        op = self.ops[self.op_i % len(self.ops)]
        self.op_i += 1
        with self._observed(op[0]):
            if op[0] == "insert":
                self.insert(op[1])
            elif op[0] == "delete":
                self.delete(op[1])
            else:
                self.query()

    def _observed(self, kind: str):
        """The traced run's span (and counters) around one operation."""
        if self.observer is None:
            return contextlib.nullcontext()
        if kind == "query":
            return self.observer.query_span(self.phase)
        return self.observer.span(f"bench.{kind}")

    # -- phases --------------------------------------------------------------

    def warmup(self) -> None:
        """Run each kind of operation of the cycle once (they enter the
        stream like any other): every shape the window uses is then built
        and cached."""
        kinds = []
        for op in self.ops:
            if op[0] not in kinds:
                kinds.append(op[0])
        for kind in kinds:
            while self.ops[self.op_i % len(self.ops)][0] != kind:
                self.op_i += 1
            self.step()
        self.op_i = 0

    def run(self, seconds: float, phase: str = "window") -> tuple:
        """Turn the loop in whole cycles until ``seconds`` have passed: the
        cycle in flight then completes, so every window holds whole cycles
        of the traffic.  Returns ``(start, end)`` perf-counter times."""
        self.phase = phase
        self.op_i = 0
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end or self.op_i % len(self.ops):
            self.step()
        return t0, time.perf_counter()


