"""Admission queue + deadline-driven dynamic batcher
(``repro/serving/batcher.py``).

The serving front door admits queries one at a time (open-loop arrivals),
but the search engine wants power-of-two lane batches: the batched search
pads every batch to ``core/search_batched.py::next_bucket``, and wide
batches amortize the hop loop's fixed host cost and each kernel launch
across lanes.  The ``DynamicBatcher`` bridges the two:

  * **dispatch at bucket-full**: the moment ``max_bucket`` requests are
    pending, a full batch leaves at once;
  * **dispatch at deadline**: a request never waits longer than
    ``deadline_s`` in the queue: when the OLDEST pending request's
    deadline expires, whatever is queued dispatches as a partial batch,
    padded up to the next power-of-two bucket (never wider than
    ``max_bucket``).

The batcher is a deterministic state machine: it never reads a clock.
Every method takes ``now`` explicitly, so a fixed arrival trace replayed
through a fresh batcher gives identical dispatch groups, and the
reference's batcher gives the same groups for the same trace.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np

from ..core.search_batched import next_bucket


@dataclasses.dataclass
class QueryRequest:
    """One admitted query and its lifecycle timestamps (all in the
    caller's clock; ``-1.0`` = not reached yet)."""

    req_id: int
    vector: np.ndarray          # f32[dim]
    k: int
    arrival_t: float            # admission time
    deadline_t: float           # arrival_t + the batcher's deadline budget
    dispatch_t: float = -1.0    # when the batch it rode was formed
    complete_t: float = -1.0    # when its results were ready
    snapshot_seq: int = -1      # publication seq the search ran against
    ext_ids: Optional[np.ndarray] = None   # i32[k] answer
    dists: Optional[np.ndarray] = None     # f32[k] answer

    @property
    def wait_s(self) -> float:
        return self.dispatch_t - self.arrival_t

    @property
    def latency_s(self) -> float:
        return self.complete_t - self.arrival_t


@dataclasses.dataclass(frozen=True)
class Dispatch:
    """One batch leaving the admission queue."""

    requests: tuple             # tuple[QueryRequest, ...] in admission order
    bucket: int                 # padded lane width (power of two)
    formed_t: float             # the ``now`` the batch was taken
    reason: str                 # "full" | "deadline" | "drain"

    @property
    def fill(self) -> float:
        """Real lanes over padded lanes: the batch-fill ratio."""
        return len(self.requests) / self.bucket


class DynamicBatcher:
    """Deadline-driven admission queue over power-of-two dispatch buckets.

    ``max_bucket`` must be a power of two (the widest, and the target,
    dispatch width); ``deadline_s`` is the per-request admission budget.
    Every method is a pure function of the call sequence and its explicit
    ``now``: no clock, no randomness.
    """

    def __init__(self, *, deadline_s: float = 0.005, max_bucket: int = 64):
        if max_bucket < 1 or next_bucket(max_bucket) != max_bucket:
            raise ValueError(
                f"max_bucket must be a power of two, got {max_bucket}"
            )
        if deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.max_bucket = int(max_bucket)
        self._pending: deque[QueryRequest] = deque()
        self._next_id = 0

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, vector, now: float, *, k: int = 10) -> QueryRequest:
        """Admit one query at time ``now``; returns its request handle
        (results land on it when the batch it rides completes)."""
        req = QueryRequest(
            req_id=self._next_id,
            vector=np.asarray(vector, np.float32),
            k=int(k),
            arrival_t=float(now),
            deadline_t=float(now) + self.deadline_s,
        )
        self._next_id += 1
        self._pending.append(req)
        return req

    def next_deadline(self) -> Optional[float]:
        """The earliest time a pending request forces a partial dispatch
        (None when the queue is empty)."""
        return self._pending[0].deadline_t if self._pending else None

    def ready(self, now: float) -> bool:
        """True when a dispatch is due at ``now``: a full bucket is
        pending, or the oldest pending request's deadline has expired."""
        if len(self._pending) >= self.max_bucket:
            return True
        return bool(self._pending) and now >= self._pending[0].deadline_t

    def take(self, now: float, *, force: bool = False) -> Optional[Dispatch]:
        """Form the next due batch (oldest first), or None if nothing is
        due.  ``force=True`` flushes regardless of deadlines (drain)."""
        if not self._pending:
            return None
        full = len(self._pending) >= self.max_bucket
        if not full and not force and now < self._pending[0].deadline_t:
            return None
        n = min(len(self._pending), self.max_bucket)
        reqs = tuple(self._pending.popleft() for _ in range(n))
        return Dispatch(
            requests=reqs,
            bucket=min(next_bucket(n), self.max_bucket),
            formed_t=float(now),
            reason="full" if full else ("drain" if force else "deadline"),
        )

    def drain(self, now: float) -> List[Dispatch]:
        """Flush every pending request into final batches (shutdown)."""
        out = []
        while self._pending:
            out.append(self.take(now, force=True))
        return out


def group_vectors(dispatch: Dispatch, dim: int) -> np.ndarray:
    """Stack a dispatch's query vectors into the padded (bucket, dim) lane
    array its bucket expects (pad lanes are zero queries, sliced off after
    the search)."""
    q = np.zeros((dispatch.bucket, dim), np.float32)
    for i, r in enumerate(dispatch.requests):
        q[i] = r.vector
    return q


__all__ = [
    "Dispatch",
    "DynamicBatcher",
    "QueryRequest",
    "group_vectors",
]
