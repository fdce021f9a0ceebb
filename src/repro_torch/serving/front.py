"""The serving front door (``repro/serving/front.py``): admission queue ->
deadline batcher -> snapshot-isolated search, over a live update stream.

Updates are in place (no stop-the-world consolidation) and the read side
runs against published snapshots, so queries never wait on an update:

  * a ``DynamicBatcher`` (batcher.py) coalesces open-loop query arrivals
    into power-of-two buckets under a latency deadline;
  * a ``SnapshotStore`` (snapshot.py) double-buffers sequence-numbered
    read states: the writer keeps updating its live handle in place,
    readers search the last published clone;
  * a ``ServingMetrics`` (metrics.py) books every request's
    enqueue / dispatch / complete timestamps, queue depth, batch fill and
    the per-phase service time.

**Two-lane timeline.**  The front door is single-threaded Python driving
the device, so reader / writer overlap is modelled, not executed: the
READER lane serves search dispatches, the WRITER lane serves updates and
snapshot publishes, and each lane's virtual free time advances by the
MEASURED service time of the real call.  Under snapshot isolation the
lanes are independent: a query dispatched while an update is in flight
starts at once on the reader lane.  ``serialize_updates=True`` collapses
both onto one lane: search queues behind ``apply``, the baseline the
snapshots are measured against.  On the card, work is queued
asynchronously, so the engine synchronises before each timed call returns
(``StreamingEngine.clone`` and ``apply_update``; ``search`` returns host
arrays): each lane is charged its own device time, and an update's device
time never leaks into the next search's measured service time.

Determinism: the front door never reads a clock for its decisions (every
entry point takes ``now``), and batch composition depends only on the
arrival trace and the deadline / bucket knobs.  With a ``service_model``
injected, completion times are deterministic too, so a fixed trace
replays to the reference's dispatch groups, times and answers.

Engines adapt the two index front doors behind one surface:
``StreamingEngine`` (one ``IndexState`` through ``core/api.py``) and
``ShardedEngine`` (the L row handles of a ``ShardedIndex``, searched with
its replicate-and-merge search against a snapshot of every row).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.api import SnapshotHandle, search as search_index, take_snapshot
from ..core.index import _sync
from ..core.search_batched import next_bucket
from ..core.types import UpdateBatch, noop_update_batch
from .batcher import Dispatch, DynamicBatcher, group_vectors
from .metrics import ServingMetrics
from .snapshot import SnapshotStore


class StreamingEngine:
    """Serve adapter over a ``StreamingIndex``: the writer side routes
    ``UpdateBatch``es through the index's in-place ``apply`` (plus the
    policy's consolidation trigger), the read side searches any
    ``IndexState`` snapshot through ``core.api.search`` on the index's
    device."""

    def __init__(self, index):
        self.idx = index
        self.cfg = index.cfg

    @property
    def dim(self) -> int:
        return self.cfg.dim

    @property
    def device(self) -> torch.device:
        return self.idx.device

    def live_state(self):
        return self.idx.istate

    def clone(self, state, seq: int) -> SnapshotHandle:
        snap = take_snapshot(state, seq)
        _sync(self.device)
        return snap

    def apply_update(self, batch: UpdateBatch) -> int:
        """Apply one padded batch to the live (in-place) writer handle;
        returns the number of lanes that applied."""
        res = self.idx._apply(batch, sequential=False)
        self.idx.maybe_consolidate()
        n = int(res.ok.sum())
        _sync(self.device)
        return n

    def search(self, state, queries: np.ndarray, k: int, l: Optional[int]):
        ext, dists, _ = search_index(
            state, self.cfg,
            torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device),
            k=k, l=l or self.cfg.l_search,
        )
        return ext.cpu().numpy(), dists.cpu().numpy()


class ShardedEngine:
    """Serve adapter over a ``ShardedIndex``: updates route to their owner
    rows through the index's compact or replicate update path (the ip and
    local sweeps run inside it), reads run the replicate-and-merge search
    (``ShardedIndex.search_state``) against a SNAPSHOT of the rows.  Like
    ``StreamingEngine`` it synchronises every device of the index before
    ``clone`` and ``apply_update`` return, so each lane is charged its own
    device time."""

    def __init__(self, index):
        self.idx = index
        self.cfg = index.cfg

    @property
    def dim(self) -> int:
        return self.cfg.dim

    @property
    def device(self) -> torch.device:
        return self.idx.devices[0]

    def live_state(self):
        return self.idx.rows

    def clone(self, rows, seq: int) -> SnapshotHandle:
        # every row deep-copied: the live rows are written in place
        snap = SnapshotHandle(seq=int(seq),
                              state=self.idx.snapshot_states(rows))
        self.idx.synchronize()
        return snap

    def apply_update(self, batch: UpdateBatch) -> int:
        """Apply one padded batch to the owner rows; returns the number of
        lanes that applied."""
        valid = batch.valid.cpu().numpy()
        owners = np.where(
            valid, self.idx.route(batch.ext_id.cpu().numpy()), -1
        ).astype(np.int32)
        ok, _ = self.idx._apply_update(batch, owners)
        self.idx.synchronize()
        return int(ok.sum())

    def search(self, rows, queries: np.ndarray, k: int, l: Optional[int]):
        ids, _, dists, _ = self.idx.search_state(
            rows, queries, k=k, l=l or self.cfg.l_search)
        return ids, dists


class ServingFront:
    """Admission queue + dynamic batcher + snapshot swap for one engine.

    Every entry point takes ``now`` (the caller's clock, seconds).
    Wall-clock callers pass ``time.perf_counter()``; the open-loop load and
    the deterministic tests pass virtual event times.

    ``publish_every``: update batches between snapshot publishes (1 =
    read-your-writes after every batch; larger amortizes the clone).
    ``serialize_updates``: collapse the reader / writer lanes into one (the
    no-snapshot baseline where search queues behind updates).
    ``service_model``: optional ``(kind, bucket) -> seconds`` override of
    the TIMELINE accounting ("search" / "update" / "publish"); the real
    calls still run, but completion times become a deterministic function
    of the trace (replay tests).
    """

    def __init__(
        self,
        engine,
        *,
        deadline_s: float = 0.005,
        max_bucket: int = 64,
        k: int = 10,
        l: Optional[int] = None,
        publish_every: int = 1,
        serialize_updates: bool = False,
        service_model: Optional[Callable[[str, int], float]] = None,
        metrics: Optional[ServingMetrics] = None,
    ):
        self.engine = engine
        self.k = int(k)
        self.l = l
        self.publish_every = max(1, int(publish_every))
        self.serialize_updates = bool(serialize_updates)
        self.service_model = service_model
        self.batcher = DynamicBatcher(
            deadline_s=deadline_s, max_bucket=max_bucket
        )
        self.store = SnapshotStore(engine.live_state(), clone=engine.clone)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self._updates: deque = deque()      # (arrival_t, UpdateBatch)
        self._since_publish = 0
        self._reader_free = 0.0
        self._writer_free = 0.0
        self.completed: List[Dispatch] = []

    # -- admission -----------------------------------------------------------

    def submit_query(self, vector, now: float, *, k: Optional[int] = None):
        """Admit one query; returns its ``QueryRequest`` handle (results
        land on it when the batch it rides dispatches)."""
        return self.batcher.submit(vector, now, k=k or self.k)

    def submit_update(self, batch: UpdateBatch, now: float) -> None:
        """Admit one ``UpdateBatch`` (on the engine's device) for the
        writer lane."""
        self._updates.append((float(now), batch))

    def next_event_time(self) -> Optional[float]:
        """When the front door next NEEDS a ``pump`` with no new arrival:
        the oldest pending query's deadline (None if the queue is empty)."""
        return self.batcher.next_deadline()

    # -- the pump ------------------------------------------------------------

    def _service(self, kind: str, bucket: int, measured: float) -> float:
        if self.service_model is not None:
            return float(self.service_model(kind, bucket))
        return measured

    def _lane_start(self, now: float, lane_free: float) -> float:
        return max(float(now), lane_free)

    def _apply_updates(self, now: float) -> None:
        while self._updates and self._updates[0][0] <= now:
            arrival, batch = self._updates.popleft()
            t0 = time.perf_counter()
            n = self.engine.apply_update(batch)
            dt = self._service(
                "update", batch.kind.shape[0], time.perf_counter() - t0
            )
            start = self._lane_start(arrival, self._writer_free)
            self._writer_free = start + dt
            if self.serialize_updates:
                self._reader_free = self._writer_free
            self.metrics.record_update(n, dt)
            self._since_publish += 1
            if self._since_publish >= self.publish_every:
                self.publish(now)

    def publish(self, now: float) -> int:
        """Publish the writer's current state as the next snapshot (the
        clone runs on the writer lane).  Returns the new seq."""
        t0 = time.perf_counter()
        snap = self.store.publish(self.engine.live_state())
        dt = self._service("publish", 0, time.perf_counter() - t0)
        self._writer_free = self._lane_start(now, self._writer_free) + dt
        if self.serialize_updates:
            self._reader_free = self._writer_free
        self.metrics.record_publish(dt)
        self._since_publish = 0
        return snap.seq

    def _run_dispatch(self, d: Dispatch, now: float) -> Dispatch:
        q = group_vectors(d, self.engine.dim)
        snap = self.store.acquire()
        t0 = time.perf_counter()
        ext, dists = self.engine.search(snap.state, q, self.k, self.l)
        measured = time.perf_counter() - t0
        self.store.release(snap)
        dt = self._service("search", d.bucket, measured)
        lane_free = (
            max(self._reader_free, self._writer_free)
            if self.serialize_updates else self._reader_free
        )
        start = self._lane_start(now, lane_free)
        complete = start + dt
        self._reader_free = complete
        if self.serialize_updates:
            self._writer_free = complete
        for i, req in enumerate(d.requests):
            req.dispatch_t = d.formed_t
            req.complete_t = complete
            req.snapshot_seq = snap.seq
            req.ext_ids = ext[i, : req.k]
            req.dists = dists[i, : req.k]
        self.metrics.record_dispatch(d, dt, len(self.batcher))
        self.completed.append(d)
        return d

    def pump(self, now: float) -> List[Dispatch]:
        """Advance the front door to ``now``: apply due updates (writer
        lane, publishing on cadence), then dispatch every due batch
        (reader lane).  Returns the dispatches completed this pump."""
        self._apply_updates(now)
        out = []
        while True:
            d = self.batcher.take(now)
            if d is None:
                break
            out.append(self._run_dispatch(d, now))
        return out

    def drain(self, now: float) -> List[Dispatch]:
        """Flush everything: apply all admitted updates (regardless of
        arrival time) and force-dispatch all pending queries."""
        if self._updates:
            last = self._updates[-1][0]
            self._apply_updates(max(now, last))
        out = []
        for d in self.batcher.drain(now):
            out.append(self._run_dispatch(d, now))
        return out

    # -- warmup --------------------------------------------------------------

    def warmup(self, *, update_buckets=()) -> None:
        """Run every search bucket the batcher can emit (1, 2, 4, ...,
        ``max_bucket``) against the current snapshot, plus a no-op batch
        of each update-lane bucket (on the engine's device), so the first
        dispatches measure steady-state calls rather than first-call costs
        (kernel loading, allocator growth).  No timeline or metrics side
        effects."""
        snap = self.store.acquire()
        b = 1
        while b <= self.batcher.max_bucket:
            self.engine.search(
                snap.state, np.zeros((b, self.engine.dim), np.float32),
                self.k, self.l,
            )
            b *= 2
        self.store.release(snap)
        for ub in update_buckets:
            self.engine.apply_update(
                noop_update_batch(next_bucket(ub), self.engine.dim,
                                  device=self.engine.device)
            )


__all__ = [
    "ServingFront",
    "ShardedEngine",
    "StreamingEngine",
]
