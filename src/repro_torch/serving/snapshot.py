"""Snapshot-isolated read states: a double-buffered, sequence-numbered swap
(``repro/serving/snapshot.py``).

The port's update front door (``core/api.py::apply``) rewrites the
writer's tensors IN PLACE, so a reader that searched the writer's live
handle would either wait behind every update or read a torn state.  The
``SnapshotStore`` decouples the two sides:

  * the WRITER owns the live handle and keeps updating it in place;
  * after a batch of updates it PUBLISHES: ``core.api.take_snapshot``
    clones the live state into the currently INACTIVE read slot, the
    active-slot pointer flips, and the publication sequence number bumps;
  * READERS ``acquire()`` the active slot (a ``SnapshotHandle`` with its
    seq) and ``release()`` it when their search completes.  Publish only
    writes the inactive slot, so a reader holding snapshot N keeps stable
    tensors while the writer runs ahead; it may overlap at most ONE
    publish, and the store refuses loudly to publish over a slot that
    still has readers.

Visibility: a search against snapshot N observes exactly the updates
applied before publish N and nothing after (isolation); after publish
N+1 a fresh ``acquire`` observes all of them (read-your-writes).
"""
from __future__ import annotations

from typing import Callable, Optional

from ..core.api import SnapshotHandle, take_snapshot


class SnapshotStore:
    """Double-buffered published read states for one writer.

    ``state0`` seeds the first published snapshot (seq 0).  ``clone``
    overrides the deep copy made at publish time (``take_snapshot`` by
    default); ``StreamingEngine.clone`` passes one that waits for the
    card.
    """

    def __init__(self, state0, *, clone: Optional[Callable] = None):
        self._clone = clone or (lambda st, seq: take_snapshot(st, seq))
        self._slots: list = [self._clone(state0, 0), None]
        self._active = 0
        self._inflight = [0, 0]     # acquired-and-unreleased readers per slot
        self.n_publishes = 0
        self.n_acquires = 0

    @property
    def seq(self) -> int:
        """Sequence number of the currently published snapshot."""
        return self._slots[self._active].seq

    @property
    def active_slot(self) -> int:
        """Which of the two buffers is published."""
        return self._active

    def acquire(self) -> SnapshotHandle:
        """The current published snapshot.  Pair with ``release`` when the
        read completes; a handle may be held across at most one publish."""
        self._inflight[self._active] += 1
        self.n_acquires += 1
        return self._slots[self._active]

    def release(self, handle: SnapshotHandle) -> None:
        """Return a handle obtained from ``acquire``."""
        for slot in (0, 1):
            snap = self._slots[slot]
            if snap is not None and snap.seq == handle.seq:
                if self._inflight[slot] <= 0:
                    raise RuntimeError(
                        f"release of snapshot seq={handle.seq} with no "
                        f"reader in flight"
                    )
                self._inflight[slot] -= 1
                return
        raise RuntimeError(
            f"release of snapshot seq={handle.seq}, which is no longer "
            f"buffered (held across two publishes?)"
        )

    def publish(self, state) -> SnapshotHandle:
        """Clone ``state`` into the inactive slot, flip, bump seq.

        Readers still holding the previous snapshot are unaffected (their
        slot is not touched); readers two publishes behind would have
        their tensors overwritten, so the store refuses to publish over a
        slot with readers in flight."""
        target = 1 - self._active
        if self._inflight[target]:
            raise RuntimeError(
                f"publish would overwrite snapshot "
                f"seq={self._slots[target].seq} with "
                f"{self._inflight[target]} reader(s) still in flight "
                f"(a snapshot may be held across at most one publish)"
            )
        seq = self.seq + 1
        # the slot has no reader: free its tensors before the clone, so the
        # device holds the live state and two snapshots, never three
        self._slots[target] = None
        snap = self._clone(state, seq)
        self._slots[target] = snap
        self._active = target
        self.n_publishes += 1
        return snap


__all__ = ["SnapshotStore"]
