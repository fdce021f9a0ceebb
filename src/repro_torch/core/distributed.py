"""Sharded streaming index (``repro/core/distributed.py``): the single-node
system over L logical rows laid out on a list of devices.

The unit of data ownership is a LOGICAL shard: external ids hash into
``n_logical`` = L rows (``route``: the reference's int64 hash, so a point
lands on the same row in both packages), and each row is a full
``IndexState`` handle run by the single-shard functions unchanged
(``apply``, ``device_sweep``, ``segment_scan``, ``batched_greedy_search``),
one row after another: the reference's per-row "Python loop, NOT vmap".
``devices`` plays the reference's mesh: S entries (repeats allowed, so S
"devices" may be one card), row ``l`` on ``devices[l // G]`` with G = L/S.
Every per-row computation is independent of the layout, so any S that
divides L gives bit-identical states and answers, and a checkpoint (which
records L) restores onto any such layout (elastic reshard).

One controller drives every device (no ``torch.distributed``): routing,
owner packing and the merges run on the host, as in the reference, whose
one Python process drives ``shard_map``.  The live state is a LIST of L
per-row handles, not one stacked tensor: ``apply`` updates a row's tensors
in place and may replace a leaf, which a view into a stacked leaf would not
follow.  ``states`` stacks the rows on request (tests, reference-shaped
readers); no per-op path uses it.

  * updates (``routing="compact"``, the default): the host packs each
    row's owned lanes into a power-of-two sub-batch
    (``core/api.py::compact_owner_batch`` / ``compact_owner_segment``), so
    each row applies ~B/L lanes; ``routing="replicate"`` runs every row
    over all B lanes with the non-owned ones masked, equal leaf for leaf;
  * search: replicate-and-merge (every row answers the whole batch; the
    (Q, L*k) candidates, in (row, k) order, are merged with a stable sort,
    ties to the lower flat index as ``lax.top_k``), or
    ``partition="queries"``: S equal power-of-two sub-batches start one per
    device and rotate S times, each device running its G rows with
    ``merge_topk`` after every row, the carry moved to the next device;
  * consolidation: ip and local sweep per op inside each row; fresh's
    host pass runs at segment boundaries on the rows whose
    ``needs_consolidation`` fired (``consolidate_sharded``).

The reference's ``TRACE_COUNTER`` / ``TRACE_SHAPES`` count JAX traces of
its SPMD programs; eager PyTorch has none, so only the host-side
``segment_pack`` entry (owner packs of stream steps) has a counterpart.
Per-row results move to ``devices[0]`` for the merges; host reads
synchronise the row's own device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..checkpoint.manager import CheckpointMismatchError, restore_onto
from .api import (_batch_to, _compact_owner_batch_np, _np,
                  _np_update_batch, apply, clone_state, delete_batch,
                  device_sweep, get_policy, insert_batch, plan_segments,
                  segment_scan)
from .backend import BIG
from .grow import HIGH_WATER, grow_index, next_capacity
from .persist import _numpy_tree, restore_index, save_index
from .search_batched import batched_greedy_search, merge_topk, next_bucket
from .types import (INVALID, KIND_INSERT, ANNConfig, IndexState,
                    SegmentResult, UpdateBatch, clip_ids, init_index_state,
                    noop_update_batch, resolve_device, stack_states,
                    unstack_state)

# host-side owner packs of individual stream steps: ``update_stream``
# packs every step exactly once, at plan time (TRACE_SHAPES records each
# pack's (L, Bc) shape)
TRACE_COUNTER = {"segment_pack": 0}
TRACE_SHAPES: dict = {k: [] for k in TRACE_COUNTER}


def as_int_payload(ids, device=None) -> torch.Tensor:
    """Lossless int32 payload for slot / external ids, on ``device``
    (default: the card); ids outside int32 raise ``OverflowError`` instead
    of wrapping (a float32 payload would round them above 2**24)."""
    arr = np.asarray(ids, np.int64)
    if arr.size and (arr.max() >= 2**31 or arr.min() < -(2**31)):
        raise OverflowError("id payload exceeds int32 range")
    return torch.from_numpy(arr.astype(np.int32)).to(resolve_device(device))


class ShardedIndex:
    """L logical rows of the unified ``apply`` op stream (external-id
    semantics per row) over S devices.

    ``devices``: a sequence of ``torch.device`` (repeats allowed; default
    ``[resolve_device(None)]``, the card).  ``routing``: ``"compact"``
    ships each row only its owned lanes, ``"replicate"`` ships every row
    the whole batch with non-owned lanes masked.  ``sequential``: the
    per-row serial lane loop (each lane sees every earlier write of its
    row) or, False, the relaxed-visibility batched phases.
    ``n_logical``: the routing modulus L (default S), a multiple of S,
    fixed at creation and recorded in checkpoints."""

    def __init__(self, cfg: ANNConfig, devices=None, *, policy: str = "ip",
                 max_external_id: Optional[int] = None,
                 routing: str = "compact", sequential: bool = True,
                 n_logical: Optional[int] = None, auto_grow: bool = True):
        self._configure(cfg, devices, policy, max_external_id, routing,
                        sequential, n_logical, auto_grow)
        self.rows = [init_index_state(cfg, self.max_external_id,
                                      device=self.row_device(i))
                     for i in range(self.n_logical)]

    def _configure(self, cfg, devices, policy, max_external_id, routing,
                   sequential, n_logical, auto_grow):
        if routing not in ("compact", "replicate"):
            raise ValueError(f"unknown routing {routing!r}")
        self.cfg = cfg
        self.policy = policy
        self.routing = routing
        self.sequential = sequential
        self.auto_grow = auto_grow
        self.devices = [resolve_device(d) for d in
                        (devices if devices is not None else [None])]
        if not self.devices:
            raise ValueError("ShardedIndex needs at least one device")
        self.n_shards = len(self.devices)
        self.n_logical = int(n_logical) if n_logical else self.n_shards
        if self.n_logical % self.n_shards:
            raise ValueError(
                f"n_logical={self.n_logical} must be a multiple of the "
                f"device count {self.n_shards} (each device holds "
                f"G = n_logical/n_shards whole logical rows)"
            )
        self.rows_per_shard = self.n_logical // self.n_shards
        if max_external_id is None:
            max_external_id = cfg.n_cap * 4
        self.max_external_id = max_external_id

    def row_device(self, row: int) -> torch.device:
        """The device of logical row ``row``."""
        return self.devices[row // self.rows_per_shard]

    @property
    def states(self) -> IndexState:
        """The rows stacked to one (L, ...) ``IndexState`` on
        ``devices[0]`` (a copy: updates do not reach it)."""
        return stack_states(self.rows, self.devices[0])

    @property
    def n_active(self) -> int:
        return sum(int(r.graph.n_active) for r in self.rows)

    def synchronize(self) -> None:
        """Wait for the queued work of every card of the layout."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -- routing and capacity -----------------------------------------------

    def route(self, ext_ids) -> np.ndarray:
        """Owner LOGICAL row of each external id (stable int64 hash, modulus
        ``n_logical``): a reshard never re-routes a point."""
        return (np.asarray(ext_ids, np.int64) * 2654435761 % 2**31
                % self.n_logical).astype(np.int32)

    def _ensure_capacity(self, max_owned: int) -> bool:
        """Grow every row into the next capacity bucket, in lockstep, when
        the fullest row plus ``max_owned`` incoming inserts would cross the
        high-water mark (``core/grow.py``)."""
        if not self.auto_grow:
            return False
        n_cap = self.cfg.n_cap
        free = min(int(r.graph.free_top) for r in self.rows)
        needed = (n_cap - free) + max_owned
        if needed <= HIGH_WATER * n_cap:
            return False
        new_cap = next_capacity(needed, n_cap)
        self.rows = [grow_index(r, self.cfg, new_cap)[0] for r in self.rows]
        self.cfg = dataclasses.replace(self.cfg, n_cap=new_cap)
        return True

    def _owned_insert_demand(self, batches) -> int:
        """Most inserts any one row receives from an update stream (the
        growth trigger's ``incoming``; deletes never consume slots)."""
        counts = np.zeros((self.n_logical,), np.int64)
        for batch in batches:
            ins = _np(batch.valid) & (_np(batch.kind) == KIND_INSERT)
            if ins.any():
                owners = self.route(_np(batch.ext_id))
                counts += np.bincount(owners[ins], minlength=self.n_logical)
        return int(counts.max()) if counts.size else 0

    # -- updates --------------------------------------------------------------

    def _apply_row(self, i: int, batch: UpdateBatch):
        """``apply`` on row ``i``, then the device policy's sweep when its
        trigger fires over the row's counters."""
        pol = get_policy(self.policy)
        row, res = apply(self.rows[i], self.cfg, batch, policy=self.policy,
                         sequential=self.sequential)
        if pol.device_consolidation:
            trig = pol.should_consolidate_device(self.cfg, row.graph)
            row = row._replace(graph=device_sweep(row.graph, self.cfg, pol,
                                                  trig))
        self.rows[i] = row
        return res

    def _apply_update(self, batch: UpdateBatch, owners):
        """Route one bucket-padded ``UpdateBatch`` (numpy or tensors, any
        device) through ``self.routing``.  ``owners``: i32[B] owning row
        per lane (-1 for padding lanes).  Returns per-lane ``(ok, slot)``
        numpy arrays in the caller's lane order."""
        owners = np.asarray(owners, np.int32)
        if self.routing == "compact":
            cb, pos, _ = _compact_owner_batch_np(batch, owners,
                                                 self.n_logical)
            res = [self._apply_row(i, _batch_to(sub, self.row_device(i)))
                   for i, sub in enumerate(unstack_state(cb))]
            ok_c = np.stack([_np(r.ok) for r in res])        # (L, Bc)
            slot_c = np.stack([_np(r.slot) for r in res])
            ok = np.zeros(owners.shape, bool)
            slot = np.full(owners.shape, INVALID, np.int32)
            m = pos >= 0
            ok[m] = ok_c[owners[m], pos[m]]
            slot[m] = slot_c[owners[m], pos[m]]
            return ok, slot
        oks, slots = [], []
        for i in range(self.n_logical):
            dev = self.row_device(i)
            mine = _batch_to(batch, dev)
            mine = mine._replace(valid=mine.valid & (
                torch.from_numpy(owners).to(dev) == i))
            res = self._apply_row(i, mine)
            oks.append(_np(res.ok))
            slots.append(_np(res.slot))
        # off-owner lanes are masked no-ops: ok False, slot INVALID
        return np.stack(oks).any(axis=0), np.stack(slots).max(axis=0)

    def _padded_owners(self, owners, b: int) -> np.ndarray:
        return np.concatenate([owners, np.full(b - len(owners), -1)]
                              ).astype(np.int32)

    def insert(self, ext_ids, vectors):
        """Insert by external id; returns ``(slots, owners)`` bookkeeping
        (the slot within the owner row; callers address points by external
        id).  Grows every row first when the fullest would cross the
        high-water mark."""
        ext_ids = np.asarray(ext_ids)
        oob = (ext_ids < 0) | (ext_ids >= self.max_external_id)
        if oob.any():
            raise ValueError(
                f"external id(s) outside [0, {self.max_external_id}): "
                f"{ext_ids[oob][:8].tolist()}"
            )
        owners = self.route(ext_ids)
        if len(ext_ids):
            self._ensure_capacity(int(np.bincount(
                owners, minlength=self.n_logical).max()))
        batch = insert_batch(ext_ids, vectors, device="cpu")
        ok, slot = self._apply_update(
            batch, self._padded_owners(owners, batch.kind.shape[0]))
        ok = ok[: len(ext_ids)]
        if not ok.all():
            raise RuntimeError(
                f"insert failed on owning shard (capacity exhausted) for "
                f"external id(s) {ext_ids[~ok][:8].tolist()}"
            )
        return slot[: len(ext_ids)], owners

    def delete(self, ext_ids) -> None:
        """Delete by external id, routed to the owning row.  Duplicates
        within one call delete once; unknown ids raise ``KeyError`` after
        the known ids of the batch have been applied."""
        ext_ids = np.asarray(ext_ids)
        _, keep = np.unique(ext_ids, return_index=True)
        ext_ids = ext_ids[np.sort(keep)]
        owners = self.route(ext_ids)
        batch = delete_batch(ext_ids, self.cfg.dim, device="cpu")
        ok, _ = self._apply_update(
            batch, self._padded_owners(owners, batch.kind.shape[0]))
        ok = ok[: len(ext_ids)]
        if not ok.all():
            raise KeyError(
                f"delete of unknown external id(s): "
                f"{ext_ids[~ok][:8].tolist()}"
            )

    def delete_slots(self, slots, owners) -> None:
        """Delete by (slot, owner row) pairs (the pre-external-id API): the
        external ids come off the rows' ``slot2ext`` maps and go through
        the int32 ``apply`` stream."""
        slots = as_int_payload(slots, "cpu").numpy()
        owners = np.asarray(owners, np.int64)
        ext = np.array([int(self.rows[o].slot2ext[s])
                        for s, o in zip(slots, owners)], np.int64)
        if (ext < 0).any():
            raise KeyError("delete_slots of unoccupied slot(s)")
        batch = delete_batch(ext, self.cfg.dim, device="cpu")
        self._apply_update(batch,
                           self._padded_owners(owners, batch.kind.shape[0]))

    def _scan_rows(self, row_ops):
        """``segment_scan`` of each row over its (T, B) op tensor; the
        per-row results stacked to (L, T, ...) numpy."""
        pol = get_policy(self.policy)
        res = []
        for i, ops in enumerate(row_ops):
            self.rows[i], r = segment_scan(self.rows[i], self.cfg, ops, pol,
                                           self.sequential, None)
            res.append(_numpy_tree(r))
        return SegmentResult(*(np.stack(col) for col in zip(*res)))

    def update_stream(self, batches, *, max_t: int = 64):
        """Run a stream of ``UpdateBatch``es as segments of up to ``max_t``
        steps (``plan_segments``), each row scanning its own lanes of every
        segment (``segment_scan``).  Returns one ``SegmentResult`` of numpy
        arrays per segment: under compact routing ``slot`` / ``ok`` /
        ``n_comps`` are scattered back to the CALLER's (T, B) lane order,
        under replicate they stay (L, T, B) with off-owner lanes masked;
        ``consolidated`` / ``needs_consolidation`` are (L, T) in both.
        Failed lanes are ``ok=False`` (no per-id exceptions here).

        The whole stream's per-row insert demand is provisioned first (one
        capacity bucket end to end).  Under fresh, every row whose
        ``needs_consolidation`` fired is consolidated at the segment's end
        (``consolidate_sharded``).  Compact routing packs every step
        exactly once, at plan time, and folds its per-row bucket ``bc``
        into the ``plan_segments`` key, so a segment has one (L, T, Bc)
        shape and no step is re-packed per segment."""
        pol = get_policy(self.policy)
        batches = list(batches)
        self._ensure_capacity(self._owned_insert_demand(batches))
        results = []

        def _post(res):
            if not pol.device_consolidation:
                fired = np.nonzero(res.needs_consolidation.any(axis=1))[0]
                self.consolidate_sharded(fired)
            results.append(res)

        if self.routing != "compact":
            for seg in plan_segments(batches, max_t=max_t).segments:
                owners = torch.from_numpy(np.where(
                    _np(seg.ops.valid), self.route(_np(seg.ops.ext_id)), -1
                ).astype(np.int32))                               # (T, B)
                row_ops = []
                for i in range(self.n_logical):
                    dev = self.row_device(i)
                    ops = _batch_to(seg.ops, dev)
                    row_ops.append(ops._replace(
                        valid=ops.valid & (owners.to(dev) == i)))
                _post(self._scan_rows(row_ops))
            return results

        # pack each step once (host, numpy); bc joins the plan key
        packed, positions, owner_rows, bcs = [], [], [], []
        for batch in batches:
            own = np.where(_np(batch.valid), self.route(_np(batch.ext_id)),
                           -1).astype(np.int32)                   # (B,)
            sub, p, bc = _compact_owner_batch_np(batch, own, self.n_logical)
            TRACE_COUNTER["segment_pack"] += 1
            TRACE_SHAPES["segment_pack"].append(tuple(sub.kind.shape))
            packed.append(sub)
            positions.append(p)
            owner_rows.append(own)
            bcs.append(bc)
        plan = plan_segments(batches, max_t=max_t, keys=bcs)
        i = 0
        for seg in plan.segments:
            t_bucket, b = seg.ops.kind.shape
            n = seg.n_ops
            bc = bcs[i]
            dim = packed[i].vector.shape[2]
            steps = packed[i:i + n]
            if t_bucket > n:
                # T padding: packed all-masked no-op steps of width bc
                pad, _, _ = _compact_owner_batch_np(
                    _np_update_batch(noop_update_batch(b, dim, "cpu")),
                    np.full((b,), -1, np.int32), self.n_logical, bucket=bc)
                steps = steps + [pad] * (t_bucket - n)
            cops = UpdateBatch(*(np.stack(arrs, axis=1)
                                 for arrs in zip(*steps)))      # (L, T, bc)
            res = self._scan_rows([
                _batch_to(ops, self.row_device(r))
                for r, ops in enumerate(unstack_state(cops))])
            # per-lane results back to the caller's lane order
            pos = np.full((t_bucket, b), -1, np.int32)
            pos[:n] = np.stack(positions[i:i + n])
            owners = np.full((t_bucket, b), -1, np.int32)
            owners[:n] = np.stack(owner_rows[i:i + n])
            m = pos >= 0
            t_of = np.broadcast_to(np.arange(t_bucket)[:, None], pos.shape)
            ok = np.zeros(pos.shape, bool)
            slot = np.full(pos.shape, INVALID, np.int32)
            comps = np.zeros(pos.shape, res.n_comps.dtype)
            ok[m] = res.ok[owners[m], t_of[m], pos[m]]
            slot[m] = res.slot[owners[m], t_of[m], pos[m]]
            comps[m] = res.n_comps[owners[m], t_of[m], pos[m]]
            _post(res._replace(slot=slot, ok=ok, n_comps=comps))
            i += n
        return results

    def consolidate_sharded(self, shard_ids=None, *, force: bool = False):
        """Run the policy's consolidation pass (fresh: Algorithm 4; ip and
        local: the Algorithm-6 sweep) on the rows ``shard_ids``, in place.
        ``None`` selects every row whose trigger fires over its counters
        (with ``force``: every row with pending removals).  Returns the
        list of rows consolidated."""
        pol = get_policy(self.policy)
        if shard_ids is None:
            counts = [(int(r.graph.n_active), int(r.graph.n_pending))
                      for r in self.rows]
            shard_ids = [i for i, (a, p) in enumerate(counts)
                         if (p > 0 if force
                             else pol.should_consolidate(self.cfg, a, p))]
        shard_ids = [int(s) for s in np.asarray(shard_ids).ravel()]
        for s in shard_ids:
            row = self.rows[s]
            self.rows[s] = row._replace(
                graph=pol.consolidate(row.graph, self.cfg))
        return shard_ids

    # -- durability -----------------------------------------------------------

    def save(self, manager, step: int, *, extra: Optional[dict] = None,
             on_event=None):
        """Checkpoint the rows as one stacked (L, ...) state
        (``core/persist.py::save_index``, the reference's format: the
        manifest records ``n_logical``).  The rows are read to the host
        one by one, so no device holds a stacked copy.  ``routing`` and
        ``sequential`` ride the user extra as the restored defaults."""
        user = {"routing": self.routing, "sequential": self.sequential}
        user.update(extra or {})
        return save_index(
            manager, step, stack_states([_numpy_tree(r) for r in self.rows]),
            self.cfg, policy=self.policy, extra=user, on_event=on_event,
        )

    @classmethod
    def restore(cls, manager, cfg: ANNConfig, devices=None, *,
                step: Optional[int] = None, policy: Optional[str] = None,
                routing: Optional[str] = None,
                sequential: Optional[bool] = None):
        """Restore a ``ShardedIndex`` checkpoint (of either package) onto
        ``devices``, whose length may differ from the writer's (elastic
        reshard) as long as it divides the checkpoint's ``n_logical``:
        every row's program depends on its logical row alone, so the
        restored index answers and updates bit-identically.  Returns
        ``(index, step)``.  ``policy`` / ``routing`` / ``sequential``
        default to the checkpoint's; a given ``policy`` is validated
        (``CheckpointMismatchError``)."""
        step, state, extra = restore_index(manager, cfg, step=step,
                                           policy=policy, device=False)
        meta = extra["index"]
        n_logical = meta["n_logical"]
        if not n_logical:
            raise CheckpointMismatchError(
                "checkpoint holds a single IndexState, not a sharded "
                "stack (restore it with core.persist.restore_index)"
            )
        n_shards = len(devices) if devices is not None else 1
        if n_logical % n_shards:
            raise CheckpointMismatchError(
                f"cannot reshard: checkpoint has {n_logical} logical "
                f"shards, not divisible by the restore layout's "
                f"{n_shards} devices"
            )
        user = extra.get("user", {})
        idx = cls.__new__(cls)
        idx._configure(
            cfg, devices, meta["policy"], meta["max_external_id"],
            routing if routing is not None
            else user.get("routing", "compact"),
            sequential if sequential is not None
            else user.get("sequential", True),
            n_logical, True)
        idx.rows = [restore_onto(row, device=idx.row_device(i))
                    for i, row in enumerate(unstack_state(state))]
        return idx, step

    # -- queries --------------------------------------------------------------

    def search(self, queries, k: int = 10, l: int = 64, *,
               partition: Optional[str] = None):
        """Returns ``(ext_ids (Q, k), owner logical rows (Q, k), dists
        (Q, k), total comps)`` as numpy, ids off the rows' ``slot2ext``.

        ``partition=None`` / ``"replicate"``: every row answers the whole
        batch and the candidates are merged.  ``"queries"``: the batch is
        padded to S equal power-of-two sub-batches that rotate over the S
        devices, each merging its running top-k after every row; both
        return the same top-k."""
        q = np.asarray(queries, np.float32)
        if partition in (None, "replicate"):
            return self.search_state(self.rows, q, k=k, l=l)
        if partition != "queries":
            raise ValueError(f"unknown search partition {partition!r}")
        return self._search_partitioned(q, k, l)

    def _row_result(self, row: IndexState, q, k, l, valid=None):
        """One row's top-k as (external ids, dists, comps)."""
        res = batched_greedy_search(row.graph, self.cfg, q, k=k, l=l,
                                    valid=valid)
        ids = res.topk_ids
        ext = torch.where(ids >= 0,
                          row.slot2ext[clip_ids(ids, self.cfg.n_cap)],
                          torch.full_like(ids, INVALID))
        return ids, ext, res.topk_dists, res.n_comps.sum()

    def _as_rows(self, states):
        if isinstance(states, IndexState):
            return [restore_onto(_numpy_tree(r), device=self.row_device(i))
                    for i, r in enumerate(unstack_state(states))]
        return list(states)

    def search_state(self, states, queries, k: int = 10, l: int = 64):
        """Replicate-and-merge search against EXPLICIT states: a list of L
        row handles laid out like ``rows`` (e.g. ``snapshot_states``) or a
        stacked (L, ...) ``IndexState``.  The snapshot-isolated read path
        of ``ShardedEngine``; ``search`` is this over the live rows."""
        rows = self._as_rows(states)
        home = self.devices[0]
        q_np = np.asarray(queries, np.float32)
        qs = {}
        exts, dists, heres, comps = [], [], [], []
        for i, row in enumerate(rows):
            dev = self.row_device(i)
            if dev not in qs:
                qs[dev] = torch.from_numpy(q_np).to(dev)
            _, ext, d, c = self._row_result(row, qs[dev], k, l)
            exts.append(ext.to(home))
            dists.append(d.to(home))
            heres.append(torch.full_like(ext, i).to(home))
            comps.append(c.to(home))
        # (row, k) flat order, as the reference's all-gather gives for
        # every S; ties go to the lower flat index, as lax.top_k's
        from ..kernels.ref import stable_topk_smallest

        flat_d = torch.cat(dists, dim=1)
        top_d, idx = stable_topk_smallest(flat_d, k)
        gids = torch.gather(torch.cat(exts, dim=1), 1, idx)
        gshard = torch.gather(torch.cat(heres, dim=1), 1, idx)
        return (_np(gids), _np(gshard), _np(top_d),
                int(torch.stack(comps).sum()))

    def _search_partitioned(self, q: np.ndarray, k: int, l: int):
        n_q = q.shape[0]
        s_count, g = self.n_shards, self.rows_per_shard
        per = next_bucket(max(-(-n_q // s_count), 1))
        qpad = np.zeros((per * s_count, q.shape[1]), np.float32)
        qpad[:n_q] = q
        valid = np.zeros((per * s_count,), bool)
        valid[:n_q] = True
        # sub-batch j starts on device j; its carry visits devices j, j+1,
        # ... (mod S), running each device's G rows before moving on
        carry = []
        for j in range(s_count):
            dev = self.devices[j]
            sl = slice(j * per, (j + 1) * per)
            carry.append({
                "q": torch.from_numpy(qpad[sl]).to(dev),
                "v": torch.from_numpy(valid[sl]).to(dev),
                "d": torch.full((per, k), BIG, dtype=torch.float32,
                                device=dev),
                "i": torch.full((per, k), INVALID, dtype=torch.int32,
                                device=dev),
                "s": torch.full((per, k), INVALID, dtype=torch.int32,
                                device=dev),
                "c": torch.zeros((), dtype=torch.int64, device=dev),
            })
        for hop in range(s_count):
            for j in range(s_count):
                c = carry[j]
                at = (j + hop) % s_count
                for r in range(at * g, (at + 1) * g):
                    ids, ext, d, n_c = self._row_result(
                        self.rows[r], c["q"], k, l, valid=c["v"])
                    here = torch.where(ids >= 0, torch.full_like(ids, r),
                                       torch.full_like(ids, INVALID))
                    d = torch.where(ids >= 0, d, torch.full_like(d, BIG))
                    c["d"], (c["i"], c["s"]) = merge_topk(
                        c["d"], d, k, (c["i"], ext), (c["s"], here))
                    c["c"] = c["c"] + n_c
                # rotate the sub-batch and its running merge onward
                nxt = self.devices[(at + 1) % s_count]
                carry[j] = {key: x.to(nxt) for key, x in c.items()}
        home = self.devices[0]
        out = [torch.cat([c[key].to(home) for c in carry])[:n_q]
               for key in ("i", "s", "d")]
        comps = int(sum(int(c["c"]) for c in carry))
        return _np(out[0]), _np(out[1]), _np(out[2]), comps

    # -- serving (snapshot-isolated reads) ------------------------------------

    def snapshot_states(self, states=None) -> list:
        """A deep copy of the rows (default: the live ones), each on its
        own device: safe to search while later updates write the live rows
        in place.  The sharded ``take_snapshot``."""
        rows = self.rows if states is None else self._as_rows(states)
        return [clone_state(r) for r in rows]


__all__ = ["ShardedIndex", "TRACE_COUNTER", "TRACE_SHAPES",
           "as_int_payload"]
