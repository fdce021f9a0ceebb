"""The unified op-stream API (``repro/core/api.py``):
``apply(state, cfg, batch)`` for updates, ``search(state, cfg, queries)``
for queries, the ``UpdatePolicy`` registry (``ip``, ``fresh``, ``local``),
the consolidation trigger, and whole-segment update streams
(``apply_segment`` over a (T, B) op tensor, ``plan_segments`` /
``run_segments`` over an arbitrary op stream), ``take_snapshot`` (the
published read states of the serving layer) and the owner-compaction
packers of the sharded index (``compact_owner_batch`` /
``compact_owner_segment``, host numpy).  The reference's
``consolidation_fields`` / ``consolidate_narrow`` only keep the vector
table out of a ``lax.cond``'s operands, and its ``TRACE_COUNTER`` /
``TRACE_UNROLL`` count JAX traces; eager PyTorch has neither, so they have
no counterpart here.

Semantics are the reference's, lane for lane: a mixed batch applies all
insert lanes first (lane order), then all delete lanes (lane order), the
deletes resolving external ids against the post-insert map.
``sequential=True`` runs the serial path (each lane sees every earlier
write); ``sequential=False`` runs the batched phases (searches see the
graph as of the phase's start).

Where the reference DONATES its state, the port updates the handle's
tensors IN PLACE: after ``apply`` the caller's old handle and the returned
one share (mutated) tensors.  ``clone_state`` gives an independent copy.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .batched import insert_many_batched, ip_delete_many_batched
from .consolidate import (consolidation_due, fresh_consolidate,
                          light_consolidate)
from .delete import ip_delete_many, lazy_delete_many, local_delete_many
from .insert import insert_many
from .search import search_batch
from .search_batched import next_bucket
from .types import (
    INVALID,
    KIND_DELETE,
    KIND_INSERT,
    ANNConfig,
    ApplyResult,
    GraphState,
    IndexState,
    SegmentResult,
    UpdateBatch,
    clip_ids,
    noop_update_batch,
    stack_update_batches,
    take_update_lanes,
)


def clone_state(state):
    """A deep copy of a state (``IndexState`` / ``GraphState`` / any tuple
    of tensors)."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    if state is None:
        return None
    return type(state)(*(clone_state(x) for x in state))


class SnapshotHandle(NamedTuple):
    """A sequence-numbered read-only view of an index state.

    ``state`` is a deep copy of the writer's state at publication time
    (``take_snapshot`` clones every tensor leaf: the graph, the int8 tier,
    both id maps and the counters), so the in-place updates that
    ``apply`` makes to the writer's tensors never reach it: a search
    against a snapshot observes exactly the updates applied before it was
    taken.  ``seq`` is the host-side publication sequence number."""

    seq: int
    state: IndexState


def take_snapshot(state, seq: int = 0) -> SnapshotHandle:
    """Clone ``state`` into a ``SnapshotHandle`` tagged ``seq``: the clone
    is the isolation boundary between the writer and the readers.  On the
    card the copies are queued on the current stream; a caller that times
    the clone synchronises first."""
    return SnapshotHandle(seq=int(seq), state=clone_state(state))


# ---------------------------------------------------------------------------
# Update policies
# ---------------------------------------------------------------------------


class UpdatePolicy:
    """Pluggable delete strategy + consolidation trigger, selected by name
    (``@register_policy``)."""

    name = "abstract"
    # True when ``consolidate`` is a device pass the trigger can run right
    # where it fires (ip, local: Algorithm 6); False (fresh) when the pass
    # is host-orchestrated and the host decides when to run it
    device_consolidation = False

    def delete_many(self, graph: GraphState, cfg: ANNConfig, ps, *,
                    sequential: bool):
        """Delete the slots ``ps`` (i32[B], INVALID lanes are no-ops).
        Returns ``(graph, DeleteStats)`` with per-lane ``ok``/``n_comps``."""
        raise NotImplementedError

    def should_consolidate(self, cfg: ANNConfig, n_active: int,
                           n_pending: int) -> bool:
        """Host-side trigger: pending removals exceed the configured
        fraction of the live set."""
        if n_pending == 0:
            return False
        return n_pending > cfg.consolidation_threshold * max(n_active, 1)

    def should_consolidate_device(self, cfg: ANNConfig,
                                  graph: GraphState) -> torch.Tensor:
        """The same trigger as a bool tensor over the state's counters."""
        return consolidation_due(graph, cfg)

    def consolidate(self, graph: GraphState, cfg: ANNConfig) -> GraphState:
        raise NotImplementedError


_POLICIES: dict = {}


def register_policy(name: str):
    def deco(cls):
        cls.name = name
        _POLICIES[name] = cls()
        return cls

    return deco


def available_policies() -> tuple:
    return tuple(sorted(_POLICIES))


def get_policy(name: str) -> UpdatePolicy:
    try:
        return _POLICIES[name]
    except KeyError:
        raise KeyError(
            f"unknown update policy {name!r}; "
            f"available: {available_policies()}"
        ) from None


@register_policy("ip")
class IPDiskANNPolicy(UpdatePolicy):
    """In-place deletes (Alg 5); quarantined slots released by the light
    Alg 6 sweep."""

    device_consolidation = True

    def delete_many(self, graph, cfg, ps, *, sequential):
        fn = ip_delete_many if sequential else ip_delete_many_batched
        return fn(graph, cfg, ps)

    def consolidate(self, graph, cfg):
        return light_consolidate(graph, cfg)


@register_policy("fresh")
class FreshDiskANNPolicy(UpdatePolicy):
    """FreshDiskANN baseline: tombstone deletes, batch consolidation
    (Alg 4) past the threshold, run by the host."""

    def delete_many(self, graph, cfg, ps, *, sequential):
        # a mask flip: one formulation for both visibility modes
        return lazy_delete_many(graph, cfg, ps)

    def consolidate(self, graph, cfg):
        return fresh_consolidate(graph, cfg)


@register_policy("local")
class LocalRepairPolicy(UpdatePolicy):
    """Topology-aware localized repair: exact in-neighbourhood, every
    in-edge removed, a bounded in-neighbour set reconnected through
    ``N_out(p)``, the slot freed at once (``core/delete.py::local_delete``).
    Its deletes leave nothing pending, so the Algorithm-6 sweep only runs
    for a state inherited from another policy."""

    device_consolidation = True

    def delete_many(self, graph, cfg, ps, *, sequential):
        # each lane's exact in-neighbour compare must see the previous
        # lane's repairs: serial in both visibility modes
        return local_delete_many(graph, cfg, ps)

    def consolidate(self, graph, cfg):
        return light_consolidate(graph, cfg)


# ---------------------------------------------------------------------------
# UpdateBatch constructors
# ---------------------------------------------------------------------------


def make_update_batch(kind, ext_ids, vectors, valid=None,
                      device=None) -> UpdateBatch:
    """Assemble an ``UpdateBatch`` from per-lane arrays (no padding), on
    ``device`` (default: the card)."""
    dev = torch.device("cuda" if device is None else device)
    kind = torch.as_tensor(np.asarray(kind), dtype=torch.int32, device=dev)
    ext_ids = torch.as_tensor(np.asarray(ext_ids), dtype=torch.int32,
                              device=dev)
    vectors = torch.as_tensor(np.asarray(vectors, np.float32),
                              dtype=torch.float32, device=dev)
    if valid is None:
        valid = torch.ones((kind.shape[0],), dtype=torch.bool, device=dev)
    else:
        valid = torch.as_tensor(np.asarray(valid), dtype=torch.bool,
                                device=dev)
    return UpdateBatch(kind=kind, ext_id=ext_ids, vector=vectors,
                       valid=valid)


def pad_update_batch(batch: UpdateBatch, bucket: Optional[int] = None
                     ) -> UpdateBatch:
    """Pad a batch up to ``bucket`` lanes (default: the next power of two)
    with masked no-op lanes."""
    b = batch.kind.shape[0]
    bucket = bucket if bucket is not None else next_bucket(b)
    if b == bucket:
        return batch

    def pad(arr, fill):
        extra = torch.full((bucket - b,) + tuple(arr.shape[1:]), fill,
                           dtype=arr.dtype, device=arr.device)
        return torch.cat([arr, extra])

    return UpdateBatch(
        kind=pad(batch.kind, KIND_INSERT),
        ext_id=pad(batch.ext_id, INVALID),
        vector=pad(batch.vector, 0.0),
        valid=pad(batch.valid, False),
    )


def insert_batch(ext_ids, vectors, *, bucket: bool = True,
                 device=None) -> UpdateBatch:
    """An insert-only ``UpdateBatch``; duplicate external ids are refused."""
    ext_ids = np.asarray(ext_ids)
    if len(np.unique(ext_ids)) != len(ext_ids):
        raise ValueError("duplicate external ids in one insert batch")
    b = make_update_batch(np.full((len(ext_ids),), KIND_INSERT), ext_ids,
                          vectors, device=device)
    return pad_update_batch(b) if bucket else b


def delete_batch(ext_ids, dim: int, *, bucket: bool = True,
                 device=None) -> UpdateBatch:
    """A delete-only ``UpdateBatch``; delete lanes carry zero vectors."""
    ext_ids = np.asarray(ext_ids)
    b = make_update_batch(np.full((len(ext_ids),), KIND_DELETE), ext_ids,
                          np.zeros((len(ext_ids), dim), np.float32),
                          device=device)
    return pad_update_batch(b) if bucket else b


def mixed_update_batch(ins_ext, ins_vectors, del_ext, dim: int,
                       device=None):
    """Insert lanes bucket-padded first, delete lanes bucket-padded after.
    Returns ``(UpdateBatch, split)``."""
    ins = insert_batch(ins_ext, ins_vectors, device=device)
    dele = delete_batch(del_ext, dim, device=device)
    batch = UpdateBatch(*[torch.cat([a, b]) for a, b in zip(ins, dele)])
    return batch, ins.kind.shape[0]


# ---------------------------------------------------------------------------
# Owner-compacted sharding constructors (ShardedIndex host helpers)
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _np_update_batch(batch: UpdateBatch) -> UpdateBatch:
    return UpdateBatch(*[_np(f) for f in batch])


def _compact_owner_batch_np(batch: UpdateBatch, owners, n_shards: int,
                            *, bucket: Optional[int] = None):
    """``compact_owner_batch`` on numpy payloads (the segment packer loops
    this per step and makes tensors once)."""
    b = _np_update_batch(batch)
    owners = np.where(b.valid, _np(owners), -1)
    if owners.size and int(owners.max()) >= n_shards:
        raise ValueError(
            f"owner id(s) >= n_shards={n_shards}: "
            f"{np.unique(owners[owners >= n_shards]).tolist()}"
        )
    counts = np.bincount(owners[owners >= 0], minlength=n_shards)
    need = int(counts.max())
    if bucket is None:
        bucket = next_bucket(max(need, 1))
    if need > bucket:
        raise ValueError(
            f"per-shard bucket {bucket} < max owned lanes {need}"
        )
    dim = b.vector.shape[1]
    pos = np.full(owners.shape, -1, np.int32)
    out = UpdateBatch(
        kind=np.full((n_shards, bucket), KIND_INSERT, np.int32),
        ext_id=np.full((n_shards, bucket), INVALID, np.int32),
        vector=np.zeros((n_shards, bucket, dim), np.float32),
        valid=np.zeros((n_shards, bucket), bool),
    )
    for s in range(n_shards):
        idx = np.nonzero(owners == s)[0]
        pos[idx] = np.arange(len(idx), dtype=np.int32)
        sub = take_update_lanes(b, idx)
        out.kind[s, : len(idx)] = sub.kind
        out.ext_id[s, : len(idx)] = sub.ext_id
        out.vector[s, : len(idx)] = sub.vector
        out.valid[s, : len(idx)] = sub.valid
    return out, pos, bucket


def _batch_to(batch: UpdateBatch, device=None) -> UpdateBatch:
    """An ``UpdateBatch`` of numpy arrays or tensors as tensors on
    ``device`` (default: the card)."""
    dev = torch.device("cuda" if device is None else device)
    return UpdateBatch(*(f.to(dev) if isinstance(f, torch.Tensor) else
                         torch.from_numpy(np.ascontiguousarray(f)).to(dev)
                         for f in batch))


def compact_owner_batch(batch: UpdateBatch, owners, n_shards: int,
                        *, bucket: Optional[int] = None, device=None):
    """Pack each shard's owned lanes of one ``UpdateBatch`` into a compact
    per-shard sub-batch.

    ``owners``: i32[B] owning shard per lane (negative = unowned; values at
    or beyond ``n_shards`` are a ``ValueError``; invalid lanes are ignored
    regardless).  Returns ``(stacked, pos, bucket)``:

      * ``stacked``: an (S, bucket) ``UpdateBatch`` on ``device`` (default:
        the card); row ``s`` holds shard ``s``'s owned lanes in their
        original relative order, padded to the power-of-two ``bucket`` with
        masked no-op lanes, so each shard applies ~B/S lanes instead of
        masking S-1 of every replicated lane;
      * ``pos``: i32[B] numpy, lane i's position inside its owner's
        sub-batch (-1 for unowned or invalid lanes), to scatter per-lane
        results back to the caller's lane order;
      * ``bucket``: the per-shard lane width used (``next_bucket`` of the
        most owned lanes unless pinned).

    Per-shard relative lane order is kept, so per-shard serial semantics
    equal the replicate-and-mask layout's bit for bit.
    """
    out, pos, bucket = _compact_owner_batch_np(batch, owners, n_shards,
                                               bucket=bucket)
    return _batch_to(out, device), pos, bucket


def compact_owner_segment(ops: UpdateBatch, owners, n_shards: int,
                          *, bucket: Optional[int] = None, device=None):
    """Owner-compact every op of a (T, B) segment tensor into one
    (S, T, bucket) op tensor on ``device`` (default: the card).

    ``owners``: i32[T, B].  One common power-of-two ``bucket`` (the most
    owned lanes over every (shard, op) cell unless pinned) keeps the
    stacked tensor one shape, so each shard scans T ops of ~B/S lanes.
    Returns ``(stacked, pos, bucket)`` with ``pos`` i32[T, B] as in
    ``compact_owner_batch``.
    """
    ops_np = _np_update_batch(ops)
    owners = np.where(ops_np.valid, _np(owners), -1)
    t_steps = ops_np.kind.shape[0]
    need = 1
    for t in range(t_steps):
        row = owners[t]
        counts = np.bincount(row[row >= 0], minlength=n_shards)
        need = max(need, int(counts.max()))
    if bucket is None:
        bucket = next_bucket(need)
    steps, pos = [], []
    for t in range(t_steps):
        sub, p, _ = _compact_owner_batch_np(
            take_update_lanes(ops_np, t), owners[t], n_shards, bucket=bucket
        )
        steps.append(sub)
        pos.append(p)
    stacked = UpdateBatch(*[np.stack(arrs, axis=1) for arrs in zip(*steps)])
    return _batch_to(stacked, device), np.stack(pos), bucket


# ---------------------------------------------------------------------------
# The update front door
# ---------------------------------------------------------------------------


def _drop_scatter(target, idx, values, ok):
    """``target.at[idx].set(values, mode="drop")`` restricted to ``ok``
    lanes (torch raises on out-of-range indices, so they are masked)."""
    sel = torch.nonzero(ok).squeeze(1)
    if sel.numel():
        vals = values if values.dim() == 0 else values[sel]
        target[idx[sel].long()] = vals
    return target


def _apply_impl(state: IndexState, cfg: ANNConfig, batch: UpdateBatch,
                pol: UpdatePolicy, sequential: bool, split: Optional[int]):
    dev = state.ext2slot.device
    b = batch.kind.shape[0]
    e_cap = state.ext2slot.shape[0]
    ext_ok = (batch.ext_id >= 0) & (batch.ext_id < e_cap)
    sext = batch.ext_id.clamp(0, e_cap - 1).long()
    is_ins = batch.valid & ext_ok & (batch.kind == KIND_INSERT)
    is_del = batch.valid & ext_ok & (batch.kind == KIND_DELETE)
    if split is not None:
        lane = torch.arange(b, device=dev)
        is_ins = is_ins & (lane < split)
        is_del = is_del & (lane >= split)
    graph = state.graph

    # ---- insert phase ------------------------------------------------------
    ins_fn = insert_many if sequential else insert_many_batched
    if split is None:
        graph, ins_stats = ins_fn(graph, cfg, batch.vector, is_ins)
        ins_slots = ins_stats.slot
        ins_comps_lane = ins_stats.n_comps
    else:
        graph, ins_stats = ins_fn(graph, cfg, batch.vector[:split],
                                  is_ins[:split])
        tail = torch.full((b - split,), INVALID, dtype=torch.int32,
                          device=dev)
        ins_slots = torch.cat([ins_stats.slot.to(torch.int32), tail])
        ins_comps_lane = torch.cat([ins_stats.n_comps.to(torch.int32),
                                    torch.zeros_like(tail)])
    ok_ins = is_ins & (ins_slots >= 0)

    # rebind: clear the stale reverse entry of a re-inserted external id
    prev = torch.where(ok_ins, state.ext2slot[sext],
                       torch.full_like(ins_slots, INVALID))
    _drop_scatter(state.slot2ext, clip_ids(prev, cfg.n_cap),
                  torch.tensor(INVALID, dtype=torch.int32, device=dev),
                  prev >= 0)
    _drop_scatter(state.ext2slot, sext, ins_slots, ok_ins)
    _drop_scatter(state.slot2ext, clip_ids(ins_slots, cfg.n_cap),
                  batch.ext_id, ok_ins)

    # ---- delete phase (policy-owned strategy) ------------------------------
    del_slots = torch.where(is_del, state.ext2slot[sext],
                            torch.full_like(ins_slots, INVALID))
    if split is None:
        graph, del_stats = pol.delete_many(graph, cfg, del_slots,
                                           sequential=sequential)
        del_ok_lane = del_stats.ok
        del_comps_lane = del_stats.n_comps
    else:
        graph, del_stats = pol.delete_many(graph, cfg, del_slots[split:],
                                           sequential=sequential)
        del_ok_lane = torch.cat([
            torch.zeros((split,), dtype=torch.bool, device=dev),
            del_stats.ok])
        del_comps_lane = torch.cat([
            torch.zeros((split,), dtype=torch.int32, device=dev),
            del_stats.n_comps.to(torch.int32)])
    ok_del = is_del & del_ok_lane
    inv = torch.tensor(INVALID, dtype=torch.int32, device=dev)
    _drop_scatter(state.ext2slot, sext, inv, ok_del)
    _drop_scatter(state.slot2ext, clip_ids(del_slots, cfg.n_cap), inv,
                  ok_del)

    # ---- counters + per-lane result ---------------------------------------
    zero = torch.zeros_like(ins_comps_lane)
    ins_comps = torch.where(is_ins, ins_comps_lane.to(torch.int32), zero)
    del_comps = torch.where(is_del, del_comps_lane.to(torch.int32), zero)
    state.n_inserts.add_(ok_ins.sum().to(torch.int32))
    state.n_deletes.add_(ok_del.sum().to(torch.int32))
    state.insert_comps.add_(ins_comps.sum().to(torch.int32))
    state.delete_comps.add_(del_comps.sum().to(torch.int32))
    result = ApplyResult(
        slot=torch.where(ok_ins, ins_slots,
                         torch.where(is_del, del_slots,
                                     torch.full_like(ins_slots, INVALID))),
        ok=ok_ins | ok_del,
        n_comps=ins_comps + del_comps,
    )
    return state._replace(graph=graph), result


def apply(state: IndexState, cfg: ANNConfig, batch: UpdateBatch, *,
          policy: str = "ip", sequential: bool = False,
          split: Optional[int] = None):
    """Apply one mixed insert+delete ``UpdateBatch``; returns
    ``(IndexState, ApplyResult)``.

    Lanes whose ``valid`` is False, whose external id is out of range, or
    (for deletes) unmapped, are no-ops with ``ok=False``.  ``split`` is the
    kind-major layout hint of ``mixed_update_batch``: insert lanes in
    ``[0, split)``, delete lanes in ``[split, B)``.

    The handle's tensors are MUTATED in place (the reference donates them):
    rebind the result, and ``clone_state`` first to keep the old state.
    """
    return _apply_impl(state, cfg, batch, get_policy(policy), sequential,
                       split)


# ---------------------------------------------------------------------------
# Consolidation trigger
# ---------------------------------------------------------------------------


def device_sweep(graph: GraphState, cfg: ANNConfig, pol: UpdatePolicy,
                 trig: torch.Tensor) -> GraphState:
    """Run ``pol``'s consolidation pass when ``trig`` is set (one host read
    of the trigger: the reference's ``lax.cond``)."""
    if bool(trig):
        graph = pol.consolidate(graph, cfg)
    return graph


def consolidate_if_needed(state: IndexState, cfg: ANNConfig, *,
                          policy: str = "ip", force: bool = False):
    """Evaluate the policy's trigger over the state's counters and sweep if
    it fires.  Returns ``(IndexState, did: bool tensor)``.  Only policies
    with ``device_consolidation`` qualify; ``fresh`` goes through
    ``maybe_consolidate``."""
    pol = get_policy(policy)
    if not pol.device_consolidation:
        raise ValueError(
            f"policy {policy!r} consolidates on host; use maybe_consolidate"
        )
    if force:
        trig = state.graph.n_pending > 0
    else:
        trig = pol.should_consolidate_device(cfg, state.graph)
    return state._replace(
        graph=device_sweep(state.graph, cfg, pol, trig)), trig


def maybe_consolidate(state: IndexState, cfg: ANNConfig, *,
                      policy: str = "ip", force: bool = False):
    """Run the policy's consolidation pass if its trigger fires (or, with
    ``force``, whenever slots are pending); returns ``(IndexState, did:
    bool)``.  Device policies (ip, local) go through
    ``consolidate_if_needed``; host policies (fresh) decide on the host from
    the synced counters."""
    pol = get_policy(policy)
    if pol.device_consolidation:
        state, did = consolidate_if_needed(state, cfg, policy=policy,
                                           force=force)
        return state, bool(did)
    n_active = int(state.graph.n_active)
    n_pending = int(state.graph.n_pending)
    if not (force and n_pending > 0) and not pol.should_consolidate(
            cfg, n_active, n_pending):
        return state, False
    return state._replace(graph=pol.consolidate(state.graph, cfg)), True


# ---------------------------------------------------------------------------
# Whole-segment update streams
# ---------------------------------------------------------------------------


def auto_unroll(t: int, b: int) -> int:
    """The reference's size-aware ``lax.scan`` unroll for a (T, B) segment:
    deeper for narrow lanes, 1 past B = 256, capped by T.  The port's
    segment loop accepts ``unroll`` and ignores it (eager PyTorch has no
    scan to unroll); the table is kept so callers and plans carry the same
    value in both packages."""
    if t <= 1:
        return 1
    if b <= 16:
        return min(8, t)
    if b <= 64:
        return min(4, t)
    if b <= 256:
        return min(2, t)
    return 1


def segment_scan(state: IndexState, cfg: ANNConfig, ops: UpdateBatch,
                 pol: UpdatePolicy, sequential: bool, split: Optional[int],
                 consolidate: bool = True):
    """The body of ``apply_segment``: a loop over the T axis of ``ops`` that
    runs the ``apply`` body (``_apply_impl``) on each op, then the policy's
    trigger over the state's counters.  Device policies (ip, local) sweep
    at once when it fires (``device_sweep``: one host read of the trigger
    per op) and set ``consolidated[t]``; host policies (fresh) only set
    ``needs_consolidation[t]``.  ``consolidate=False`` drops the trigger
    (both flags stay False).

    All-masked pad rows run through the same body: under fresh a trigger
    that fired on the last real op fires again on each pad row, as in the
    reference."""
    rows = []
    no = torch.tensor(False, device=state.ext2slot.device)
    for t in range(ops.kind.shape[0]):
        op = UpdateBatch(*(f[t] for f in ops))
        state, res = _apply_impl(state, cfg, op, pol, sequential, split)
        consolidated = needs = no
        if consolidate:
            trig = pol.should_consolidate_device(cfg, state.graph)
            if pol.device_consolidation:
                state = state._replace(
                    graph=device_sweep(state.graph, cfg, pol, trig))
                consolidated = trig
            else:
                needs = trig
        rows.append((res.slot, res.ok, res.n_comps, consolidated, needs))
    return state, SegmentResult(*(torch.stack(col) for col in zip(*rows)))


def apply_segment(state: IndexState, cfg: ANNConfig, ops: UpdateBatch, *,
                  policy: str = "ip", sequential: bool = False,
                  split: Optional[int] = None, consolidate: bool = True,
                  unroll: Optional[int] = None):
    """Run a whole update-stream segment, an ``UpdateBatch`` with a leading
    (T,) op axis.  Returns ``(IndexState, SegmentResult)``; op ``t`` is
    exactly ``apply(state_t, cfg, ops[t], ...)`` followed by the policy's
    trigger (see ``segment_scan``).  ``split`` is ``apply``'s kind-major
    layout hint, common to every op.  The handle is updated in place, as by
    ``apply``; ``unroll`` is accepted for the reference's signature and
    ignored."""
    return segment_scan(state, cfg, ops, get_policy(policy), sequential,
                        split, consolidate)


class Segment(NamedTuple):
    """One bucket-padded op tensor of a ``SegmentPlan``."""

    ops: UpdateBatch        # (T_bucket, B) stacked lanes
    split: Optional[int]    # common kind-major split of every op (or None)
    n_ops: int              # real ops; ops[n_ops:] are all-masked padding


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """An op stream chopped into segments: consecutive same-shape ops
    grouped, each group's op axis padded to a power of two with all-masked
    ops, groups capped at ``max_t``."""

    segments: tuple  # tuple[Segment, ...]

    @property
    def n_ops(self) -> int:
        return sum(s.n_ops for s in self.segments)


def plan_segments(steps, *, splits=None, max_t: int = 64,
                  keys=None) -> SegmentPlan:
    """Chop a list of ``UpdateBatch``es into ``Segment``s.  Consecutive
    steps share a segment only when their lane width, vector width, split
    (``splits``: one per step) and grouping key (``keys``: one per step)
    agree, up to ``max_t`` steps; each segment's T is padded to a power of
    two (at most ``next_bucket(max_t)``) with ``noop_update_batch`` steps
    on the steps' device."""
    steps = list(steps)
    if splits is None:
        splits = [None] * len(steps)
    if len(splits) != len(steps):
        raise ValueError("one split per step required")
    if keys is None:
        keys = [None] * len(steps)
    if len(keys) != len(steps):
        raise ValueError("one key per step required")
    max_t = max(1, max_t)

    segments = []
    i = 0
    while i < len(steps):
        b = steps[i].kind.shape[0]
        dim = steps[i].vector.shape[1]
        split, key = splits[i], keys[i]
        j = i
        while (j < len(steps) and j - i < max_t
               and steps[j].kind.shape[0] == b
               and steps[j].vector.shape[1] == dim
               and splits[j] == split and keys[j] == key):
            j += 1
        group = steps[i:j]
        t_bucket = min(next_bucket(len(group)), next_bucket(max_t))
        dev = steps[i].kind.device
        group = group + [noop_update_batch(b, dim, dev)
                         for _ in range(t_bucket - len(group))]
        segments.append(Segment(stack_update_batches(group), split, j - i))
        i = j
    return SegmentPlan(segments=tuple(segments))


def segment_step(state: IndexState, cfg: ANNConfig, seg: Segment, *,
                 policy: str = "ip", sequential: bool = False,
                 unroll: Optional[int] = None):
    """Apply ONE planned ``Segment``: ``apply_segment``, then the host
    policy's pass (fresh: Alg 4) when any row of the segment raised
    ``needs_consolidation``.  ``run_segments`` is a loop of it and
    ``core/persist.py``'s supervised runner replays it after a restore."""
    pol = get_policy(policy)
    state, res = apply_segment(state, cfg, seg.ops, policy=policy,
                               sequential=sequential, split=seg.split,
                               unroll=unroll)
    if not pol.device_consolidation and bool(
            res.needs_consolidation.any()):
        state = state._replace(graph=pol.consolidate(state.graph, cfg))
    return state, res


def run_segments(state: IndexState, cfg: ANNConfig, plan: SegmentPlan, *,
                 policy: str = "ip", sequential: bool = False,
                 unroll: Optional[int] = None, start: int = 0):
    """Execute a ``SegmentPlan`` from segment ``start`` on (restore paths
    replay a plan's tail).  Returns ``(state, [SegmentResult, ...])``, one
    result per executed segment (rows ``[:n_ops]`` are the real ops)."""
    results = []
    for seg in plan.segments[start:]:
        state, res = segment_step(state, cfg, seg, policy=policy,
                                  sequential=sequential, unroll=unroll)
        results.append(res)
    return state, results


# ---------------------------------------------------------------------------
# The query front door
# ---------------------------------------------------------------------------


def search(state: IndexState, cfg: ANNConfig, queries: torch.Tensor, *,
           k: int = 10, l: Optional[int] = None):
    """Query the handle; returns ``(ext_ids, dists, SearchResult)`` with
    slot ids mapped to external ids."""
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=state.ext2slot.device)
    res = search_batch(state.graph, cfg, queries, k=k, l=l or cfg.l_search)
    sids = res.topk_ids
    ext = torch.where(sids >= 0, state.slot2ext[clip_ids(sids, cfg.n_cap)],
                      torch.full_like(sids, INVALID))
    return ext, res.topk_dists, res


__all__ = [
    "FreshDiskANNPolicy", "IPDiskANNPolicy", "LocalRepairPolicy", "Segment",
    "SegmentPlan", "SnapshotHandle", "UpdatePolicy", "apply",
    "apply_segment", "auto_unroll",
    "available_policies", "clone_state", "compact_owner_batch",
    "compact_owner_segment", "consolidate_if_needed",
    "delete_batch", "device_sweep", "get_policy", "insert_batch",
    "make_update_batch", "maybe_consolidate", "mixed_update_batch",
    "pad_update_batch", "plan_segments", "register_policy", "run_segments",
    "search", "segment_scan", "segment_step", "take_snapshot",
]
