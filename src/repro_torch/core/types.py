"""Core data structures of the streaming graph index, as PyTorch tensors.

The PyTorch counterpart of ``repro/core/types.py``: the same dense slot
matrix (``vectors[n_cap, dim]``, front-compacted ``adj[n_cap, r]``, per-slot
status masks, a descending free stack), held as ``NamedTuple``s of tensors
with the reference's field order.  The port updates state tensors in place
where the reference donates them (see ``core/api.py::apply``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .quant import QuantStore, init_quant_store

INVALID = -1
KIND_INSERT = 0
KIND_DELETE = 1


@dataclasses.dataclass(frozen=True)
class ANNConfig:
    """Static configuration of a streaming graph index: R (degree), l_b /
    l_s / l_d (beam widths for build / search / delete), alpha (prune
    slack), k (delete candidate list size), c (edge copies per delete)."""

    dim: int
    n_cap: int
    r: int = 64
    l_build: int = 128
    l_search: int = 128
    l_delete: int = 128
    k_delete: int = 50
    n_copies: int = 3  # the paper's ``c``
    alpha: float = 1.2
    metric: str = "l2"  # "l2" (squared euclidean) | "ip" (negative dot)
    # hard bound on beam-search expansions beyond l
    max_visit_slack: int = 64
    consolidation_threshold: float = 0.2
    # "auto" resolves by the device of the state's tensors: "cuda" (the
    # hand-written kernels) on CUDA tensors, "torch" (plain) on CPU ones
    backend: str = "auto"
    # hops per super-step of the batched hop loop: -1 = auto (4 where the
    # cuda engine resolves, 0 elsewhere), 0 = off, H >= 1 = fused
    hop_fused: int = -1
    # the int8 quantized memory tier (core/quant.py): the batched engine
    # traverses on int8 codes and rescores the final beam in f32
    quantized: bool = False
    # "local" policy in-neighbour repair bound (0 = auto, 2r)
    local_in_cap: int = 0

    def max_visits(self, l: int) -> int:
        return l + self.max_visit_slack

    def resolved_local_in_cap(self) -> int:
        return self.local_in_cap if self.local_in_cap > 0 else 2 * self.r

    def __post_init__(self):
        assert self.metric in ("l2", "ip"), self.metric
        assert self.r >= 1 and self.n_cap >= 1 and self.dim >= 1
        assert self.hop_fused >= -1, self.hop_fused
        assert self.local_in_cap >= 0, self.local_in_cap
        if self.backend != "auto":
            from .backend import available_backends

            if self.backend not in available_backends():
                raise ValueError(
                    f"unknown backend {self.backend!r}; "
                    f"known: {('auto',) + available_backends()}"
                )


class GraphState(NamedTuple):
    """The full mutable state of one index, as tensors on one device."""

    vectors: torch.Tensor     # f32[n_cap, dim]
    norms: torch.Tensor       # f32[n_cap]  squared L2 norms
    adj: torch.Tensor         # i32[n_cap, r]  out-neighbours, INVALID padded
    active: torch.Tensor      # bool[n_cap]  live and returnable
    tombstone: torch.Tensor   # bool[n_cap]  lazily deleted (fresh)
    quarantine: torch.Tensor  # bool[n_cap]  freed in place (ip)
    free_stack: torch.Tensor  # i32[n_cap]  slot allocator stack
    free_top: torch.Tensor    # i32[]  number of free slots
    start: torch.Tensor       # i32[]  entry point (INVALID when empty)
    n_active: torch.Tensor    # i32[]
    n_pending: torch.Tensor   # i32[]  quarantined (ip) count
    # the int8 tier (core/quant.py), present iff ``cfg.quantized``
    quant: Optional[QuantStore] = None


class IndexState(NamedTuple):
    """The device-resident index handle: graph, id maps and op counters."""

    graph: GraphState
    ext2slot: torch.Tensor      # i32[max_ext]
    slot2ext: torch.Tensor      # i32[n_cap]
    n_inserts: torch.Tensor     # i32[]
    n_deletes: torch.Tensor     # i32[]
    insert_comps: torch.Tensor  # i32[]
    delete_comps: torch.Tensor  # i32[]


class UpdateBatch(NamedTuple):
    """One padded lane-batch of the unified update stream."""

    kind: torch.Tensor    # i32[B]
    ext_id: torch.Tensor  # i32[B]
    vector: torch.Tensor  # f32[B, dim]
    valid: torch.Tensor   # bool[B]


class ApplyResult(NamedTuple):
    """Per-lane outcome of one ``apply`` call."""

    slot: torch.Tensor     # i32[B]
    ok: torch.Tensor       # bool[B]
    n_comps: torch.Tensor  # i32[B]


class SegmentResult(NamedTuple):
    """Per-op stacked outcome of one ``apply_segment`` call (leading axis
    ``T`` = ops in the segment; lane axes as in ``ApplyResult``).  Rows are
    copies, never views of the state the next op writes."""

    slot: torch.Tensor                 # i32[T, B]
    ok: torch.Tensor                   # bool[T, B]
    n_comps: torch.Tensor              # i32[T, B]
    consolidated: torch.Tensor         # bool[T]  the device pass ran after
                                       #          the op (ip, local)
    needs_consolidation: torch.Tensor  # bool[T]  the trigger fired under a
                                       #          host policy (fresh): the
                                       #          caller consolidates at the
                                       #          segment boundary


def stack_update_batches(steps) -> UpdateBatch:
    """Stack ``T`` same-width ``UpdateBatch``es into one (T, B) op tensor
    (the payload of ``apply_segment``)."""
    widths = {s.kind.shape[0] for s in steps}
    if len(widths) != 1:
        raise ValueError(f"segment steps must share one lane width: {widths}")
    return UpdateBatch(*[torch.stack(arrs) for arrs in zip(*steps)])


def noop_update_batch(b: int, dim: int, device=None) -> UpdateBatch:
    """An all-masked ``UpdateBatch`` (T-axis padding for segment buckets),
    on ``device`` (default: the card)."""
    dev = resolve_device(device)
    return UpdateBatch(
        kind=torch.full((b,), KIND_INSERT, dtype=torch.int32, device=dev),
        ext_id=torch.full((b,), INVALID, dtype=torch.int32, device=dev),
        vector=torch.zeros((b, dim), dtype=torch.float32, device=dev),
        valid=torch.zeros((b,), dtype=torch.bool, device=dev),
    )


def take_update_lanes(batch: UpdateBatch, idx) -> UpdateBatch:
    """Gather the lanes ``idx`` (any integer index) out of ``batch``; lane
    order follows ``idx``.  Field-generic: numpy and torch payloads alike."""
    return UpdateBatch(
        kind=batch.kind[idx],
        ext_id=batch.ext_id[idx],
        vector=batch.vector[idx],
        valid=batch.valid[idx],
    )


def stack_states(rows, device=None):
    """Stack same-shaped states (``IndexState``, ``GraphState``, any tuple
    of tensors, ``None`` leaves kept) on a new leading axis, on ``device``
    (default: the first row's).  Numpy rows stack with ``np.stack``."""
    first = rows[0]
    if first is None:
        return None
    if isinstance(first, np.ndarray):
        return np.stack(rows)
    if isinstance(first, torch.Tensor):
        dev = first.device if device is None else torch.device(device)
        return torch.stack([r.to(dev) for r in rows])
    return type(first)(*(stack_states(col, device) for col in zip(*rows)))


def unstack_state(state):
    """The rows of a stacked state (``IndexState``, ``GraphState``, ...):
    views ``x[l]`` of every leaf (numpy or torch), one state per index of
    the leading axis."""
    def row(x, i):
        if x is None:
            return None
        if isinstance(x, tuple):
            return type(x)(*(row(c, i) for c in x))
        return x[i]

    def leading(x):
        if isinstance(x, tuple):
            return next(n for n in map(leading, x) if n is not None)
        return None if x is None else x.shape[0]

    return [row(state, i) for i in range(leading(state))]


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller names another device."""
    return torch.device("cuda" if device is None else device)


def _i32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def init_state(cfg: ANNConfig, device=None,
               dtype=torch.float32) -> GraphState:
    dev = resolve_device(device)
    n = cfg.n_cap
    return GraphState(
        vectors=torch.zeros((n, cfg.dim), dtype=dtype, device=dev),
        norms=torch.zeros((n,), dtype=torch.float32, device=dev),
        adj=torch.full((n, cfg.r), INVALID, dtype=torch.int32, device=dev),
        active=torch.zeros((n,), dtype=torch.bool, device=dev),
        tombstone=torch.zeros((n,), dtype=torch.bool, device=dev),
        quarantine=torch.zeros((n,), dtype=torch.bool, device=dev),
        free_stack=torch.arange(n - 1, -1, -1, dtype=torch.int32,
                                device=dev),
        free_top=_i32(n, dev),
        start=_i32(INVALID, dev),
        n_active=_i32(0, dev),
        n_pending=_i32(0, dev),
        quant=init_quant_store(n, cfg.dim, dev) if cfg.quantized else None,
    )


def init_index_state(cfg: ANNConfig, max_external_id: int, device=None,
                     dtype=torch.float32) -> IndexState:
    """A fresh handle admitting external ids in ``[0, max_external_id)``,
    allocated on ``device`` (default: the card)."""
    if max_external_id <= 0:
        raise ValueError(
            f"max_external_id must be positive, got {max_external_id}"
        )
    dev = resolve_device(device)
    return IndexState(
        graph=init_state(cfg, dev, dtype),
        ext2slot=torch.full((max_external_id,), INVALID, dtype=torch.int32,
                            device=dev),
        slot2ext=torch.full((cfg.n_cap,), INVALID, dtype=torch.int32,
                            device=dev),
        n_inserts=_i32(0, dev),
        n_deletes=_i32(0, dev),
        insert_comps=_i32(0, dev),
        delete_comps=_i32(0, dev),
    )


def navigable(state: GraphState) -> torch.Tensor:
    """Slots the greedy search may traverse (live or tombstoned)."""
    return state.active | state.tombstone


def row_count(rows: torch.Tensor) -> torch.Tensor:
    """Valid entries along the last axis (i32)."""
    return (rows >= 0).sum(-1).to(torch.int32)


def row_contains(rows: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Whether each row (last axis) holds its id in ``u`` (one per row)."""
    return (rows == u.unsqueeze(-1)).any(-1)


def compact_row(rows: torch.Tensor) -> torch.Tensor:
    """Move valid entries to the front of each row, preserving order."""
    order = torch.sort((rows < 0).to(torch.int8), dim=-1, stable=True)[1]
    return torch.gather(rows, -1, order)


def mask_duplicates(ids: torch.Tensor) -> torch.Tensor:
    """Replace duplicate ids along the last axis (keep the first occurrence)
    with INVALID; also INVALID-ates negative ids.  A stable sort finds the
    duplicates (equal ids keep their order, so the first occurrence leads
    its run): O(C log C) per row, which an Alg-4 splice of C = r + r^2
    candidates needs."""
    srt, order = torch.sort(ids, dim=-1, stable=True)
    dup_sorted = torch.zeros_like(srt, dtype=torch.bool)
    dup_sorted[..., 1:] = srt[..., 1:] == srt[..., :-1]
    dup = torch.zeros_like(dup_sorted).scatter_(-1, order, dup_sorted)
    return torch.where(dup | (ids < 0), torch.full_like(ids, INVALID), ids)


def clip_ids(ids: torch.Tensor, n_cap: int) -> torch.Tensor:
    return ids.clamp(0, n_cap - 1).to(torch.int64)
