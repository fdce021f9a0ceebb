"""Consolidation passes (``repro/core/consolidate.py``).

``light_consolidate`` is Algorithm 6: strip dangling edges to quarantined
slots and release those slots to the free stack.  No distance computations.

``fresh_consolidate`` is Algorithm 4, FreshDiskANN's batch consolidation:
every live vertex with tombstoned out-neighbours splices in those
tombstones' rows and RobustPrunes the r + r^2 candidates back to r, then
the tombstoned slots are released.  Host-orchestrated as in the reference:
the affected rows are found on the device, read back, and pruned in chunks
sized to ``CONSOLIDATE_CHUNK_BYTES`` of gathered candidate rows; every chunk
reads the adjacency as it was before the pass, and the new rows are written
at the end.

``consolidate_stacked`` runs either pass on chosen rows of a stacked
(sharded) graph, in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from .prune import robust_prune_rows
from .types import (INVALID, ANNConfig, GraphState, clip_ids, compact_row,
                    unstack_state)

# device bytes of gathered candidate rows ((chunk, r + r^2, dim) f32) that
# one chunk of Algorithm 4 may hold
CONSOLIDATE_CHUNK_BYTES = 1 << 30


def consolidation_due(state: GraphState, cfg: ANNConfig) -> torch.Tensor:
    """The trigger as a bool tensor: pending removals exceed the configured
    fraction of the live set (compared in float32, as the reference)."""
    n_active = state.n_active.clamp(min=1).to(torch.float32)
    thr = torch.tensor(cfg.consolidation_threshold, dtype=torch.float32,
                       device=n_active.device)
    return (state.n_pending > 0) & \
        (state.n_pending.to(torch.float32) > thr * n_active)


# the exact GraphState fields Algorithm 6 reads and writes
LIGHT_CONSOLIDATE_FIELDS = (
    "adj", "quarantine", "free_stack", "free_top", "n_pending"
)


def light_consolidate_fields(cfg: ANNConfig, adj, quarantine, free_stack,
                             free_top, n_pending):
    """Algorithm 6 on exactly the fields it touches; returns the updated
    ``LIGHT_CONSOLIDATE_FIELDS`` tuple (new tensors)."""
    dead = quarantine[clip_ids(adj, cfg.n_cap)] & (adj >= 0)
    adj = compact_row(torch.where(dead, torch.full_like(adj, INVALID), adj))
    q_ids = torch.nonzero(quarantine).squeeze(1).to(torch.int32)  # ascending
    n_q = q_ids.shape[0]
    free_stack = free_stack.clone()
    top = int(free_top)
    free_stack[top:top + n_q] = q_ids
    return (
        adj,
        torch.zeros_like(quarantine),
        free_stack,
        free_top + n_q,
        torch.zeros_like(n_pending),
    )


def light_consolidate(state: GraphState, cfg: ANNConfig) -> GraphState:
    """Algorithm 6: remove dangling edges, free quarantined slots.  Writes
    the results into the state's tensors in place."""
    out = light_consolidate_fields(
        cfg, *(getattr(state, f) for f in LIGHT_CONSOLIDATE_FIELDS)
    )
    for f, new in zip(LIGHT_CONSOLIDATE_FIELDS, out):
        getattr(state, f).copy_(new)
    return state


# ---------------------------------------------------------------------------
# FreshDiskANN batch consolidation (Algorithm 4)
# ---------------------------------------------------------------------------


def _splice_candidates(state: GraphState, cfg: ANNConfig, nodes):
    """Candidates of affected nodes: (own row \\ D) U (rows of deleted
    out-neighbours \\ D), i32[M, r + r*r]."""
    row = state.adj[nodes]                                   # (M, r)
    srow = clip_ids(row, cfg.n_cap)
    nbr_dead = state.tombstone[srow] & (row >= 0)
    inv = torch.full_like(row, INVALID)
    two_hop = torch.where(nbr_dead[..., None], state.adj[srow],
                          inv[..., None])                    # (M, r, r)
    keep_own = torch.where((row >= 0) & ~nbr_dead, row, inv)
    cand = torch.cat([keep_own, two_hop.reshape(row.shape[0], -1)], 1)
    ok = (cand >= 0) & ~state.tombstone[clip_ids(cand, cfg.n_cap)] & \
        (cand != nodes[:, None])
    return torch.where(ok, cand, torch.full_like(cand, INVALID))


def _consolidate_rows(state: GraphState, cfg: ANNConfig, nodes):
    """New rows for a chunk of affected nodes (Alg 4 lines 4-7)."""
    nodes = nodes.to(torch.int32)
    cand = _splice_candidates(state, cfg, nodes)
    return robust_prune_rows(state, cfg, state.vectors[nodes.long()], cand,
                             p_ids=nodes)


def _affected_mask(state: GraphState, cfg: ANNConfig) -> torch.Tensor:
    """Live slots with at least one tombstoned out-neighbour."""
    dead = state.tombstone[clip_ids(state.adj, cfg.n_cap)] & (state.adj >= 0)
    return dead.any(1) & state.active


def _release_tombstones(state: GraphState, cfg: ANNConfig) -> GraphState:
    """Clear the tombstoned slots' rows and push them onto the free stack
    (ascending); keep the entry point live.  In place."""
    t = state.tombstone
    t_ids = torch.nonzero(t).squeeze(1).to(torch.int32)
    top = int(state.free_top)
    state.free_stack[top:top + t_ids.numel()] = t_ids
    state.adj[t] = INVALID
    nav = state.active
    start_dead = (state.start >= 0) & t[clip_ids(state.start, cfg.n_cap)]
    first_live = torch.where(nav.any(),
                             torch.argmax(nav.to(torch.int8)).to(torch.int32),
                             INVALID)
    state.start.copy_(torch.where(start_dead, first_live, state.start))
    t.zero_()
    state.free_top.add_(t_ids.numel())
    state.n_pending.zero_()
    return state


def consolidate_chunk(cfg: ANNConfig) -> int:
    """Affected rows per chunk of Algorithm 4: as many as fit
    ``CONSOLIDATE_CHUNK_BYTES`` of gathered (r + r^2, dim) candidate rows."""
    width = cfg.r + cfg.r * cfg.r
    return max(1, CONSOLIDATE_CHUNK_BYTES // (width * cfg.dim * 4))


def fresh_consolidate(state: GraphState, cfg: ANNConfig,
                      chunk: Optional[int] = None) -> GraphState:
    """Algorithm 4 (the FreshDiskANN baseline's offline pass), in place."""
    affected = torch.nonzero(_affected_mask(state, cfg)).squeeze(1)
    if affected.numel():
        chunk = chunk or consolidate_chunk(cfg)
        rows = [_consolidate_rows(state, cfg, affected[i:i + chunk])
                for i in range(0, affected.numel(), chunk)]
        state.adj[affected] = torch.cat(rows)
    return _release_tombstones(state, cfg)


def _write_back(dst, src) -> None:
    """Copy every tensor leaf of ``src`` into ``dst`` (a view of a stacked
    state's row), skipping leaves that already are that view."""
    if dst is None:
        return
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
        return
    for d, s in zip(dst, src):
        _write_back(d, s)


def consolidate_stacked(graphs: GraphState, cfg: ANNConfig, consolidate_fn,
                        shard_ids) -> GraphState:
    """Run a per-row consolidation pass over a STACKED ``GraphState``
    (leading logical-shard axis).  For each row in ``shard_ids``: run
    ``consolidate_fn(graph, cfg)`` (fresh's Algorithm 4, or
    ``light_consolidate``) on the row's views and write the result back
    into the stacked tensors in place with ``copy_``: O(one row) in copies.
    Returns ``graphs``, updated in place."""
    rows = unstack_state(graphs)
    for s in shard_ids:
        _write_back(rows[s], consolidate_fn(rows[s], cfg))
    return graphs
