"""Edge mutation helpers shared by insert / delete (``repro/core/edges.py``).

``append_one`` adds edge v -> u (Algorithm 2 lines 5-8 for one edge), with a
RobustPrune of v's row when it would exceed degree r.  An append reads and
writes only row v (plus the status masks and vectors, which no append
changes), so appends aimed at DISTINCT rows commute: ``append_rows`` applies
a set of them at once and equals applying them one after another in any
order.  The insert's reverse edges and each round of the delete's repair
edges are such sets.  All functions update ``state.adj`` in place.
"""
from __future__ import annotations

import torch

from .prune import robust_prune_rows
from .types import (INVALID, ANNConfig, GraphState, clip_ids, compact_row,
                    row_contains, row_count)


def append_rows(state: GraphState, cfg: ANNConfig, vs: torch.Tensor,
                us: torch.Tensor) -> GraphState:
    """Add the edges ``vs[i] -> us[i]``; valid ``vs`` must be distinct.
    Each lane no-ops when v/u is INVALID, u == v, u is already in v's row,
    or either end is not a live slot."""
    vs = vs.to(torch.int32).reshape(-1)
    us = us.to(torch.int32).reshape(-1).expand(vs.shape[0])
    sv = clip_ids(vs, cfg.n_cap)
    su = clip_ids(us, cfg.n_cap)
    rows = state.adj[sv]                                      # (M, r)
    u_live = state.active[su] | state.tombstone[su]
    v_live = state.active[sv] | state.tombstone[sv]
    skip = ((vs < 0) | (us < 0) | (vs == us) | row_contains(rows, us)
            | ~u_live | ~v_live)
    cnt = row_count(rows)
    do_append = ~skip & (cnt < cfg.r)
    do_prune = ~skip & (cnt >= cfg.r)
    # one host read decides which lanes append and which prune
    flags = torch.stack([do_append, do_prune]).cpu()
    app = torch.nonzero(flags[0]).squeeze(1).to(vs.device)
    if app.numel():
        state.adj[sv[app], cnt[app]] = us[app]
    sel = torch.nonzero(flags[1]).squeeze(1).to(vs.device)
    if sel.numel():
        cand = torch.cat([rows[sel], us[sel, None]], dim=1)
        new_rows = robust_prune_rows(state, cfg, state.vectors[sv[sel]],
                                     cand, p_ids=vs[sel])
        state.adj[sv[sel]] = new_rows
    return state


def append_one(state: GraphState, cfg: ANNConfig, v, u) -> GraphState:
    """Add edge v -> u; RobustPrune v's row if it would exceed degree r."""
    dev = state.adj.device
    return append_rows(state, cfg, torch.as_tensor(v, device=dev),
                       torch.as_tensor(u, device=dev))


def remove_target_everywhere(state: GraphState, cfg: ANNConfig, target):
    """Remove every edge ``* -> target`` from the whole adjacency: one
    (n_cap, r) compare, the exact in-neighbourhood.  Only the rows that
    had a hit are re-compacted and written (the reference re-compacts all
    n_cap rows and keeps the untouched ones bit-identical, which is the
    same result).  Updates ``state.adj`` in place and returns it."""
    if int(target) < 0:
        return state.adj
    hit = state.adj == int(target)
    sel = torch.nonzero(hit.any(1)).squeeze(1)
    if sel.numel():
        rows = state.adj[sel]
        state.adj[sel] = compact_row(
            torch.where(hit[sel], torch.full_like(rows, INVALID), rows))
    return state.adj


def remove_target_rows(state: GraphState, cfg: ANNConfig, row_ids, target):
    """Remove ``target`` from the rows listed in ``row_ids`` (INVALID padded,
    unique among valid entries), re-compacting the rows that change.
    Updates ``state.adj`` in place and returns it."""
    safe = clip_ids(row_ids, cfg.n_cap)
    rows = state.adj[safe]
    hit = (rows == target) & (row_ids >= 0)[:, None]
    write = hit.any(1)
    sel = torch.nonzero(write).squeeze(1)
    if sel.numel():
        cleaned = torch.where(hit[sel], torch.full_like(rows[sel], INVALID),
                              rows[sel])
        state.adj[safe[sel]] = compact_row(cleaned)
    return state.adj
