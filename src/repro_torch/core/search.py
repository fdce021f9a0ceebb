"""GreedySearch (Algorithm 1) for one query (``repro/core/search.py``).

The beam is a fixed-width ``(l,)`` sorted triple (ids, dists, expanded); one
hop pops the closest unexpanded vertex and sort-merges its ``R`` fresh
neighbours (stable, beam entries first on ties).  The reference's
``lax.while_loop`` is a Python loop with one host read of the predicate per
hop.  Tombstoned slots are navigated but never returned.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .backend import BIG, resolve_backend
from .types import INVALID, ANNConfig, GraphState, clip_ids, navigable


class SearchResult(NamedTuple):
    topk_ids: torch.Tensor       # i32[k]
    topk_dists: torch.Tensor     # f32[k]
    visited_ids: torch.Tensor    # i32[max_visits]  expansion order
    visited_dists: torch.Tensor  # f32[max_visits]
    n_visited: torch.Tensor      # i32[]
    n_comps: torch.Tensor        # i32[]
    n_hops: torch.Tensor         # i32[]


DistanceFn = Callable[[GraphState, ANNConfig, torch.Tensor, torch.Tensor],
                      torch.Tensor]


def final_topk(beam_ids, beam_dists, returnable, n_cap: int, k: int):
    """Top-k of the beam over returnable slots, ties to the lower beam
    position (``lax.top_k``'s order); ``(ids, dists)`` padded with
    (INVALID, inf) past l or past the returnable entries."""
    from ..kernels.ref import stable_topk_smallest

    l = beam_ids.shape[-1]
    ret = returnable[clip_ids(beam_ids, n_cap)] & (beam_ids >= 0)
    final_d = torch.where(ret, beam_dists, torch.full_like(beam_dists, BIG))
    kk = min(k, l)
    top_d, top_i = stable_topk_smallest(final_d, kk)
    ids = torch.where(torch.isfinite(top_d),
                      torch.gather(beam_ids, -1, top_i),
                      torch.full_like(top_i, INVALID, dtype=torch.int32))
    ids = ids.to(torch.int32)
    if kk < k:
        pad = list(ids.shape[:-1]) + [k - kk]
        ids = torch.cat([ids, torch.full(pad, INVALID, dtype=torch.int32,
                                         device=ids.device)], -1)
        top_d = torch.cat([top_d, torch.full(pad, BIG,
                                             device=top_d.device)], -1)
    return ids, top_d


def greedy_search(state: GraphState, cfg: ANNConfig, q: torch.Tensor, *,
                  k: int, l: int, max_visits: Optional[int] = None,
                  distance_fn: Optional[DistanceFn] = None) -> SearchResult:
    """Beam search for the nearest neighbours of ``q`` (Algorithm 1),
    distances through the engine ``cfg.backend`` resolves to."""
    if max_visits is None:
        max_visits = cfg.max_visits(l)
    dev = state.vectors.device
    if distance_fn is None:
        dist = resolve_backend(cfg, dev).bind_dists_to_ids(state, cfg, q)
    else:
        def dist(ids):
            return distance_fn(state, cfg, q, ids)
    nav = navigable(state)
    returnable = state.active
    n = cfg.n_cap

    start = state.start.reshape(1)
    d0 = dist(start)[0]
    beam_ids = torch.full((l,), INVALID, dtype=torch.int32, device=dev)
    beam_ids[0] = start[0]
    beam_dists = torch.full((l,), BIG, dtype=torch.float32, device=dev)
    beam_dists[0] = torch.where(start[0] >= 0, d0, BIG)
    beam_exp = torch.zeros((l,), dtype=torch.bool, device=dev)
    seen = torch.zeros((n,), dtype=torch.bool, device=dev)
    seen[clip_ids(start, n)] = start >= 0
    vis_ids = torch.full((max_visits,), INVALID, dtype=torch.int32,
                         device=dev)
    vis_dists = torch.full((max_visits,), BIG, dtype=torch.float32,
                           device=dev)
    n_vis = torch.zeros((), dtype=torch.int32, device=dev)
    n_comps = (start[0] >= 0).to(torch.int32)
    n_hops = 0

    while n_hops < max_visits:
        frontier = (beam_ids >= 0) & ~beam_exp
        if not bool((frontier & torch.isfinite(beam_dists)).any()):
            break
        # --- pop the closest unexpanded vertex ---------------------------
        frontier_d = torch.where(frontier, beam_dists,
                                 torch.full_like(beam_dists, BIG))
        i = torch.argmin(frontier_d)
        v = beam_ids[i]
        dv = beam_dists[i]
        beam_exp[i] = True
        # --- visited list (returnable pops only) -------------------------
        sv = clip_ids(v, n)
        v_ret = returnable[sv]
        slot = n_vis.long()          # < max_visits: n_vis <= n_hops
        vis_ids[slot] = torch.where(v_ret, v, vis_ids[slot])
        vis_dists[slot] = torch.where(v_ret, dv, vis_dists[slot])
        n_vis = n_vis + v_ret.to(torch.int32)
        # --- expand ------------------------------------------------------
        nbrs = state.adj[sv]
        safe = clip_ids(nbrs, n)
        fresh = (nbrs >= 0) & nav[safe] & ~seen[safe]
        masked = torch.where(fresh, nbrs, torch.full_like(nbrs, INVALID))
        nd = dist(masked)
        n_comps = n_comps + fresh.sum().to(torch.int32)
        seen[safe[fresh]] = True
        # --- stable sort-merge, keep top-l -------------------------------
        all_d = torch.cat([beam_dists, nd])
        all_i = torch.cat([beam_ids, masked])
        all_e = torch.cat([beam_exp, torch.zeros_like(fresh)])
        beam_dists, order = torch.sort(all_d, stable=True)
        beam_dists = beam_dists[:l].contiguous()
        beam_ids = all_i[order[:l]]
        beam_exp = all_e[order[:l]]
        n_hops += 1

    ids, dists = final_topk(beam_ids, beam_dists, returnable, n, k)
    return SearchResult(
        topk_ids=ids, topk_dists=dists, visited_ids=vis_ids,
        visited_dists=vis_dists, n_visited=n_vis, n_comps=n_comps,
        n_hops=torch.tensor(n_hops, dtype=torch.int32, device=dev),
    )


def search_batch(state: GraphState, cfg: ANNConfig, queries: torch.Tensor,
                 *, k: int, l: int, max_visits: Optional[int] = None,
                 starts: Optional[torch.Tensor] = None) -> SearchResult:
    """Batched greedy search over a (B, dim) query batch through the shared
    hop loop of ``core/search_batched.py``.  B is padded to the next power
    of two with masked lanes, as the reference buckets it (a masked lane
    starts empty and costs no hops); the padding is sliced off.
    ``starts`` (i32[B]) gives each query its own entry point."""
    from .search_batched import batched_greedy_search, pad_batch

    b = queries.shape[0]
    qs = pad_batch(queries, b)
    valid = torch.arange(qs.shape[0], device=qs.device) < b
    if starts is not None:
        starts = pad_batch(starts.to(device=qs.device, dtype=torch.int32), b)
    res = batched_greedy_search(state, cfg, qs, k=k, l=l,
                                max_visits=max_visits, valid=valid,
                                starts=starts)
    if qs.shape[0] != b:
        res = SearchResult(*[x[:b] for x in res])
    return res
