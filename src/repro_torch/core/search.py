"""GreedySearch (Algorithm 1) for one query (``repro/core/search.py``).

The beam is a fixed-width ``(l,)`` sorted triple (ids, dists, expanded); one
hop pops the closest unexpanded vertex and sort-merges its ``R`` fresh
neighbours (stable, beam entries first on ties).  The reference's
``lax.while_loop`` is a Python loop with one host read of the predicate per
hop.  Tombstoned slots are navigated but never returned.

``search_batch_vmap`` is the reference's ``jax.vmap`` of that loop for a
query batch, kept as the baseline the natively batched engine
(``core/search_batched.py``) is timed against; ``search_batch`` is the
front door to that engine.
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


def se_key(e: torch.Tensor) -> torch.Tensor:
    """Bool flags ride through the sort-merge as int32 payload."""
    return e.to(torch.int32)


def search_batch_vmap(state: GraphState, cfg: ANNConfig,
                      queries: torch.Tensor, *, k: int, l: int,
                      distance_fn: Optional[DistanceFn] = None
                      ) -> SearchResult:
    """Greedy search over a (B, dim) query batch as ``jax.vmap`` of the
    reference's ``greedy_search`` runs it: lane ``b`` returns what
    ``greedy_search(state, cfg, queries[b], k=k, l=l)`` returns.

    One carry of B lanes, one hop loop while any lane's predicate holds
    (one host read a hop).  The hop body runs for every lane, and every
    carry leaf is ``torch.where(live, new, old)``, so a lane that has ended
    keeps its carry; this whole-carry select, the (B, n_cap) ``seen``
    bitmap included, is what the natively batched engine avoids, and what
    this baseline exists to show.  ``seen`` takes B * n_cap bytes (256 MB
    at B = 256 and n_cap = 10^6), about three times that at the peak of a
    hop.  Each hop's (B, R) distance tile is one
    ``dists_to_ids_batched`` call of the engine ``cfg.backend`` resolves to
    (the ``cuda`` engine's batched gather kernel); ``distance_fn`` keeps
    the per-query signature and is applied lane by lane."""
    max_visits = cfg.max_visits(l)
    dev = state.vectors.device
    queries = queries.to(device=dev, dtype=torch.float32).contiguous()
    if distance_fn is None:
        batched = resolve_backend(cfg, dev).dists_to_ids_batched
    else:
        batched = _lift_distance_fn(distance_fn)

    def dist(ids):
        return batched(state, cfg, queries, ids)

    nav = navigable(state)
    returnable = state.active
    n = cfg.n_cap
    b = queries.shape[0]
    rows = torch.arange(b, device=dev)
    cols = torch.arange(max_visits, device=dev)

    start = state.start.reshape(1).expand(b).to(torch.int32).contiguous()
    has = start >= 0
    d0 = dist(start[:, None])[:, 0]
    beam_ids = torch.full((b, l), INVALID, dtype=torch.int32, device=dev)
    beam_ids[:, 0] = start
    beam_dists = torch.full((b, l), BIG, dtype=torch.float32, device=dev)
    beam_dists[:, 0] = torch.where(has, d0, torch.full_like(d0, BIG))
    beam_exp = torch.zeros((b, l), dtype=torch.bool, device=dev)
    seen = torch.zeros((b, n), dtype=torch.bool, device=dev)
    seen[rows, clip_ids(start, n)] = has
    vis_ids = torch.full((b, max_visits), INVALID, dtype=torch.int32,
                         device=dev)
    vis_dists = torch.full((b, max_visits), BIG, dtype=torch.float32,
                           device=dev)
    n_vis = torch.zeros((b,), dtype=torch.int32, device=dev)
    n_comps = has.to(torch.int32)
    n_hops = torch.zeros((b,), dtype=torch.int32, device=dev)

    while True:
        frontier = (beam_ids >= 0) & ~beam_exp
        live = (frontier & torch.isfinite(beam_dists)).any(1) & \
            (n_hops < max_visits)
        if not bool(live.any()):
            break
        # --- pop each lane's closest unexpanded vertex (first minimum) ---
        frontier_d = torch.where(frontier, beam_dists,
                                 torch.full_like(beam_dists, BIG))
        i = torch.argmin(frontier_d, dim=1)
        v = beam_ids[rows, i]
        dv = beam_dists[rows, i]
        exp_new = beam_exp.clone()
        exp_new[rows, i] = True
        # --- visited list: returnable pops only; a full list drops it ----
        sv = clip_ids(v, n)
        v_ret = returnable[sv]
        slot = (cols[None, :] == n_vis[:, None]) & v_ret[:, None]
        vis_ids_new = torch.where(slot, v[:, None], vis_ids)
        vis_dists_new = torch.where(slot, dv[:, None], vis_dists)
        n_vis_new = n_vis + v_ret.to(torch.int32)
        # --- expand: one (B, R) distance tile ----------------------------
        nbrs = state.adj[sv]
        safe = clip_ids(nbrs, n)
        fresh = (nbrs >= 0) & nav[safe] & ~torch.gather(seen, 1, safe)
        masked = torch.where(fresh, nbrs, torch.full_like(nbrs, INVALID))
        nd = dist(masked)
        n_comps_new = n_comps + fresh.sum(1).to(torch.int32)
        # entries that are not fresh rewrite the popped vertex's bit, which
        # a live lane has set already (every beam id was marked when it
        # entered), so every write of the scatter is True
        seen_new = seen.scatter(1, torch.where(fresh, safe, sv[:, None]),
                                True)
        # --- stable sort-merge, keep top-l -------------------------------
        all_d = torch.cat([beam_dists, nd], dim=1)
        all_i = torch.cat([beam_ids, masked], dim=1)
        all_e = torch.cat([se_key(exp_new),
                           torch.zeros_like(masked)], dim=1)
        sd, order = torch.sort(all_d, dim=1, stable=True)
        order = order[:, :l]
        # --- the select: a lane that has ended keeps its whole carry -----
        lv = live[:, None]
        beam_ids = torch.where(lv, torch.gather(all_i, 1, order), beam_ids)
        beam_dists = torch.where(lv, sd[:, :l], beam_dists)
        beam_exp = torch.where(lv, torch.gather(all_e, 1, order).to(
            torch.bool), beam_exp)
        seen = torch.where(lv, seen_new, seen)
        vis_ids = torch.where(lv, vis_ids_new, vis_ids)
        vis_dists = torch.where(lv, vis_dists_new, vis_dists)
        n_vis = torch.where(live, n_vis_new, n_vis)
        n_comps = torch.where(live, n_comps_new, n_comps)
        n_hops = torch.where(live, n_hops + 1, n_hops)

    ids, dists = final_topk(beam_ids, beam_dists, returnable, n, k)
    return SearchResult(
        topk_ids=ids, topk_dists=dists, visited_ids=vis_ids,
        visited_dists=vis_dists, n_visited=n_vis, n_comps=n_comps,
        n_hops=n_hops,
    )


def _lift_distance_fn(distance_fn: DistanceFn):
    """A per-query ``distance_fn`` lifted to the batched signature, lane by
    lane (the reference lifts it with ``jax.vmap``)."""

    def batched_fn(state, cfg, queries, ids):
        return torch.stack([distance_fn(state, cfg, q, row)
                            for q, row in zip(queries, ids)])

    return batched_fn


def search_batch(state: GraphState, cfg: ANNConfig, queries: torch.Tensor,
                 *, k: int, l: int, distance_fn: Optional[DistanceFn] = None,
                 bucket: bool = True, max_visits: Optional[int] = None,
                 starts: Optional[torch.Tensor] = None) -> SearchResult:
    """Batched greedy search over a (B, dim) query batch through the shared
    hop loop of ``core/search_batched.py``.  With ``bucket`` (the default)
    B is padded to the next power of two with masked lanes, as the
    reference buckets it (a masked lane starts empty and costs no hops);
    the padding is sliced off.  ``distance_fn`` keeps the per-query
    signature and is lifted lane by lane; pass a batched one to
    ``batched_greedy_search`` directly.  ``starts`` (i32[B]) gives each
    query its own entry point."""
    from .search_batched import batched_greedy_search, pad_batch

    b = queries.shape[0]
    batched_fn = _lift_distance_fn(distance_fn) if distance_fn else None
    if bucket:
        qs = pad_batch(queries, b)
        valid = torch.arange(qs.shape[0], device=qs.device) < b
        if starts is not None:
            starts = pad_batch(starts.to(device=qs.device,
                                         dtype=torch.int32), b)
    else:
        qs, valid = queries, None
    res = batched_greedy_search(state, cfg, qs, k=k, l=l,
                                max_visits=max_visits, distance_fn=batched_fn,
                                valid=valid, starts=starts)
    if qs.shape[0] != b:
        res = SearchResult(*[x[:b] for x in res])
    return res
