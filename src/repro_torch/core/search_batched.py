"""Natively batched beam search: one shared hop loop for B queries
(``repro/core/search_batched.py``).

The carry is one (B, l) beam, one bitpacked int32[B, ceil(n_cap/32)] seen
bitmap (``core/bitset.py``), one (B, max_visits) visited list and per-lane
counters.  A lane whose frontier is exhausted is an exact no-op for further
hops, so hops group into super-steps of H (``ANNConfig.hop_fused``) without
changing any lane's traversal.  The reference's ``lax.while_loop`` is a
Python loop with one host read of ``any(active)`` per super-step.  The
``cuda`` engine binds the fused hop kernel once per search
(``DistanceBackend.bind_beam_superstep``): the navigable / returnable masks
are packed once (the state cannot change mid-search), the carry keeps an
int32 ``beam_exp`` and is updated in place, and each super-step is one
launch plus one host read of the status word in which the kernel reports
whether a lane is still active (and refuses an unsorted beam).  On the
quantized tier it also binds the int8 gather kernel once per search
(``DistanceBackend.bind_dists_to_ids_batched_q``): the start distance, and
every hop's (B, R) tile when no fused super-step runs (H = 0).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from . import bitset
from .backend import BIG, resolve_backend
from .search import SearchResult, final_topk
from .types import INVALID, ANNConfig, GraphState, clip_ids, navigable

DEFAULT_FUSED_HOPS = 4


class _BLoop(NamedTuple):
    beam_ids: torch.Tensor    # i32[B, l]
    beam_dists: torch.Tensor  # f32[B, l]
    beam_exp: torch.Tensor    # bool[B, l]
    seen: torch.Tensor        # i32[B, ceil(n_cap/32)]  bitpacked
    vis_ids: torch.Tensor     # i32[B, max_visits]
    vis_dists: torch.Tensor   # f32[B, max_visits]
    n_vis: torch.Tensor       # i32[B]
    n_comps: torch.Tensor     # i32[B]
    n_hops: torch.Tensor      # i32[B]


BatchedDistanceFn = Callable[
    [GraphState, ANNConfig, torch.Tensor, torch.Tensor], torch.Tensor
]


def next_bucket(b: int) -> int:
    """The batch-size bucket for ``b``: the next power of two (>= 1)."""
    p = 1
    while p < b:
        p *= 2
    return p


def pad_batch(arr: torch.Tensor, b: int, fill=None) -> torch.Tensor:
    """Pad the leading axis up to the bucket for ``b`` lanes (INVALID for
    integer payloads, False for bools, 0.0 for floats by default)."""
    bucket = next_bucket(b)
    if arr.shape[0] == bucket:
        return arr
    if fill is None:
        if arr.dtype == torch.bool:
            fill = False
        elif arr.dtype.is_floating_point:
            fill = 0.0
        else:
            fill = INVALID
    pad = torch.full((bucket - arr.shape[0],) + tuple(arr.shape[1:]), fill,
                     dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad])


def resolved_hop_fused(cfg: ANNConfig, device) -> int:
    """Hops per super-step: ``cfg.hop_fused`` when pinned, else
    ``DEFAULT_FUSED_HOPS`` exactly where the ``cuda`` engine resolves."""
    if cfg.hop_fused >= 0:
        return cfg.hop_fused
    return DEFAULT_FUSED_HOPS if resolve_backend(cfg, device).name == "cuda" \
        else 0


def lane_active(s: _BLoop, max_visits: int) -> torch.Tensor:
    frontier = (s.beam_ids >= 0) & ~s.beam_exp & torch.isfinite(s.beam_dists)
    return frontier.any(1) & (s.n_hops < max_visits)


def make_hop_body(state: GraphState, cfg: ANNConfig, queries: torch.Tensor,
                  dist_fn: BatchedDistanceFn, *, l: int, max_visits: int):
    """The shared per-hop transition ``_BLoop -> _BLoop``; an inactive lane
    is an exact no-op."""
    nav = navigable(state)
    returnable = state.active
    b = queries.shape[0]
    bidx = torch.arange(b, device=queries.device)

    def hop(s: _BLoop) -> _BLoop:
        active = lane_active(s, max_visits)
        # --- pop each lane's closest unexpanded vertex --------------------
        frontier_d = torch.where((s.beam_ids >= 0) & ~s.beam_exp,
                                 s.beam_dists,
                                 torch.full_like(s.beam_dists, BIG))
        i = torch.argmin(frontier_d, dim=1)
        v = s.beam_ids[bidx, i]
        dv = s.beam_dists[bidx, i]
        beam_exp = s.beam_exp.clone()
        beam_exp[bidx, i] = beam_exp[bidx, i] | active
        # --- visited list (returnable pops of active lanes) ---------------
        sv = clip_ids(v, cfg.n_cap)
        write = active & returnable[sv]
        vis_ids, vis_dists = s.vis_ids.clone(), s.vis_dists.clone()
        wl = bidx[write]
        wc = s.n_vis[write].long()
        vis_ids[wl, wc] = v[write]
        vis_dists[wl, wc] = dv[write]
        n_vis = s.n_vis + write.to(torch.int32)
        # --- expand: one (B, R) frontier-neighbourhood tile ---------------
        nbrs = state.adj[sv]
        safe = clip_ids(nbrs, cfg.n_cap)
        fresh = (nbrs >= 0) & nav[safe] & \
            ~bitset.getbit_rows(s.seen, safe) & active[:, None]
        masked = torch.where(fresh, nbrs, torch.full_like(nbrs, INVALID))
        nd = dist_fn(state, cfg, queries, masked)
        n_comps = s.n_comps + fresh.sum(1).to(torch.int32)
        seen = bitset.setbits_rows(s.seen, safe, fresh)
        # --- stable sort-merge of (id << 1 | exp) payloads, keep top-l ----
        all_d = torch.cat([s.beam_dists, nd], dim=1)
        all_p = torch.cat([(s.beam_ids << 1) | beam_exp.to(torch.int32),
                           masked << 1], dim=1)
        sd, order = torch.sort(all_d, dim=1, stable=True)
        sp = torch.gather(all_p, 1, order[:, :l])
        return _BLoop(
            beam_ids=sp >> 1,
            beam_dists=sd[:, :l].contiguous(),
            beam_exp=(sp & 1).to(torch.bool),
            seen=seen,
            vis_ids=vis_ids,
            vis_dists=vis_dists,
            n_vis=n_vis,
            n_comps=n_comps,
            n_hops=s.n_hops + active.to(torch.int32),
        )

    return hop


def superstep_reference(dist_fn: BatchedDistanceFn, state: GraphState,
                        cfg: ANNConfig, queries: torch.Tensor, carry: _BLoop,
                        *, h: int, l: int, max_visits: int) -> _BLoop:
    """Exactly ``h`` compositions of the shared hop body."""
    hop = make_hop_body(state, cfg, queries, dist_fn, l=l,
                        max_visits=max_visits)
    for _ in range(h):
        carry = hop(carry)
    return carry


class PlainSuperstep:
    """A super-step as a function ``carry -> carry``, with ``lane_active``
    on the carry it returned as the stop test: the loop's hop body, and the
    fused super-step of an engine without a bound kernel."""

    def __init__(self, body: Callable[[_BLoop], _BLoop], carry: _BLoop,
                 max_visits: int):
        self.carry = carry
        self._body = body
        self._max_visits = max_visits

    def __call__(self, carry: _BLoop) -> _BLoop:
        self.carry = self._body(carry)
        return self.carry

    def active(self) -> bool:
        """Whether a lane is still active after the last call."""
        return bool(lane_active(self.carry, self._max_visits).any())


def batched_greedy_search(state: GraphState, cfg: ANNConfig,
                          queries: torch.Tensor, *, k: int, l: int,
                          max_visits: Optional[int] = None,
                          distance_fn: Optional[BatchedDistanceFn] = None,
                          valid: Optional[torch.Tensor] = None,
                          starts: Optional[torch.Tensor] = None
                          ) -> SearchResult:
    """GreedySearch (Algorithm 1) for B queries in one shared hop loop.
    ``valid`` (bool[B]) masks whole lanes out: a masked lane starts with an
    empty beam and returns all-INVALID results.  ``starts`` (i32[B]) gives
    each lane its own entry point (default: the state's ``start`` for
    all); each lane then traverses exactly as ``greedy_search`` from its
    start (HNSW's per-query descent).

    When ``cfg.quantized`` is set and the state carries a quant store, the
    hops traverse on int8 traversal-tier distances
    (``dists_to_ids_batched_q``, bound once per search through
    ``bind_dists_to_ids_batched_q``), the surviving beam is rescored exactly
    against the f32 table (adding its returnable entries to ``n_comps``),
    and ``topk_dists`` are recomputed on exactly the returned ids."""
    if max_visits is None:
        max_visits = cfg.max_visits(l)
    dev = state.vectors.device
    backend = resolve_backend(cfg, dev)
    # an explicit distance_fn override wins over the quantized tier
    use_q = cfg.quantized and state.quant is not None and distance_fn is None
    queries = queries.to(torch.float32).contiguous()
    if use_q:
        # the int8 distances bound once per search: the start's, and every
        # hop's when no fused super-step runs (H = 0)
        bound_q = backend.bind_dists_to_ids_batched_q(state, cfg, queries)

        def dist_fn(_state, _cfg, _queries, ids):
            return bound_q(ids)
    else:
        dist_fn = distance_fn or backend.dists_to_ids_batched

    b = queries.shape[0]
    if starts is None:
        starts = state.start.reshape(1).expand(b).to(torch.int32)
    else:
        starts = starts.to(device=dev, dtype=torch.int32).reshape(b)
    if valid is not None:
        starts = torch.where(valid, starts, torch.full_like(starts, INVALID))
    d0 = dist_fn(state, cfg, queries, starts[:, None].contiguous())[:, 0]
    beam_ids = torch.full((b, l), INVALID, dtype=torch.int32, device=dev)
    beam_ids[:, 0] = starts
    beam_dists = torch.full((b, l), BIG, dtype=torch.float32, device=dev)
    beam_dists[:, 0] = torch.where(starts >= 0, d0,
                                   torch.full_like(d0, BIG))
    seen = bitset.setbits_rows(
        bitset.empty_rows(b, cfg.n_cap, dev),
        clip_ids(starts, cfg.n_cap)[:, None], (starts >= 0)[:, None],
    )
    s = _BLoop(
        beam_ids=beam_ids,
        beam_dists=beam_dists,
        beam_exp=torch.zeros((b, l), dtype=torch.bool, device=dev),
        seen=seen,
        vis_ids=torch.full((b, max_visits), INVALID, dtype=torch.int32,
                           device=dev),
        vis_dists=torch.full((b, max_visits), BIG, dtype=torch.float32,
                             device=dev),
        n_vis=torch.zeros((b,), dtype=torch.int32, device=dev),
        n_comps=(starts >= 0).to(torch.int32),
        n_hops=torch.zeros((b,), dtype=torch.int32, device=dev),
    )

    h = resolved_hop_fused(cfg, dev)
    if h <= 0:
        step = PlainSuperstep(make_hop_body(state, cfg, queries, dist_fn,
                                            l=l, max_visits=max_visits),
                              s, max_visits)
    elif distance_fn is not None:
        step = PlainSuperstep(
            lambda c: superstep_reference(dist_fn, state, cfg, queries, c,
                                          h=h, l=l, max_visits=max_visits),
            s, max_visits)
    else:
        step = backend.bind_beam_superstep(state, cfg, queries, s, h=h,
                                           quantized=use_q)
    carry = step.carry
    go = bool(lane_active(s, max_visits).any())
    while go:
        carry = step(carry)
        go = step.active()
    s = carry._replace(beam_exp=carry.beam_exp.to(torch.bool))

    if use_q:
        # exact rescore: re-rank the surviving beam against the f32 table,
        # so neither the selection nor the reported distances carry
        # quantization error
        ret = state.active[clip_ids(s.beam_ids, cfg.n_cap)] & \
            (s.beam_ids >= 0)
        beam_d = backend.dists_to_ids_batched(
            state, cfg, queries,
            torch.where(ret, s.beam_ids, torch.full_like(s.beam_ids,
                                                         INVALID)))
        s = s._replace(beam_dists=beam_d,
                       n_comps=s.n_comps + ret.sum(1).to(torch.int32))
    ids, dists = final_topk(s.beam_ids, s.beam_dists, state.active,
                            cfg.n_cap, k)
    if use_q:
        # recomputed on exactly the returned ids: bit-equal to a caller's
        # f32 rescore of those ids
        dists = backend.dists_to_ids_batched(state, cfg, queries, ids)
    return SearchResult(
        topk_ids=ids, topk_dists=dists, visited_ids=s.vis_ids,
        visited_dists=s.vis_dists, n_visited=s.n_vis, n_comps=s.n_comps,
        n_hops=s.n_hops,
    )


def merge_topk(dists_a, dists_b, k: int, *payload_pairs):
    """Merge two per-lane candidate sets into the k best by distance, ties
    to the earlier position (``lax.top_k`` on the concatenation); every
    ``(payload_a, payload_b)`` pair rides the same permutation."""
    from ..kernels.ref import stable_topk_smallest

    d = torch.cat([dists_a, dists_b], dim=-1)
    top_d, idx = stable_topk_smallest(d, k)
    outs = tuple(torch.gather(torch.cat([pa, pb], dim=-1), -1, idx)
                 for pa, pb in payload_pairs)
    return top_d, outs


__all__ = [
    "DEFAULT_FUSED_HOPS", "PlainSuperstep", "batched_greedy_search",
    "lane_active", "make_hop_body", "merge_topk", "next_bucket", "pad_batch",
    "resolved_hop_fused", "superstep_reference",
]
