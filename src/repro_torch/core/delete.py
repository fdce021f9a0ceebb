"""Deletes (``repro/core/delete.py``): in-place deletion (Algorithm 5, the
``ip`` policy), the topology-aware localized repair of the ``local`` policy
and FreshDiskANN's lazy tombstone delete (the ``fresh`` policy).

Algorithm 5:

  1. GreedySearch(x_p, k, l_d) -> Visited, Candidates (top-k).
  2. Approximate in-neighbours N'_in = {z in Visited : p in N_out(z)}.
  3. For each z in N'_in: remove z -> p, add z -> the c candidates closest
     to x_z.
  4. For each w in N_out(p): add y -> w for the c candidates y closest to
     x_w.
  5. Quarantine p's slot until the Algorithm-6 sweep releases it.

The reference appends one edge at a time.  Appends to distinct rows commute
(``core/edges.py``), so step 3 runs as c rounds of one batched append (the
visited rows are distinct), and step 4 as waves: wave t applies every
row's t-th pending append, which keeps each row's own order.

``local_delete`` reads the exact in-neighbourhood off the adjacency, removes
every in-edge, reconnects the first ``resolved_local_in_cap()`` in-neighbours
(ascending slot order) to their c closest candidates of ``N_out(p)`` and
frees the slot at once.  Its z rows are distinct, so the reference's serial
appends run as c rounds of one batched append.  ``lazy_delete`` only flips
masks.  The state's tensors are updated in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import trace
from .backend import BIG, resolve_backend
from .edges import append_rows, remove_target_everywhere, remove_target_rows
from .search import greedy_search
from .types import INVALID, ANNConfig, GraphState, clip_ids, mask_duplicates


class DeleteStats(NamedTuple):
    ok: torch.Tensor       # bool  point existed and was removed
    n_comps: torch.Tensor  # i32
    n_in: torch.Tensor     # i32  approximated in-neighbours found


def _topc_candidates(state, cfg, src_ids, cand_ids, c):
    """For each source row, the c closest candidate ids (excluding itself),
    ties to the earlier candidate."""
    from ..kernels.ref import stable_topk_smallest

    d = resolve_backend(cfg, state.vectors.device).pair_dists_ids(
        state, cfg, src_ids, cand_ids)
    d = torch.where(cand_ids[None, :] == src_ids[:, None],
                    torch.full_like(d, BIG), d)
    vals, idx = stable_topk_smallest(d, c)
    chosen = cand_ids[idx]
    return torch.where(vals < BIG, chosen, torch.full_like(chosen, INVALID))


def _next_start(st: GraphState, cfg: ANNConfig, p, nout_p):
    """The entry point after deleting p (unchanged unless p is it)."""
    nav = st.active | st.tombstone
    nav[min(max(p, 0), cfg.n_cap - 1)] = False
    nbr_ok = (nout_p >= 0) & nav[clip_ids(nout_p, cfg.n_cap)]
    first_nbr = nout_p[torch.argmax(nbr_ok.to(torch.int8))]
    fallback = torch.argmax(nav.to(torch.int8)).to(torch.int32)
    replacement = torch.where(
        nbr_ok.any(), first_nbr,
        torch.where(nav.any(), fallback, INVALID)).to(torch.int32)
    return torch.where(st.start == p, replacement, st.start)


def repair_edges(st: GraphState, cfg: ANNConfig, p: int, vis, cands):
    """Steps 2-5 for slot ``p`` given its search's visited list and
    candidates (both with p masked out).  Returns the in-neighbour count."""
    with trace.span("repro_torch.update.repair"):
        sp = min(max(p, 0), cfg.n_cap - 1)
        nout_p = st.adj[sp].clone()
        vis_rows = st.adj[clip_ids(vis, cfg.n_cap)]
        in_mask = (vis_rows == p).any(1) & (vis >= 0)
        cz = _topc_candidates(st, cfg, vis, cands, cfg.n_copies)     # (V, c)
        remove_target_rows(st, cfg, torch.where(in_mask, vis, INVALID), p)
        zs = torch.where(in_mask, vis, torch.full_like(vis, INVALID))
        for j in range(cfg.n_copies):
            append_rows(st, cfg, zs, cz[:, j])
        cw = _topc_candidates(st, cfg, nout_p, cands, cfg.n_copies)  # (r, c)
        # (i, j) order per target row y = cw[i, j]; wave t = the row's t-th
        ys = cw.reshape(-1).cpu().tolist()
        ws = nout_p[:, None].expand(-1, cfg.n_copies).reshape(-1).cpu() \
            .tolist()
        waves, seen_count = [], {}
        for y, w in zip(ys, ws):
            if y < 0:
                continue
            t = seen_count.get(y, 0)
            seen_count[y] = t + 1
            if t == len(waves):
                waves.append(([], []))
            waves[t][0].append(y)
            waves[t][1].append(w)
        dev = st.adj.device
        for wy, ww in waves:
            append_rows(st, cfg,
                        torch.tensor(wy, dtype=torch.int32, device=dev),
                        torch.tensor(ww, dtype=torch.int32, device=dev))
        new_start = _next_start(st, cfg, p, nout_p)
        st.adj[sp] = INVALID
        st.active[sp] = False
        st.quarantine[sp] = True
        st.n_active.sub_(1)
        st.n_pending.add_(1)
        st.start.copy_(new_start)
        return in_mask.sum().to(torch.int32), nout_p


def ip_delete(state: GraphState, cfg: ANNConfig, p: int):
    """Delete slot ``p`` in place (Algorithm 5)."""
    dev = state.vectors.device
    if p < 0 or not bool(state.active[min(p, cfg.n_cap - 1)]):
        return state, _no_delete(dev)
    sp = min(p, cfg.n_cap - 1)
    res = greedy_search(state, cfg, state.vectors[sp].clone(),
                        k=cfg.k_delete, l=cfg.l_delete)
    vis = torch.where(res.visited_ids == p,
                      torch.full_like(res.visited_ids, INVALID),
                      res.visited_ids)
    cands = torch.where(res.topk_ids == p,
                        torch.full_like(res.topk_ids, INVALID), res.topk_ids)
    n_in, nout_p = repair_edges(state, cfg, p, vis, cands)
    extra = (res.n_visited + (nout_p >= 0).sum()) * cfg.k_delete
    return state, DeleteStats(torch.tensor(True, device=dev),
                              (res.n_comps + extra).to(torch.int32), n_in)


def _no_delete(dev) -> DeleteStats:
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return DeleteStats(torch.tensor(False, device=dev), zero, zero)


def _serial(delete_one, state: GraphState, cfg: ANNConfig, ps):
    """``delete_one`` lane by lane, each seeing every earlier write."""
    dev = state.vectors.device
    stats = []
    for p in ps.cpu().tolist():
        state, st = delete_one(state, cfg, int(p))
        stats.append(st)
    if not stats:
        z = torch.zeros((0,), dtype=torch.int32, device=dev)
        return state, DeleteStats(z.bool(), z, z)
    return state, DeleteStats(*(torch.stack(f) for f in zip(*stats)))


def ip_delete_many(state: GraphState, cfg: ANNConfig, ps: torch.Tensor):
    """Serial in-place deletes, each seeing every earlier write."""
    return _serial(ip_delete, state, cfg, ps)


# ---------------------------------------------------------------------------
# Topology-aware localized repair (the "local" policy)
# ---------------------------------------------------------------------------


def local_delete(state: GraphState, cfg: ANNConfig, p: int):
    """Delete slot ``p`` with localized repair: the exact in-neighbours
    (one (n_cap, r) compare), every ``z -> p`` removed, the first
    ``resolved_local_in_cap()`` in-neighbours in ascending slot order given
    edges to their c closest of ``N_out(p)``, and the slot released
    straight onto the free stack (no quarantine, no pending debt)."""
    dev = state.vectors.device
    if p < 0 or not bool(state.active[min(p, cfg.n_cap - 1)]):
        return state, _no_delete(dev)
    sp = min(p, cfg.n_cap - 1)
    b_in = min(cfg.resolved_local_in_cap(), cfg.n_cap)
    nout_p = state.adj[sp].clone()                 # local candidate set
    in_rows = (state.adj == p).any(1)
    in_rows[sp] = False
    z_all = torch.nonzero(in_rows).squeeze(1)      # ascending slot order
    n_in = torch.tensor(z_all.numel(), dtype=torch.int32, device=dev)
    z_ids = z_all[:b_in].to(torch.int32)
    remove_target_everywhere(state, cfg, p)
    if z_ids.numel():
        cz = _topc_candidates(state, cfg, z_ids, nout_p, cfg.n_copies)
        # the z rows are distinct: round j appends every z's j-th candidate
        for j in range(cfg.n_copies):
            append_rows(state, cfg, z_ids, cz[:, j])
    new_start = _next_start(state, cfg, p, nout_p)
    top = int(state.free_top)
    state.adj[sp] = INVALID
    state.active[sp] = False
    state.free_stack[top] = sp
    state.free_top.add_(1)
    state.n_active.sub_(1)
    state.start.copy_(new_start)
    comps = z_ids.numel() * int((nout_p >= 0).sum())
    return state, DeleteStats(torch.tensor(True, device=dev),
                              torch.tensor(comps, dtype=torch.int32,
                                           device=dev), n_in)


def local_delete_many(state: GraphState, cfg: ANNConfig, ps: torch.Tensor):
    """Serial localized deletes in both visibility modes: each lane's exact
    in-neighbour compare must see the previous lane's repairs."""
    return _serial(local_delete, state, cfg, ps)


# ---------------------------------------------------------------------------
# FreshDiskANN lazy delete (baseline)
# ---------------------------------------------------------------------------


def lazy_delete(state: GraphState, cfg: ANNConfig, p: int):
    """Tombstone ``p``: still navigable, no longer returnable."""
    state, st = lazy_delete_many(
        state, cfg, torch.tensor([p], dtype=torch.int32,
                                 device=state.vectors.device))
    return state, DeleteStats(*(f[0] for f in st))


def lazy_delete_many(state: GraphState, cfg: ANNConfig, ps: torch.Tensor):
    """The reference's serial scan of ``lazy_delete`` in one step: a lane
    deletes when its slot is live and no earlier lane names it."""
    dev = state.vectors.device
    ps = ps.to(torch.int32).reshape(-1)
    first = mask_duplicates(ps)
    ok = (first >= 0) & state.active[clip_ids(first, cfg.n_cap)]
    sel = clip_ids(ps[ok], cfg.n_cap)
    state.active[sel] = False
    state.tombstone[sel] = True
    n = ok.sum().to(torch.int32)
    state.n_active.sub_(n)
    state.n_pending.add_(n)
    zero = torch.zeros_like(ps)
    return state, DeleteStats(ok, zero, zero)
