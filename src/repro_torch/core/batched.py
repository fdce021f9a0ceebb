"""Batched update processing (``repro/core/batched.py``): every lane's search
runs in one shared hop loop against the pre-batch graph (the paper's
relaxed visibility), then the graph writes apply lane by lane.  The write
phase is a Python loop here; its cost per lane is reported by the chip
smoke run.  The state's tensors are updated in place."""
from __future__ import annotations

import time
from typing import Optional

import torch

from .delete import DeleteStats, repair_edges
from .edges import append_rows
from .insert import InsertStats
from .prune import robust_prune
from .quant import quant_write_rows
from .search_batched import batched_greedy_search
from .types import INVALID, ANNConfig, GraphState, clip_ids

# wall seconds spent in the search and write phases of the batched updates,
# read at device-synchronised phase boundaries (one sync per phase)
PHASE_SECONDS = {"search": 0.0, "write": 0.0}


def _now(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def insert_many_batched(state: GraphState, cfg: ANNConfig, xs: torch.Tensor,
                        valid: Optional[torch.Tensor] = None):
    """Batched inserts: batched-engine searches, serial writes.  ``valid``
    masks no-op lanes."""
    dev = state.vectors.device
    b = xs.shape[0]
    if valid is None:
        valid = torch.ones((b,), dtype=torch.bool, device=dev)
    valid = valid.to(dev)
    # phase 0: allocate slots (consecutive stack entries, earliest lanes
    # lose out when capacity runs short) and write vectors; the slots stay
    # inactive, so the searches cannot find them.  A masked lane after the
    # last valid one points at ``free_top`` itself (``n_cap`` on an empty
    # index): the pop index is clamped into the stack as the reference's
    # gather clamps it, and only ``ok`` lanes write
    vi = valid.to(torch.int32)
    rank = torch.cumsum(vi, 0) - vi
    idxs = state.free_top - vi.sum() + rank
    ok = valid & (idxs >= 0)
    slots = torch.where(ok, state.free_stack[clip_ids(idxs, cfg.n_cap)],
                        torch.full_like(idxs, INVALID)).to(torch.int32)
    xs_f = xs.to(state.vectors.dtype)
    ok_l = ok.cpu().tolist()
    slots_l = slots.cpu().tolist()
    w = torch.nonzero(ok).squeeze(1)
    sw = slots[w].long()
    state.vectors[sw] = xs_f[w]
    state.norms[sw] = (xs_f[w] * xs_f[w]).sum(1)
    if state.quant is not None:
        # the int8 tier too, so the phase-1 searches (which traverse on
        # quantized distances) see a consistent code table
        quant_write_rows(state.quant, sw, xs_f[w])

    # phase 1: one shared-hop-loop search for every lane
    t0 = _now(dev)
    res = batched_greedy_search(state, cfg, xs_f, k=1, l=cfg.l_build,
                                valid=valid)
    t1 = _now(dev)

    # phase 2: serial link application
    for lane in range(b):
        if not ok_l[lane]:
            continue
        slot = slots_l[lane]
        nout = robust_prune(state, cfg, xs_f[lane], res.visited_ids[lane],
                            res.visited_dists[lane], p_id=slot)
        state.adj[slot] = nout
        state.active[slot] = True
        state.n_active.add_(1)
        state.free_top.sub_(1)
        if int(state.start) < 0:
            state.start.fill_(slot)
        append_rows(state, cfg, nout, torch.tensor(slot, device=dev))
    PHASE_SECONDS["search"] += t1 - t0
    PHASE_SECONDS["write"] += _now(dev) - t1
    stats = InsertStats(slot=slots, n_comps=res.n_comps,
                        n_hops=torch.zeros_like(res.n_comps))
    return state, stats


def ip_delete_many_batched(state: GraphState, cfg: ANNConfig,
                           ps: torch.Tensor):
    """Batched in-place deletes: batched-engine searches, serial repair."""
    ps = ps.to(torch.int32)
    sps = clip_ids(ps, cfg.n_cap)
    valid = (ps >= 0) & state.active[sps]
    x_ps = state.vectors[sps]
    dev = ps.device
    t0 = _now(dev)
    res = batched_greedy_search(state, cfg, x_ps, k=cfg.k_delete,
                                l=cfg.l_delete, valid=valid)
    inv = torch.full_like(res.visited_ids, INVALID)
    vis_b = torch.where(res.visited_ids == ps[:, None], inv, res.visited_ids)
    cands_b = torch.where(res.topk_ids == ps[:, None],
                          torch.full_like(res.topk_ids, INVALID),
                          res.topk_ids)
    t1 = _now(dev)
    for lane, (p, ok) in enumerate(zip(ps.cpu().tolist(),
                                       valid.cpu().tolist())):
        if ok:
            repair_edges(state, cfg, p, vis_b[lane], cands_b[lane])
    PHASE_SECONDS["search"] += t1 - t0
    PHASE_SECONDS["write"] += _now(dev) - t1
    stats = DeleteStats(ok=valid, n_comps=res.n_comps,
                        n_in=torch.zeros_like(res.n_comps))
    return state, stats
