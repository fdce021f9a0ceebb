"""Insert (Algorithm 2): greedy search -> RobustPrune -> reverse edges
(``repro/core/insert.py``).  Updates the state's tensors in place."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .edges import append_rows
from .prune import robust_prune
from .quant import quant_write_rows
from .search import greedy_search
from .types import INVALID, ANNConfig, GraphState


class InsertStats(NamedTuple):
    slot: torch.Tensor     # i32 slot assigned (INVALID: no capacity / masked)
    n_comps: torch.Tensor  # i32 distance computations
    n_hops: torch.Tensor   # i32


def _stats(slot, comps, hops, dev):
    return InsertStats(*(torch.tensor(v, dtype=torch.int32, device=dev)
                         for v in (slot, comps, hops)))


def insert(state: GraphState, cfg: ANNConfig, x: torch.Tensor):
    """Insert one vector; returns ``(state, InsertStats)``."""
    dev = state.vectors.device
    free_top = int(state.free_top)
    if free_top <= 0:
        return state, _stats(INVALID, 0, 0, dev)
    slot = int(state.free_stack[free_top - 1])
    x = x.to(state.vectors.dtype)
    state.vectors[slot] = x
    state.norms[slot] = torch.dot(x, x)
    if state.quant is not None:
        # keep the int8 tier in lockstep with the f32 write
        quant_write_rows(state.quant, torch.tensor([slot], device=dev),
                         x[None])
    state.free_top.sub_(1)
    state.n_active.add_(1)
    if int(state.start) < 0:
        state.adj[slot] = INVALID
        state.start.fill_(slot)
        state.active[slot] = True
        return state, _stats(slot, 0, 0, dev)
    res = greedy_search(state, cfg, x, k=1, l=cfg.l_build)
    nout = robust_prune(state, cfg, x, res.visited_ids, res.visited_dists,
                        p_id=slot)
    state.adj[slot] = nout
    state.active[slot] = True
    # the r reverse edges land in distinct rows: one set of appends
    append_rows(state, cfg, nout, torch.tensor(slot, device=dev))
    return state, InsertStats(
        torch.tensor(slot, dtype=torch.int32, device=dev), res.n_comps,
        res.n_hops)


def _stack(stats, dev) -> InsertStats:
    if not stats:
        return InsertStats(*(torch.zeros((0,), dtype=torch.int32, device=dev)
                             for _ in range(3)))
    return InsertStats(*(torch.stack(f) for f in zip(*stats)))


def insert_many(state: GraphState, cfg: ANNConfig, xs: torch.Tensor,
                valid: Optional[torch.Tensor] = None):
    """Serial (paper-faithful) inserts, each seeing every earlier write.
    ``valid`` masks no-op lanes."""
    dev = state.vectors.device
    ok = [True] * xs.shape[0] if valid is None else valid.cpu().tolist()
    stats = []
    for x, v in zip(xs, ok):
        if v:
            state, st = insert(state, cfg, x)
        else:
            st = _stats(INVALID, 0, 0, dev)
        stats.append(st)
    return state, _stack(stats, dev)
