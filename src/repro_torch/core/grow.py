"""Online capacity growth (``repro/core/grow.py``): rebuild the index into a
larger slot bucket.

``IndexState`` fixes ``n_cap`` at construction; rather than failing when a
stream exhausts its slots, ``StreamingIndex`` grows the state into the next
power-of-two capacity bucket when the live count would cross a high-water
mark.  ``grow_index`` pads every graph leaf (vectors, norms, adj, masks, the
quant store), the free stack and ``slot2ext`` into the new bucket and
returns a new handle; the input handle stays valid.  A stacked state
(``ShardedIndex``'s leading ``n_logical`` axis) grows row by row, in
lockstep, and is stacked again.  ``ext2slot``, the
counters, the entry point and all live rows are untouched, so searches see
the identical graph.

Free-stack order: the fresh slots ``[n_cap, new_cap)`` are pushed ABOVE the
surviving free entries in ascending-pop order, so after a grow allocation
pops ``n_cap, n_cap + 1, ...`` first, then whatever was free before — a
function of the input state alone, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .quant import QuantStore
from .types import (INVALID, ANNConfig, GraphState, IndexState,
                    stack_states, unstack_state)

# Grow when (live + incoming) would exceed this fraction of capacity: the
# graph needs free slots for in-flight quarantined rows, and growing before
# exhaustion keeps "capacity exhausted" for callers that disable growth.
HIGH_WATER = 0.9
_COUNTERS = ("n_inserts", "n_deletes", "insert_comps", "delete_comps")


def next_capacity(needed: int, n_cap: int,
                  high_water: float = HIGH_WATER) -> int:
    """The smallest power-of-two bucket >= ``n_cap`` whose high-water mark
    admits ``needed`` slots."""
    cap = 1 << max(n_cap - 1, 1).bit_length()
    while needed > high_water * cap:
        cap *= 2
    return cap


def _pad_rows(a: torch.Tensor, extra: int, fill) -> torch.Tensor:
    return torch.cat([a, torch.full((extra,) + tuple(a.shape[1:]), fill,
                                    dtype=a.dtype, device=a.device)])


def _grow_graph(g: GraphState, cfg: ANNConfig, new_cap: int) -> GraphState:
    extra = new_cap - cfg.n_cap
    # fresh slots land above the surviving free entries, popping in
    # ascending slot order (n_cap first)
    stack = _pad_rows(g.free_stack, extra, 0)
    top = int(g.free_top)
    stack[top:top + extra] = torch.arange(new_cap - 1, cfg.n_cap - 1, -1,
                                          dtype=torch.int32,
                                          device=stack.device)
    quant = g.quant
    if quant is not None:
        quant = QuantStore(
            codes=_pad_rows(quant.codes, extra, 0),
            scale=_pad_rows(quant.scale, extra, 1.0),
            qnorms=_pad_rows(quant.qnorms, extra, 0.0),
        )
    return g._replace(
        vectors=_pad_rows(g.vectors, extra, 0),
        norms=_pad_rows(g.norms, extra, 0.0),
        adj=_pad_rows(g.adj, extra, INVALID),
        active=_pad_rows(g.active, extra, False),
        tombstone=_pad_rows(g.tombstone, extra, False),
        quarantine=_pad_rows(g.quarantine, extra, False),
        free_stack=stack,
        free_top=g.free_top + extra,
        start=g.start.clone(),
        n_active=g.n_active.clone(),
        n_pending=g.n_pending.clone(),
        quant=quant,
    )


def grow_index(state: IndexState, cfg: ANNConfig,
               new_cap: int) -> Tuple[IndexState, ANNConfig]:
    """Rebuild ``state`` (single or stacked) into capacity ``new_cap`` >=
    ``cfg.n_cap``.  Returns ``(new_state, new_cfg)``; the input handle
    stays valid."""
    if new_cap < cfg.n_cap:
        raise ValueError(
            f"grow_index cannot shrink: {cfg.n_cap} -> {new_cap}"
        )
    new_cfg = dataclasses.replace(cfg, n_cap=new_cap)
    if new_cap == cfg.n_cap:
        return state, new_cfg
    if state.graph.vectors.dim() == 3:
        # a stacked (L, ...) state: every logical row grows in lockstep
        rows = [grow_index(row, cfg, new_cap)[0]
                for row in unstack_state(state)]
        return stack_states(rows), new_cfg
    # every leaf of the new handle is a new tensor: the port updates
    # handles in place, so sharing one would let updates of the grown
    # handle leak into the input handle
    state = IndexState(
        graph=_grow_graph(state.graph, cfg, new_cap),
        ext2slot=state.ext2slot.clone(),
        slot2ext=_pad_rows(state.slot2ext, new_cap - cfg.n_cap, INVALID),
        **{f: getattr(state, f).clone() for f in _COUNTERS},
    )
    return state, new_cfg


def needs_growth(state: IndexState, cfg: ANNConfig, incoming: int,
                 high_water: float = HIGH_WATER) -> bool:
    """Host-side trigger: would ``incoming`` more inserts push the live
    count past the high-water mark?  (A stacked state counts its fullest
    row, so every logical row grows in lockstep.)"""
    free = int(state.graph.free_top.min())
    return (cfg.n_cap - free) + incoming > high_water * cfg.n_cap


def ensure_capacity(state: IndexState, cfg: ANNConfig, incoming: int,
                    high_water: float = HIGH_WATER
                    ) -> Tuple[IndexState, ANNConfig, bool]:
    """Grow ``state`` (if needed) so ``incoming`` more inserts stay below
    the high-water mark.  Returns ``(state, cfg, grew)``."""
    if not needs_growth(state, cfg, incoming, high_water):
        return state, cfg, False
    needed = (cfg.n_cap - int(state.graph.free_top.min())) + incoming
    state, cfg = grow_index(state, cfg,
                            next_capacity(needed, cfg.n_cap, high_water))
    return state, cfg, True


__all__ = [
    "HIGH_WATER", "ensure_capacity", "grow_index", "needs_growth",
    "next_capacity",
]
