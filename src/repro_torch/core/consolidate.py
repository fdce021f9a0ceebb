"""Algorithm 6, the light consolidation sweep (``repro/core/consolidate.py``):
strip dangling edges to quarantined slots and release those slots to the
free stack.  No distance computations."""
from __future__ import annotations

import torch

from .types import INVALID, ANNConfig, GraphState, clip_ids, compact_row


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
