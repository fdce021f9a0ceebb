"""Plain distance math of the ``torch`` engine (``repro/core/distance.py``).

Both metrics are "smaller = closer": squared L2 as
``||q||^2 + ||x||^2 - 2 <q, x>`` in that association, with ``||x||^2`` read
from ``GraphState.norms``, or ``-<q, x>`` for inner product.  Engine code goes
through ``core/backend.py``; only the backend imports this module.
"""
from __future__ import annotations

import torch

from .types import ANNConfig, GraphState, clip_ids

BIG = float("inf")


def dists_from_rows(metric: str, q, q_norm, rows, row_norms):
    """Distance from ``q`` (D,) to ``rows`` (M, D).  No validity masking."""
    prod = rows @ q
    if metric == "l2":
        return q_norm + row_norms - 2.0 * prod
    return -prod


def dists_to_ids(state: GraphState, cfg: ANNConfig, q, ids):
    """f32[M] distances from ``q`` to slots ``ids``; inf where INVALID."""
    safe = clip_ids(ids, cfg.n_cap)
    rows = state.vectors[safe]
    q_norm = torch.dot(q, q) if cfg.metric == "l2" else 0.0
    d = dists_from_rows(cfg.metric, q, q_norm, rows, state.norms[safe])
    return torch.where(ids >= 0, d, torch.full_like(d, BIG))


def pair_dists(metric: str, a_vecs, a_norms, b_vecs, b_norms):
    """(..., A, B) distance matrix between two point sets (no masking);
    leading batch axes broadcast."""
    prod = a_vecs @ b_vecs.transpose(-1, -2)
    if metric == "l2":
        return a_norms.unsqueeze(-1) + b_norms.unsqueeze(-2) - 2.0 * prod
    return -prod
