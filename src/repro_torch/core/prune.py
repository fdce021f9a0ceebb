"""RobustPrune (Algorithm 3) with fixed-shape masked iteration
(``repro/core/prune.py``).

The candidate set is a fixed-width id vector (INVALID padded); ``r``
selection steps each take the closest remaining candidate and occlude the
candidates u with ``alpha * d(u, v) <= d(u, p)``.  ``robust_prune_rows``
runs the same steps for M independent rows at once.  The occlusion
distances are the reference's per-step expression
``(||x_v||^2 + ||x_u||^2) - 2<x_u, x_v>`` in one of two formulations: for
an insert's candidate set (C up to ``WIDE_PRUNE_C``) one batched (M, C, C)
pair matrix computed up front; for wider sets (Alg 4's splice, C = r + r^2;
HNSW's replace repair, C = m0 + m0^2) one (M, C) row of ``d(x_v, .)`` per
selection step, as the reference computes it, so that memory stays at the
gathered (M, C, D) rows.  Both give the same rows (bitwise on grid data).
The selection steps themselves are ``kernels/robust_prune.py``'s: on CUDA
tensors the narrow formulation is one launch of kernel 7, with no host
read; on CPU tensors, and for wider sets, the plain per-step loop.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import trace
from ..kernels.robust_prune import (MAX_C, robust_prune_select,
                                    robust_prune_select_plain)
from .backend import BIG, resolve_backend
from .types import INVALID, ANNConfig, GraphState, clip_ids, mask_duplicates

# candidate width above which the occlusion distances are computed one
# (M, C) row per selection step instead of as one (M, C, C) matrix
WIDE_PRUNE_C = MAX_C


def robust_prune_rows(state: GraphState, cfg: ANNConfig, p_vecs, cand_ids,
                      cand_dists=None, p_ids=None) -> torch.Tensor:
    """Select <= r out-neighbours for each of M points.

    ``p_vecs`` f32[M, D]; ``cand_ids`` i32[M, C] (INVALID padded,
    duplicates ok); ``cand_dists`` optional f32[M, C] distances to p
    (recomputed where not finite); ``p_ids`` optional i32[M] slot of p,
    excluded from its candidates.  Returns front-compacted i32[M, r] rows in
    selection order."""
    with trace.span("repro_torch.update.prune"):
        dev = cand_ids.device
        m, c = cand_ids.shape
        ids = mask_duplicates(cand_ids.to(torch.int32))
        if p_ids is not None:
            ids = torch.where(ids == p_ids[:, None],
                              torch.full_like(ids, INVALID), ids)
        safe = clip_ids(ids, cfg.n_cap)
        live = state.active[safe] | state.tombstone[safe]
        ids = torch.where((ids >= 0) & live, ids,
                          torch.full_like(ids, INVALID))
        safe = clip_ids(ids, cfg.n_cap)

        be = resolve_backend(cfg, dev)
        p_vecs = p_vecs.to(torch.float32)
        cand_vecs = state.vectors[safe]                          # (M, C, D)
        cand_norms = state.norms[safe]                           # (M, C)
        p_norm = be.query_norm(cfg, p_vecs)                      # (M,)
        prod = torch.bmm(cand_vecs, p_vecs.unsqueeze(-1)).squeeze(-1)
        d_p = (p_norm[:, None] + cand_norms - 2.0 * prod
               if cfg.metric == "l2" else -prod)
        if cand_dists is not None:
            d_p = torch.where(torch.isfinite(cand_dists), cand_dists, d_p)
        d_p = torch.where(ids >= 0, d_p, torch.full_like(d_p, BIG))
        if c > WIDE_PRUNE_C:
            rows_m = torch.arange(m, device=dev)

            def pair(j):
                # one (M, C) row: d(x_j, x_u) for this step's x_j
                return be.pair_dists(cfg, cand_vecs[rows_m, j][:, None],
                                     cand_norms.gather(1, j[:, None]),
                                     cand_vecs, cand_norms)[:, 0]

            return robust_prune_select_plain(ids, d_p, pair, cfg.alpha,
                                             cfg.r)
        # pair[m, j, u] = d(x_j, x_u)
        pair = be.pair_dists(cfg, cand_vecs, cand_norms, cand_vecs,
                             cand_norms)
        return robust_prune_select(ids, d_p, pair, cfg.alpha, cfg.r)


def robust_prune(state: GraphState, cfg: ANNConfig, p_vec, cand_ids,
                 cand_dists: Optional[torch.Tensor] = None,
                 p_id=None) -> torch.Tensor:
    """Algorithm 3 for one point: a front-compacted i32[r] row."""
    return robust_prune_rows(
        state, cfg, p_vec[None], cand_ids[None],
        None if cand_dists is None else cand_dists[None],
        None if p_id is None else torch.as_tensor(
            p_id, dtype=torch.int32, device=cand_ids.device).reshape(1),
    )[0]
