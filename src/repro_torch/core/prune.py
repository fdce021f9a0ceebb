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
Once no row has a live candidate the remaining steps are no-ops, so the
loop stops there (checked every ``_CHECK_EVERY`` steps: one host read
each).
"""
from __future__ import annotations

from typing import Optional

import torch

from .backend import BIG, resolve_backend
from .types import (INVALID, ANNConfig, GraphState, clip_ids, compact_row,
                    mask_duplicates)

_CHECK_EVERY = 8
# candidate width above which the occlusion distances are computed one
# (M, C) row per selection step instead of as one (M, C, C) matrix
WIDE_PRUNE_C = 512


def robust_prune_rows(state: GraphState, cfg: ANNConfig, p_vecs, cand_ids,
                      cand_dists=None, p_ids=None) -> torch.Tensor:
    """Select <= r out-neighbours for each of M points.

    ``p_vecs`` f32[M, D]; ``cand_ids`` i32[M, C] (INVALID padded,
    duplicates ok); ``cand_dists`` optional f32[M, C] distances to p
    (recomputed where not finite); ``p_ids`` optional i32[M] slot of p,
    excluded from its candidates.  Returns front-compacted i32[M, r] rows in
    selection order."""
    dev = cand_ids.device
    m, c = cand_ids.shape
    ids = mask_duplicates(cand_ids.to(torch.int32))
    if p_ids is not None:
        ids = torch.where(ids == p_ids[:, None], torch.full_like(ids, INVALID),
                          ids)
    safe = clip_ids(ids, cfg.n_cap)
    live = state.active[safe] | state.tombstone[safe]
    ids = torch.where((ids >= 0) & live, ids, torch.full_like(ids, INVALID))
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
    big = torch.full_like(d_p, BIG)
    d_p = torch.where(ids >= 0, d_p, big)
    wide = c > WIDE_PRUNE_C
    if not wide:
        # adv[m, j, u] = alpha * d(x_u, x_j), x_j the selected candidate
        adv = alpha_times(cfg, be.pair_dists(cfg, cand_vecs, cand_norms,
                                             cand_vecs, cand_norms))
    rows_m = torch.arange(m, device=dev)
    alive = ids >= 0
    # selection order per row, INVALID where a step selects nothing; a
    # stable compaction at the end is the reference's ``out[n_out]`` writes
    sel = torch.full((m, cfg.r), INVALID, dtype=torch.int32, device=dev)
    none = torch.full((m,), INVALID, dtype=torch.int32, device=dev)
    for step in range(cfg.r):
        if step % _CHECK_EVERY == 0 and not bool(alive.any()):
            break
        # first minimum over the live candidates; a row with none left
        # gets +inf (every live candidate has a finite distance to p)
        val, j = torch.where(alive, d_p, big).min(dim=1)
        ok = val < BIG
        jj = j[:, None]
        sel[:, step] = torch.where(ok, ids.gather(1, jj)[:, 0], none)
        if wide:
            # one (M, C) row: alpha * d(x_u, x_j) for this step's x_j
            keep = alpha_times(cfg, be.pair_dists(
                cfg, cand_vecs[rows_m, j][:, None], cand_norms.gather(1, jj),
                cand_vecs, cand_norms))[:, 0]
        else:
            keep = torch.gather(adv, 1,
                                jj[:, :, None].expand(-1, 1, c))[:, 0]
        alive &= (keep > d_p) | ~ok[:, None]
        alive.scatter_(1, jj, False)
    return compact_row(sel)


def alpha_times(cfg: ANNConfig, d: torch.Tensor) -> torch.Tensor:
    """``cfg.alpha * d`` in float32 (alpha rounded to float32 first, as the
    reference's weakly typed scalar)."""
    return torch.tensor(cfg.alpha, dtype=torch.float32, device=d.device) * d


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
