"""Plain PyTorch oracles of the kernels (``repro/kernels/ref.py``)."""
from __future__ import annotations

import torch

INF = float("inf")


def stable_topk_smallest(d: torch.Tensor, k: int):
    """The k smallest along the last axis, ties to the lower index — the
    order ``lax.top_k(-d, k)`` gives.  ``torch.topk`` promises no tie order,
    so this is a stable sort, sliced."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def gather_distance_ref(ids, query, vectors, *, metric: str = "l2"):
    """f32[K] distances from ``query`` to ``vectors[ids]``; +inf where
    ids < 0.  Recomputes ||x||^2 from the rows."""
    safe = ids.clamp(0, vectors.shape[0] - 1).long()
    rows = vectors[safe]
    prod = rows @ query
    if metric == "l2":
        d = torch.dot(query, query) + (rows * rows).sum(1) - 2.0 * prod
    else:
        d = -prod
    return torch.where(ids >= 0, d, torch.full_like(d, INF))


def gather_distance_batched_ref(ids, queries, vectors, *,
                                metric: str = "l2"):
    """f32[B, K]: the per-query oracle on every lane."""
    safe = ids.clamp(0, vectors.shape[0] - 1).long()
    rows = vectors[safe]                                   # (B, K, D)
    prod = torch.bmm(rows, queries.unsqueeze(-1)).squeeze(-1)
    if metric == "l2":
        d = ((queries * queries).sum(1, keepdim=True)
             + (rows * rows).sum(-1) - 2.0 * prod)
    else:
        d = -prod
    return torch.where(ids >= 0, d, torch.full_like(d, INF))


def quant_gather_distance_batched_ref(ids, queries, codes, scales, qnorms,
                                      *, metric: str = "l2"):
    """f32[B, K] quantized-tier distances: the raw int8 dot accumulated in
    f32, the per-row scale applied to the product, the cached qnorms as the
    l2 norm term; +inf where ids < 0."""
    queries = queries.to(torch.float32)
    safe = ids.clamp(0, codes.shape[0] - 1).long()
    rows = codes[safe].to(torch.float32)                   # (B, K, D)
    raw = torch.bmm(rows, queries.unsqueeze(-1)).squeeze(-1)
    prod = raw * scales[safe]
    if metric == "l2":
        d = (queries * queries).sum(1, keepdim=True) + qnorms[safe] \
            - 2.0 * prod
    else:
        d = -prod
    return torch.where(ids >= 0, d, torch.full_like(d, INF))


def topk_score_ref(queries, vectors, norms, bias=None, *, k: int,
                   metric: str = "l2"):
    """(dists f32[B, k], ids i32[B, k]) ascending by distance, ties to the
    lower row.  ``bias``: optional f32[N] additive row bias (+inf excludes
    the row)."""
    prod = queries @ vectors.T                             # (B, N)
    if metric == "l2":
        q2 = (queries * queries).sum(1)
        d = q2[:, None] + norms[None, :] - 2.0 * prod
    else:
        d = -prod
    if bias is not None:
        d = d + bias[None, :]
    vals, idx = stable_topk_smallest(d, k)
    return vals, idx.to(torch.int32)
