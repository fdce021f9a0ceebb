"""Ground truth + Recall@k (``repro/core/recall.py``): the backend's exact
scan against the batched graph search."""
from __future__ import annotations

from typing import Optional

import numpy as np

from .backend import resolve_backend
from .types import ANNConfig, GraphState, IndexState


def _graph(state) -> GraphState:
    return state.graph if isinstance(state, IndexState) else state


def brute_force_topk(state, cfg: ANNConfig, queries, *, k: int):
    """Exact top-k over the live point set: ``(ids, dists)``."""
    g = _graph(state)
    return resolve_backend(cfg, g.vectors.device).brute_force_topk(
        g, cfg, queries, k=k
    )


def graph_recall(state, cfg: ANNConfig, queries, *, k: int,
                 l: Optional[int] = None) -> float:
    """Recall@k of the batched graph search against the exact oracle."""
    from .search import search_batch

    g = _graph(state)
    res = search_batch(g, cfg, queries, k=k, l=l or cfg.l_search)
    true_ids, _ = brute_force_topk(g, cfg, queries, k=k)
    return recall_at_k(res.topk_ids, true_ids, k)


def _np(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def recall_at_k(found_ids, true_ids, k: int) -> float:
    """Mean |G ∩ A| / k over the query batch (slot-id space)."""
    found = _np(found_ids)[:, :k]
    true = _np(true_ids)[:, :k]
    hits = 0
    for f, t in zip(found, true):
        t_set = set(int(x) for x in t if x >= 0)
        hits += len(t_set.intersection(int(x) for x in f if x >= 0))
    denom = max(1, sum(min(k, int((t >= 0).sum())) for t in true))
    return hits / denom
