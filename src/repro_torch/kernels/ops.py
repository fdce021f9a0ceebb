"""Public wrappers around the hand-written kernels (``repro/kernels/ops.py``)
and their launch counters.

Each wrapper takes the kernel's plain PyTorch version for CPU tensors and
launches the CUDA kernel for CUDA tensors; nothing falls back.
"""
from __future__ import annotations

from . import beam_hop as _beam_hop
from . import gather_distance as _gather
from . import quant_gather as _quant
from . import ref
from . import robust_prune as _prune
from . import topk_score as _topk

_COUNTERS = (_gather.LAUNCHES, _beam_hop.LAUNCHES, _topk.LAUNCHES,
             _quant.LAUNCHES, _prune.LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches by name since the last ``reset_launch_counts``."""
    out = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for key in c:
            c[key] = 0


def gather_distances(ids, query, vectors, norms=None, *, metric="l2"):
    """Fused gather + distance for one query over K ids."""
    return _gather.gather_distance(ids, query, vectors, norms, metric=metric)


def gather_distances_batched(ids, queries, vectors, norms=None, *,
                             metric="l2"):
    """Fused gather + distance over a (B, K) id tile."""
    return _gather.gather_distance_batched(ids, queries, vectors, norms,
                                           metric=metric)


def beam_hop(queries, beam_ids, beam_dists, beam_exp, seen, vis_ids,
             vis_dists, n_vis, n_comps, n_hops, adj, vectors, norms,
             nav_words, ret_words, *, metric="l2", h=4):
    """Fused multi-hop beam super-step (the CUDA launch updates the carry in
    place); returns the carry tuple."""
    return _beam_hop.beam_hop_fused(
        queries, beam_ids, beam_dists, beam_exp, seen, vis_ids, vis_dists,
        n_vis, n_comps, n_hops, adj, vectors, norms, nav_words, ret_words,
        metric=metric, h=h,
    )


def gather_distances_batched_q(ids, queries, codes, scales, qnorms, *,
                               metric="l2"):
    """Fused gather + distance over the int8 code table, (B, K) ids."""
    return _quant.gather_distance_batched_q(ids, queries, codes, scales,
                                            qnorms, metric=metric)


def beam_hop_q(queries, beam_ids, beam_dists, beam_exp, seen, vis_ids,
               vis_dists, n_vis, n_comps, n_hops, adj, codes, scales, qnorms,
               nav_words, ret_words, *, metric="l2", h=4):
    """The fused super-step over the int8 code table (the CUDA launch
    updates the carry in place); returns the carry tuple."""
    return _beam_hop.beam_hop_fused_q(
        queries, beam_ids, beam_dists, beam_exp, seen, vis_ids, vis_dists,
        n_vis, n_comps, n_hops, adj, codes, scales, qnorms, nav_words,
        ret_words, metric=metric, h=h,
    )


def topk_search(queries, vectors, norms=None, *, k, metric="l2", bias=None):
    """Exact top-k scoring; ``bias`` +inf excludes a row.  Non-finite
    results are (+inf, -1)."""
    if norms is None:
        norms = (vectors * vectors).sum(1)
    return _topk.topk_score(queries, vectors, norms, bias, k=k,
                            metric=metric)


def make_kernel_distance_fn():
    """A drop-in ``distance_fn`` for ``repro_torch.core.search.greedy_search``
    over ``gather_distances``.

    Legacy injection point: ``ANNConfig(backend="cuda")`` routes every hot
    path (not just search) through the kernels.
    """

    def distance_fn(state, cfg, q, ids):
        return gather_distances(ids, q, state.vectors, state.norms,
                                metric=cfg.metric)

    return distance_fn


__all__ = [
    "beam_hop", "beam_hop_q", "gather_distances", "gather_distances_batched",
    "gather_distances_batched_q", "launch_counts", "make_kernel_distance_fn",
    "ref", "reset_launch_counts", "topk_search",
]
