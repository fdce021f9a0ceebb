"""The distance-backend layer (``repro/core/backend.py``).

Every hot path (Alg 1 search, Alg 2 insert, Alg 5 delete, Alg 3 prune, the
recall oracle) bottoms out in "distances from a query to a gathered set of
slots", and goes through a ``DistanceBackend``.  Three engines:

  * ``torch`` — plain PyTorch math (``core/distance.py``), the counterpart
                of the reference's ``jnp`` engine;
  * ``ref``   — the plain kernel oracles (``kernels/ref.py``);
  * ``cuda``  — the hand-written Hopper kernels: ``gather_distance`` for the
                serial beam loop and ``beam_hop_fused`` for the fused
                super-step of the batched one (each bound once per
                search, ``bind_dists_to_ids`` / ``bind_beam_superstep``),
                ``topk_score`` for the exact scan, and their int8 twins
                ``gather_distance_batched_q`` (bound once per batched
                search, ``bind_dists_to_ids_batched_q``) /
                ``beam_hop_fused_q`` for the quantized tier.  It raises on
                tensors that are not on a CUDA device.

``ANNConfig.backend = "auto"`` resolves by the device of the state's
tensors: ``cuda`` for CUDA tensors, ``torch`` for CPU tensors.
"""
from __future__ import annotations

import torch

from . import distance as _math
from .types import ANNConfig, GraphState, clip_ids

BIG = _math.BIG


def _big_like(t):
    return torch.full_like(t, BIG)


class DistanceBackend:
    """Pluggable kernel engine for all distance math ("smaller = closer")."""

    name = "abstract"

    def query_norm(self, cfg: ANNConfig, q):
        """||q||^2 along the last axis for l2, 0 for ip."""
        if cfg.metric == "l2":
            return (q * q).sum(-1) if q.dim() > 1 else torch.dot(q, q)
        return torch.zeros(q.shape[:-1], dtype=torch.float32,
                           device=q.device)

    def dists_to_ids(self, state: GraphState, cfg: ANNConfig, q, ids):
        """f32[M] distances from ``q`` to slots ``ids``; inf where
        INVALID."""
        raise NotImplementedError

    def bind_dists_to_ids(self, state: GraphState, cfg: ANNConfig, q):
        """``dists_to_ids`` with ``state`` and ``q`` fixed, for the hops of
        one serial search: a callable ``ids -> f32[M]``."""
        return lambda ids: self.dists_to_ids(state, cfg, q, ids)

    def dists_to_ids_batched(self, state: GraphState, cfg: ANNConfig,
                             queries, ids):
        """f32[B, M] distances from ``queries[b]`` to slots ``ids[b]``;
        inf where INVALID (the per-hop tile of the batched engine)."""
        raise NotImplementedError

    def beam_superstep(self, state: GraphState, cfg: ANNConfig, queries,
                       carry, *, h: int, l: int, max_visits: int):
        """Advance the batched beam engine's carry by ``h`` hops: ``h``
        compositions of the shared hop body over ``dists_to_ids_batched``."""
        from .search_batched import superstep_reference

        return superstep_reference(
            self.dists_to_ids_batched, state, cfg, queries, carry,
            h=h, l=l, max_visits=max_visits,
        )

    def bind_beam_superstep(self, state: GraphState, cfg: ANNConfig, queries,
                            carry, *, h: int, quantized: bool = False):
        """The super-step bound to one batched search from its first
        ``carry``, over the int8 tier when ``quantized``: ``.carry`` is the
        carry to start from, ``step(carry)`` advances a carry by ``h`` hops
        and returns it, and ``step.active()`` tells whether a lane is still
        active after the last call.  Default: ``beam_superstep`` (or
        ``beam_superstep_q``) with ``lane_active`` as the stop test."""
        from .search_batched import PlainSuperstep

        superstep = self.beam_superstep_q if quantized \
            else self.beam_superstep
        l, max_visits = carry.beam_ids.shape[1], carry.vis_ids.shape[1]
        return PlainSuperstep(
            lambda c: superstep(state, cfg, queries, c, h=h, l=l,
                                max_visits=max_visits),
            carry, max_visits)

    # -- the quantized memory tier (core/quant.py) --------------------------

    def dists_to_ids_batched_q(self, state: GraphState, cfg: ANNConfig,
                               queries, ids):
        """f32[B, M] traversal-tier distances from ``queries[b]`` to the
        int8 codes of slots ``ids[b]`` (``state.quant`` present); inf where
        INVALID.  Default: the plain math of ``core/quant.py``."""
        from .quant import quant_dists_to_ids_batched

        return quant_dists_to_ids_batched(state, cfg, queries, ids)

    def bind_dists_to_ids_batched_q(self, state: GraphState, cfg: ANNConfig,
                                    queries):
        """``dists_to_ids_batched_q`` with ``state`` and ``queries`` fixed,
        for the start distance and the per-hop tiles of one batched search:
        a callable ``ids -> f32[B, M]``."""
        return lambda ids: self.dists_to_ids_batched_q(state, cfg, queries,
                                                       ids)

    def beam_superstep_q(self, state: GraphState, cfg: ANNConfig, queries,
                         carry, *, h: int, l: int, max_visits: int):
        """``beam_superstep`` over the quantized tier: the same carry
        contract, distances from ``dists_to_ids_batched_q``."""
        from .search_batched import superstep_reference

        return superstep_reference(
            self.dists_to_ids_batched_q, state, cfg, queries, carry,
            h=h, l=l, max_visits=max_visits,
        )

    def dists_from_rows(self, cfg: ANNConfig, q, q_norm, rows, row_norms):
        raise NotImplementedError

    def pair_dists(self, cfg: ANNConfig, a_vecs, a_norms, b_vecs, b_norms):
        raise NotImplementedError

    def pair_dists_ids(self, state: GraphState, cfg: ANNConfig, a_ids,
                       b_ids):
        """(A, B) distances between two id sets; inf where either INVALID."""
        sa = clip_ids(a_ids, cfg.n_cap)
        sb = clip_ids(b_ids, cfg.n_cap)
        d = self.pair_dists(cfg, state.vectors[sa], state.norms[sa],
                            state.vectors[sb], state.norms[sb])
        invalid = (a_ids[:, None] < 0) | (b_ids[None, :] < 0)
        return torch.where(invalid, _big_like(d), d)

    def brute_force_topk(self, state: GraphState, cfg: ANNConfig, queries,
                         *, k: int):
        """Exact top-k over live slots: (ids i32[Q, k], dists f32[Q, k]),
        ascending, ids == -1 past the live count."""
        raise NotImplementedError

    def _biased_topk(self, state: GraphState, score_fn):
        """+inf bias excludes non-live slots; non-finite results map to
        id -1.  ``score_fn(bias) -> (dists, ids)``."""
        bias = torch.where(state.active, 0.0, BIG).to(torch.float32)
        d, ids = score_fn(bias)
        return torch.where(torch.isfinite(d), ids,
                           torch.full_like(ids, -1)), d


_REGISTRY: dict = {}


def register_backend(name: str):
    """Class decorator: instantiate and register a backend under ``name``."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls()
        return cls

    return deco


def available_backends() -> tuple:
    return tuple(sorted(_REGISTRY))


def get_backend(name: str, device=None) -> DistanceBackend:
    """Resolve a backend by name.  ``"auto"`` picks ``cuda`` when the
    state's ``device`` is a CUDA device, else ``torch``."""
    if name == "auto":
        if device is None:
            raise ValueError("backend 'auto' needs the state's device")
        name = "cuda" if torch.device(device).type == "cuda" else "torch"
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown distance backend {name!r}; "
            f"available: {available_backends()}"
        ) from None


def resolve_backend(cfg: ANNConfig, device) -> DistanceBackend:
    """The backend selected by ``cfg.backend`` for a state on ``device``."""
    return get_backend(cfg.backend, device)


@register_backend("torch")
class TorchBackend(DistanceBackend):
    """The matmul + broadcast-add formulation of ``core/distance.py``."""

    def dists_to_ids(self, state, cfg, q, ids):
        return _math.dists_to_ids(state, cfg, q, ids)

    def dists_to_ids_batched(self, state, cfg, queries, ids):
        safe = clip_ids(ids, cfg.n_cap)
        rows = state.vectors[safe]                             # (B, M, D)
        prod = torch.bmm(rows, queries.unsqueeze(-1)).squeeze(-1)
        if cfg.metric == "l2":
            d = (queries * queries).sum(1, keepdim=True) + \
                state.norms[safe] - 2.0 * prod
        else:
            d = -prod
        return torch.where(ids >= 0, d, _big_like(d))

    def dists_from_rows(self, cfg, q, q_norm, rows, row_norms):
        return _math.dists_from_rows(cfg.metric, q, q_norm, rows, row_norms)

    def pair_dists(self, cfg, a_vecs, a_norms, b_vecs, b_norms):
        return _math.pair_dists(cfg.metric, a_vecs, a_norms, b_vecs, b_norms)

    def brute_force_topk(self, state, cfg, queries, *, k):
        from ..kernels.ref import stable_topk_smallest

        q_norms = self.query_norm(cfg, queries)
        d = self.pair_dists(cfg, queries, q_norms, state.vectors,
                            state.norms)
        d = torch.where(state.active[None, :], d, _big_like(d))
        vals, idx = stable_topk_smallest(d, k)
        idx = idx.to(torch.int32)
        return torch.where(torch.isfinite(vals), idx,
                           torch.full_like(idx, -1)), vals


@register_backend("ref")
class RefBackend(TorchBackend):
    """The kernel oracles of ``kernels/ref.py``."""

    def dists_to_ids(self, state, cfg, q, ids):
        from ..kernels import ref

        return ref.gather_distance_ref(ids, q, state.vectors,
                                       metric=cfg.metric)

    def dists_to_ids_batched(self, state, cfg, queries, ids):
        from ..kernels import ref

        return ref.gather_distance_batched_ref(ids, queries, state.vectors,
                                               metric=cfg.metric)

    def dists_to_ids_batched_q(self, state, cfg, queries, ids):
        from ..kernels import ref

        q = state.quant
        return ref.quant_gather_distance_batched_ref(
            ids, queries, q.codes, q.scale, q.qnorms, metric=cfg.metric)

    def brute_force_topk(self, state, cfg, queries, *, k):
        from ..kernels import ref

        return self._biased_topk(state, lambda bias: ref.topk_score_ref(
            queries, state.vectors, state.norms, bias, k=k,
            metric=cfg.metric,
        ))


@register_backend("cuda")
class CudaBackend(TorchBackend):
    """Routes the memory-bound primitives through the hand-written kernels.
    Tile-local helpers (``dists_from_rows`` / ``pair_dists``) work on rows
    the caller already gathered and keep the plain math."""

    def dists_to_ids(self, state, cfg, q, ids):
        from ..kernels.gather_distance import gather_distance_cuda

        return gather_distance_cuda(ids.to(torch.int32), q, state.vectors,
                                    state.norms, metric=cfg.metric)

    def bind_dists_to_ids(self, state, cfg, q):
        """The single-query kernel's launcher, checked once and bound to the
        table, norms, query and stream; each hop's ids are i32[M] on the
        card (the search's adjacency rows)."""
        from ..kernels.gather_distance import BoundGather

        return BoundGather(q, state.vectors, state.norms, metric=cfg.metric)

    def dists_to_ids_batched(self, state, cfg, queries, ids):
        from ..kernels.gather_distance import gather_distance_batched_cuda

        return gather_distance_batched_cuda(
            ids.to(torch.int32), queries, state.vectors, state.norms,
            metric=cfg.metric,
        )

    def beam_superstep(self, *args, **kwargs):
        raise NotImplementedError(
            "the cuda engine's super-step is the fused hop kernel, bound "
            "once per search: bind_beam_superstep")

    beam_superstep_q = beam_superstep

    def bind_beam_superstep(self, state, cfg, queries, carry, *, h,
                            quantized=False):
        """The fused hop kernel's launcher (``BoundBeamHop``), checked once
        and bound to the carry (with an int32 ``beam_exp``, updated in
        place), the tables, the packed masks, the queries and the stream;
        the kernel reports in a status word whether a lane is still
        active."""
        from ..kernels.beam_hop import BoundBeamHop
        from .search_batched import _BLoop

        carry = _BLoop(*carry[:2], carry[2].to(torch.int32), *carry[3:])
        nav_words, ret_words = pack_masks(state)
        if quantized:
            q = state.quant
            return BoundBeamHop(queries, carry, state.adj, q.codes, q.qnorms,
                                nav_words, ret_words, metric=cfg.metric,
                                h=h, scales=q.scale)
        return BoundBeamHop(queries, carry, state.adj, state.vectors,
                            state.norms, nav_words, ret_words,
                            metric=cfg.metric, h=h)

    def dists_to_ids_batched_q(self, state, cfg, queries, ids):
        from ..kernels.quant_gather import gather_distance_batched_q_cuda

        q = state.quant
        return gather_distance_batched_q_cuda(
            ids.to(torch.int32), queries, q.codes, q.scale, q.qnorms,
            metric=cfg.metric,
        )

    def bind_dists_to_ids_batched_q(self, state, cfg, queries):
        """The int8 gather kernel's launcher (``BoundQuantGather``), checked
        once and bound to the code table, scales, qnorms, queries and
        stream; each call's ids are i32[B, M] on the card (the start column,
        or a hop's masked adjacency tile)."""
        from ..kernels.quant_gather import BoundQuantGather

        q = state.quant
        return BoundQuantGather(queries, q.codes, q.scale, q.qnorms,
                                metric=cfg.metric)

    def brute_force_topk(self, state, cfg, queries, *, k):
        from ..kernels.topk_score import topk_score_cuda

        return self._biased_topk(state, lambda bias: topk_score_cuda(
            queries, state.vectors, state.norms, bias, k=k,
            metric=cfg.metric,
        ))


def pack_masks(state: GraphState):
    """The packed (navigable, returnable) words the fused hop reads."""
    from . import bitset
    from .types import navigable

    return bitset.pack_bits(navigable(state)), bitset.pack_bits(state.active)


__all__ = [
    "BIG", "DistanceBackend", "available_backends", "get_backend",
    "pack_masks", "register_backend", "resolve_backend",
]
