"""Fused gather + distance over the int8 code table: ``csrc/quant_gather.cu``.

Replaces the TPU kernel ``repro/kernels/quant_gather.py::
gather_distance_batched_q`` (body ``_kernel_batched_q``), the beam loop's
per-hop primitive when the quantized tier is on (``ANNConfig.quantized``).
For a (B, K) id tile it gathers int8 rows of ``codes`` and scores each
against ``queries[b]``: ``prod = (codes[id] . q) * scale[id]`` (the raw dot
accumulated in f32, then the scale), l2 is ``(||q||^2 + qnorm[id]) - 2
prod``, ip is ``-prod``; INVALID ids give +inf.

Bound on the H100: bytes — about B*K*(D + 8) gathered, 2D flops each.  A
block owns one query's K ids: q is staged in shared memory and ``||q||^2``
computed once per query, and each warp keeps ``ROWS_PER_WARP`` rows in
flight and reduces them together; the scale and qnorm are read in-kernel
(the TPU wrapper gathers them outside, which changes no result).
``launch_shape`` picks the block by K: at K = 1 (the batched search's start
distance) a block holds several queries, one warp and one row each.

``BoundQuantGather`` is the launcher the batched search binds once per
search: every check at binding, then per call one allocation and one
launch.  ``gather_distance_batched_q`` takes the plain version for CPU
tensors and launches the kernel for CUDA tensors;
``gather_distance_batched_q_cuda`` and ``BoundQuantGather`` raise on
anything but CUDA tensors.
"""
from __future__ import annotations

import torch

from . import build

LAUNCHES = {"gather_distance_batched_q": 0}
ROWS_PER_WARP = 8        # kRows in csrc/quant_gather.cu: ids a warp takes
MAX_WARPS = 8            # kMaxWarps: warps a block holds
STAGE_BYTES = 40 * 1024  # staged queries a block may hold by default


def launch_shape(b: int, k: int, d: int) -> tuple:
    """(rows, warps per query, queries per block) of one launch over a
    (b, k) id tile of width d: a warp takes ``ROWS_PER_WARP`` ids at a time
    (one at k = 1, the batched search's start column), a query gets enough
    warps for its k ids, up to ``MAX_WARPS``, and a short tile packs as many
    queries into a block as the warps, b and ``STAGE_BYTES`` of staged
    queries allow."""
    rows = 1 if k == 1 else ROWS_PER_WARP
    wpq = min(MAX_WARPS, -(-k // rows))
    qpb = min(MAX_WARPS // wpq, b, STAGE_BYTES // (16 * -(-d // 4)))
    return rows, wpq, max(1, qpb)


def gather_distance_batched_q_plain(ids, queries, codes, scales, qnorms, *,
                                    metric: str = "l2"):
    """The kernel's arithmetic in plain PyTorch: f32[B, K]."""
    n = codes.shape[0]
    safe = ids.clamp(0, n - 1).long()
    rows = codes[safe].float()                             # (B, K, D)
    raw = torch.bmm(rows, queries.unsqueeze(-1)).squeeze(-1)
    prod = raw * scales[safe]
    if metric == "l2":
        d = (queries * queries).sum(1, keepdim=True) + qnorms[safe] \
            - 2.0 * prod
    else:
        d = -prod
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


def _check_tables(queries, codes, scales, qnorms):
    """Raise unless the kernel takes these: f32 queries (B, D), an int8,
    4-byte aligned (N, D) table with f32 (N,) scales and qnorms, all
    contiguous on one CUDA device."""
    build.require_dtype(codes, torch.int8, "codes")
    for t, what in ((queries, "queries"), (scales, "scales"),
                    (qnorms, "qnorms")):
        build.require_dtype(t, torch.float32, what)
    if codes.dim() != 2 or queries.dim() != 2 \
            or queries.shape[1] != codes.shape[1] \
            or scales.shape != codes.shape[:1] \
            or qnorms.shape != codes.shape[:1]:
        raise ValueError(
            f"gather_distance_batched_q: inconsistent shapes, queries "
            f"{tuple(queries.shape)}, codes {tuple(codes.shape)}, scales "
            f"{tuple(scales.shape)}, qnorms {tuple(qnorms.shape)}")
    if not all(t.is_contiguous() for t in (queries, codes, scales, qnorms)):
        raise ValueError("the CUDA kernels need a contiguous table")
    if codes.data_ptr() % 4:
        raise ValueError("codes must be 4-byte aligned")
    build.require_cuda(queries, codes, scales, qnorms)


def gather_distance_batched_q_cuda(ids, queries, codes, scales, qnorms, *,
                                   metric: str = "l2"):
    """Launch the kernel on a (B, K) tile; raises off CUDA."""
    ids, queries = ids.contiguous(), queries.contiguous()
    build.require_dtype(ids, torch.int32, "ids")
    _check_tables(queries, codes, scales, qnorms)
    build.require_cuda(ids, queries)
    b, k = ids.shape
    n, d = codes.shape
    if queries.shape[0] != b:
        raise ValueError(f"gather_distance_batched_q: {b} id rows for "
                         f"{queries.shape[0]} queries")
    out = torch.empty((b, k), dtype=torch.float32, device=ids.device)
    err = build.lib("quant_gather").quant_gather_launch(
        *(build.ptr(t) for t in (ids, queries, codes, scales, qnorms, out)),
        b, k, n, d, int(metric == "l2"), *launch_shape(b, k, d),
        build.stream(ids),
    )
    build.check(err, "gather_distance_batched_q")
    LAUNCHES["gather_distance_batched_q"] += 1
    return out


class BoundQuantGather:
    """The (B, K) launch bound to one (queries, codes, scales, qnorms,
    metric) for the length of a batched search: ``bound(ids)`` is
    ``gather_distance_batched_q_cuda(ids, queries, codes, scales, qnorms,
    metric=metric)``, bit for bit.

    Binding runs the checks (CUDA tensors on one device, an int8 4-byte
    aligned contiguous table, float32 queries, scales and qnorms, shapes)
    and caches the ``ctypes`` function, the pointers, the raw stream handle
    and a launch shape per K; it raises on anything the kernel does not
    take and never falls back to the plain version.  A call takes the hop's
    ids as the search makes them (int32, contiguous, (B, K), on the table's
    device), allocates a fresh f32[B, K] output and launches: the result of
    one call is never overwritten by the next."""

    __slots__ = ("_keep", "_fn", "_args", "_b", "_d", "_shapes", "_stream",
                 "_dev")

    def __init__(self, queries, codes, scales, qnorms, *,
                 metric: str = "l2"):
        queries = queries.contiguous()
        _check_tables(queries, codes, scales, qnorms)
        self._keep = (queries, codes, scales, qnorms)
        self._fn = build.lib("quant_gather").quant_gather_launch
        self._b, self._d = queries.shape[0], codes.shape[1]
        # (queries, codes, scales, qnorms) pointers, then N, D, the metric
        self._args = (queries.data_ptr(), codes.data_ptr(),
                      scales.data_ptr(), qnorms.data_ptr(), codes.shape[0],
                      self._d, int(metric == "l2"))
        self._shapes = {}
        self._stream = build.stream(codes)
        self._dev = codes.device

    def __call__(self, ids):
        b, k = ids.shape
        if b != self._b:
            raise ValueError(f"BoundQuantGather: {b} id rows for {self._b} "
                             f"queries")
        shape = self._shapes.get(k)
        if shape is None:
            shape = self._shapes[k] = launch_shape(b, k, self._d)
        out = torch.empty((b, k), dtype=torch.float32, device=self._dev)
        qp, cp, sp, np_, n, d, l2 = self._args
        err = self._fn(ids.data_ptr(), qp, cp, sp, np_, out.data_ptr(), b, k,
                       n, d, l2, *shape, self._stream)
        build.check(err, "gather_distance_batched_q")
        LAUNCHES["gather_distance_batched_q"] += 1
        return out


def gather_distance_batched_q(ids, queries, codes, scales, qnorms, *,
                              metric: str = "l2"):
    if build.on_cpu(ids, queries, codes, scales, qnorms):
        return gather_distance_batched_q_plain(ids, queries, codes, scales,
                                               qnorms, metric=metric)
    return gather_distance_batched_q_cuda(ids, queries, codes, scales,
                                          qnorms, metric=metric)
