"""Fused gather + distance over the int8 code table: ``csrc/quant_gather.cu``.

Replaces the TPU kernel ``repro/kernels/quant_gather.py::
gather_distance_batched_q`` (body ``_kernel_batched_q``), the beam loop's
per-hop primitive when the quantized tier is on (``ANNConfig.quantized``).
For a (B, K) id tile it gathers int8 rows of ``codes`` and scores each
against ``queries[b]``: ``prod = (codes[id] . q) * scale[id]`` (the raw dot
accumulated in f32, then the scale), l2 is ``(||q||^2 + qnorm[id]) - 2
prod``, ip is ``-prod``; INVALID ids give +inf.

Bound on the H100: bytes — about B*K*(D + 12) gathered, 2D flops each.  One
warp owns one output, a D = 128 row is one 128-byte transaction, the scale
and qnorm are read in-kernel (the TPU wrapper gathers them outside, which
changes no result).

``gather_distance_batched_q`` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors; ``gather_distance_batched_q_cuda``
raises on anything but CUDA tensors.
"""
from __future__ import annotations

import torch

from . import build

LAUNCHES = {"gather_distance_batched_q": 0}


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


def gather_distance_batched_q_cuda(ids, queries, codes, scales, qnorms, *,
                                   metric: str = "l2"):
    """Launch the kernel on a (B, K) tile; raises off CUDA."""
    ids, queries = ids.contiguous(), queries.contiguous()
    build.require_cuda(ids, queries, codes, scales, qnorms)
    build.require_dtype(ids, torch.int32, "ids")
    build.require_dtype(codes, torch.int8, "codes")
    for t, what in ((queries, "queries"), (scales, "scales"),
                    (qnorms, "qnorms")):
        build.require_dtype(t, torch.float32, what)
    b, k = ids.shape
    n, d = codes.shape
    if queries.shape != (b, d) or scales.shape != (n,) \
            or qnorms.shape != (n,):
        raise ValueError("gather_distance_batched_q: inconsistent shapes")
    if codes.data_ptr() % 4:
        raise ValueError("codes must be 4-byte aligned")
    out = torch.empty((b, k), dtype=torch.float32, device=ids.device)
    err = build.lib("quant_gather").quant_gather_launch(
        *(build.ptr(t) for t in (ids, queries, codes, scales, qnorms, out)),
        b, k, n, d, int(metric == "l2"), build.stream(ids),
    )
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
