"""Exact brute-force top-k with a row bias: ``csrc/topk_score.cu``.

Replaces the TPU kernel ``repro/kernels/topk_score.py::topk_score`` (body
``_kernel``) together with its padding wrapper ``repro/kernels/ops.py::
topk_search``: per query, the k smallest of ``((||q||^2 + ||x||^2) -
2<x, q>) + bias`` (l2) or ``-<x, q> + bias`` (ip) over all N rows, ties to
the lower row id; entries past the finite ones are ``(+inf, -1)``.

Bound on the H100: operations, ``2*N*B*D`` fp32 flops (at N = 10^6,
B = 1,024, D = 128 about 3.9 ms at 67 TFLOP/s).  The TPU kernel carried a
running (k, B) top-k across a sequential grid; Hopper blocks carry nothing,
so pass 1 scores (128-query tile x row chunk) blocks, each thread an 8 x 8
register tile fed from a cp.async ring of 16-deep slices in shared memory,
keeps a per-query running top-k in shared memory that only scores below its
k-th entry reach, and pass 2 merges the chunks' lists.  The query tiles of
one chunk are adjacent in launch order, so L2 serves the table to all but
the first; the chunk length is the one that fills the card in whole waves.
The wrapper hands the kernel a transposed, zero-padded copy of the queries
(16-byte staging).  The ragged tail is masked in-kernel.  k is at most 64.
"""
from __future__ import annotations

import torch

from . import build
from .ref import stable_topk_smallest

LAUNCHES = {"topk_score": 0}
K_MAX = 64


def topk_score_plain(queries, vectors, norms, bias=None, *, k: int,
                     metric: str = "l2"):
    """The kernel's semantics in plain PyTorch: (dists f32[B, k],
    ids i32[B, k]); non-finite entries are (+inf, -1)."""
    b = queries.shape[0]
    n = vectors.shape[0]
    prod = queries @ vectors.T
    if metric == "l2":
        q2 = (queries * queries).sum(1)
        d = q2[:, None] + norms[None, :] - 2.0 * prod
    else:
        d = -prod
    if bias is not None:
        d = d + bias[None, :]
    vals, idx = stable_topk_smallest(d, min(k, n))
    if k > n:
        pad = k - n
        vals = torch.cat([vals, torch.full((b, pad), float("inf"),
                                           device=vals.device)], 1)
        idx = torch.cat([idx, torch.full((b, pad), -1, dtype=idx.dtype,
                                         device=idx.device)], 1)
    fin = torch.isfinite(vals)
    return (torch.where(fin, vals, torch.full_like(vals, float("inf"))),
            torch.where(fin, idx, torch.full_like(idx, -1)).to(torch.int32))


def topk_score_cuda(queries, vectors, norms, bias=None, *, k: int,
                    metric: str = "l2"):
    """Launch the two-pass kernel; raises off CUDA and for k > 64."""
    if not 1 <= k <= K_MAX:
        raise ValueError(f"topk_score kernel takes 1 <= k <= {K_MAX}, got {k}")
    queries = queries.contiguous()
    b, d = queries.shape
    n = vectors.shape[0]
    if norms is None:
        norms = (vectors * vectors).sum(1)
    if bias is None:
        bias = torch.zeros((n,), dtype=torch.float32, device=vectors.device)
    build.require_cuda(queries, vectors, norms, bias)
    for t, what in ((queries, "queries"), (vectors, "vectors"),
                    (norms, "norms"), (bias, "bias")):
        build.require_dtype(t, torch.float32, what)
    lib = build.lib("topk_score")
    n_chunks = lib.topk_n_chunks(b, n, k)
    dev = queries.device
    # the queries transposed and zero-padded to whole 128-query tiles, so
    # the kernel stages them with 16-byte copies
    qt = torch.zeros((d, -(-b // 128) * 128), dtype=torch.float32,
                     device=dev)
    qt[:, :b] = queries.T
    part_v = torch.empty((max(n_chunks, 1), b, k), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((max(n_chunks, 1), b, k), dtype=torch.int32,
                         device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    err = lib.topk_score_launch(
        *(build.ptr(t) for t in (queries, qt, vectors, norms, bias, part_v,
                                 part_i, out_v, out_i)),
        b, n, d, k, int(metric == "l2"), build.stream(queries),
    )
    build.check(err, "topk_score")
    LAUNCHES["topk_score"] += 1
    return out_v, out_i


def topk_score(queries, vectors, norms, bias=None, *, k: int,
               metric: str = "l2"):
    if build.on_cpu(queries, vectors, norms, bias):
        return topk_score_plain(queries, vectors, norms, bias, k=k,
                                metric=metric)
    return topk_score_cuda(queries, vectors, norms, bias, k=k, metric=metric)
