"""Fused gather + distance: ``csrc/gather_distance.cu``.

Replaces the TPU kernels ``repro/kernels/gather_distance.py::
gather_distance_batched`` (body ``_kernel_batched``) and ``::gather_distance``
(body ``_kernel``).  For a (B, K) id tile it gathers rows of ``vectors`` and
scores each against ``queries[b]``: l2 is ``(||q||^2 + ||x||^2) - 2<x, q>``
with ``||x||^2`` from ``norms`` (recomputed from the row when ``norms`` is
None), ip is ``-<x, q>``; INVALID ids give +inf.

Bound on the H100: bytes — about B*K*(4D + 8) gathered, 2D flops each.  One
warp owns one output: 32 lanes read the row in coalesced 128-byte pieces,
the norm is loaded in-kernel, and thousands of rows are in flight across the
grid (the TPU version issued one blocking row DMA after another).

``gather_distance_batched`` / ``gather_distance`` take the plain version for
CPU tensors and launch the kernel for CUDA tensors; the ``*_cuda``
launchers raise on anything but CUDA tensors.
"""
from __future__ import annotations

import torch

from . import build

# kernel launches made by the wrappers below, one count per TPU kernel
LAUNCHES = {"gather_distance_batched": 0, "gather_distance": 0}


def gather_distance_batched_plain(ids, queries, vectors, norms=None, *,
                                  metric: str = "l2"):
    """The kernel's arithmetic in plain PyTorch: f32[B, K]."""
    n = vectors.shape[0]
    safe = ids.clamp(0, n - 1).long()
    rows = vectors[safe]                                   # (B, K, D)
    prod = torch.bmm(rows, queries.unsqueeze(-1)).squeeze(-1)
    if metric == "l2":
        q2 = (queries * queries).sum(1, keepdim=True)
        x2 = norms[safe] if norms is not None else (rows * rows).sum(-1)
        d = q2 + x2 - 2.0 * prod
    else:
        d = -prod
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))


def gather_distance_plain(ids, query, vectors, norms=None, *,
                          metric: str = "l2"):
    """The single-query form: f32[K]."""
    return gather_distance_batched_plain(
        ids[None], query[None], vectors, norms, metric=metric
    )[0]


def _launch(ids, queries, vectors, norms, metric, key):
    build.require_cuda(ids, queries, vectors, norms)
    build.require_dtype(ids, torch.int32, "ids")
    for t, what in ((queries, "queries"), (vectors, "vectors"),
                    (norms, "norms")):
        build.require_dtype(t, torch.float32, what)
    b, k = ids.shape
    n, d = vectors.shape
    if queries.shape != (b, d):
        raise ValueError(f"queries {tuple(queries.shape)} != {(b, d)}")
    if norms is not None and norms.shape != (n,):
        raise ValueError(f"norms {tuple(norms.shape)} != {(n,)}")
    out = torch.empty((b, k), dtype=torch.float32, device=ids.device)
    err = build.lib("gather_distance").gather_distance_launch(
        build.ptr(ids), build.ptr(queries), build.ptr(vectors),
        build.ptr(norms) if metric == "l2" else None, build.ptr(out),
        b, k, n, d, int(metric == "l2"), build.stream(ids),
    )
    build.check(err, key)
    LAUNCHES[key] += 1
    return out


def gather_distance_batched_cuda(ids, queries, vectors, norms=None, *,
                                 metric: str = "l2"):
    """Launch the kernel on a (B, K) tile; raises off CUDA."""
    return _launch(ids.contiguous(), queries.contiguous(), vectors, norms,
                   metric,
                   "gather_distance_batched")


def gather_distance_cuda(ids, query, vectors, norms=None, *,
                         metric: str = "l2"):
    """Launch the kernel for one query (the B = 1 launch); raises off
    CUDA."""
    return _launch(ids.reshape(1, -1).contiguous(),
                   query.reshape(1, -1).contiguous(),
                   vectors, norms, metric, "gather_distance")[0]


def gather_distance_batched(ids, queries, vectors, norms=None, *,
                            metric: str = "l2"):
    if build.on_cpu(ids, queries, vectors, norms):
        return gather_distance_batched_plain(ids, queries, vectors, norms,
                                             metric=metric)
    return gather_distance_batched_cuda(ids, queries, vectors, norms,
                                        metric=metric)


def gather_distance(ids, query, vectors, norms=None, *, metric: str = "l2"):
    if build.on_cpu(ids, query, vectors, norms):
        return gather_distance_plain(ids, query, vectors, norms,
                                     metric=metric)
    return gather_distance_cuda(ids, query, vectors, norms, metric=metric)
