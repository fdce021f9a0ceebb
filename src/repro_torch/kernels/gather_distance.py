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

The single-query form has its own kernel (one block per query, q staged
once) and, for the serial search, ``BoundGather``: a launcher bound to one
(query, table, norms, metric) that runs every check once, at binding, and
per call only allocates the output and launches.

``gather_distance_batched`` / ``gather_distance`` take the plain version for
CPU tensors and launch the kernel for CUDA tensors; the ``*_cuda``
launchers and the bound launcher raise on anything but CUDA tensors.
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


def _launch(entry, ids, queries, vectors, norms, metric, key):
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
    err = getattr(build.lib("gather_distance"), entry)(
        build.ptr(ids), build.ptr(queries), build.ptr(vectors),
        build.ptr(norms) if metric == "l2" else None, build.ptr(out),
        b, k, n, d, int(metric == "l2"), build.stream(ids),
    )
    build.check(err, key)
    LAUNCHES[key] += 1
    return out


class BoundGather:
    """The single-query launch bound to one (query, table, norms, metric)
    for the length of a search: ``bound(ids)`` is ``gather_distance_cuda(
    ids, query, vectors, norms, metric=metric)``.

    Binding runs the checks (CUDA tensors on one device, contiguous table
    and norms, float32, shapes) and caches the ``ctypes`` function, the
    pointers and the raw stream handle; it raises on anything the kernel
    does not take and never falls back to the plain version.  A call takes
    ``ids`` as the caller's contract gives them (int32, contiguous, 1-D, on
    the table's device), allocates a fresh f32[K] output and launches: the
    result of one call is never overwritten by the next."""

    __slots__ = ("_keep", "_fn", "_args", "_stream", "_dev")

    def __init__(self, query, vectors, norms=None, *, metric: str = "l2"):
        q = query.reshape(1, -1)
        for t, what in ((q, "query"), (vectors, "vectors"), (norms, "norms")):
            build.require_dtype(t, torch.float32, what)
        if vectors.dim() != 2 or q.shape[1] != vectors.shape[1]:
            raise ValueError(f"query {tuple(query.shape)} does not match the "
                             f"table {tuple(vectors.shape)}")
        if norms is not None and norms.shape != vectors.shape[:1]:
            raise ValueError(f"norms {tuple(norms.shape)} != "
                             f"{tuple(vectors.shape[:1])}")
        if not vectors.is_contiguous() or (norms is not None
                                           and not norms.is_contiguous()):
            raise ValueError("the CUDA kernels need a contiguous table")
        build.require_cuda(q, vectors, norms)
        q = q.contiguous()
        l2 = metric == "l2"
        self._keep = (q, vectors, norms)
        self._fn = build.lib("gather_distance").gather_one_launch
        # (query, table, norms) pointers, then B, N, D and the metric flag
        self._args = (q.data_ptr(), vectors.data_ptr(),
                      norms.data_ptr() if l2 and norms is not None else None,
                      vectors.shape[0], vectors.shape[1], int(l2))
        self._stream = build.stream(vectors)
        self._dev = vectors.device

    def __call__(self, ids):
        k = ids.shape[0]
        out = torch.empty((k,), dtype=torch.float32, device=self._dev)
        qp, vp, np_, n, d, l2 = self._args
        err = self._fn(ids.data_ptr(), qp, vp, np_, out.data_ptr(), 1, k, n,
                       d, l2, self._stream)
        build.check(err, "gather_distance")
        LAUNCHES["gather_distance"] += 1
        return out


def gather_distance_batched_cuda(ids, queries, vectors, norms=None, *,
                                 metric: str = "l2"):
    """Launch the kernel on a (B, K) tile; raises off CUDA."""
    return _launch("gather_distance_launch", ids.contiguous(),
                   queries.contiguous(), vectors, norms, metric,
                   "gather_distance_batched")


def gather_distance_cuda(ids, query, vectors, norms=None, *,
                         metric: str = "l2"):
    """Launch the single-query kernel; raises off CUDA."""
    return _launch("gather_one_launch", ids.reshape(1, -1).contiguous(),
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
