"""RobustPrune's selection loop: ``csrc/robust_prune.cu`` (kernel 7).

Stands for the reference's ``lax.fori_loop`` in ``repro/core/prune.py::
robust_prune``, which is no Pallas kernel.  Given, for M rows of C
candidates, the ids (INVALID where dead), the distances ``d_p`` to each
row's point p (+inf where dead) and the distances between the candidates,
``r`` selection steps each take the closest live candidate x_j (the first
minimum) and occlude every u with ``alpha * d(x_j, x_u) <= d_p[u]``
(``alpha`` rounded to float32, as the reference's weakly typed scalar).
Returns front-compacted i32[M, r] rows in selection order.

Bound on the H100: the latency of up to r dependent steps, each a
block-wide argmin and one read of a C-float row; the bytes are a few tens
of KB a call.  One block a row keeps the candidates in registers, so the
whole selection is one launch with no host read (the plain loop was some
eleven launches a step and a host read every ``_CHECK_EVERY`` steps).

``robust_prune_select`` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors; ``robust_prune_select_cuda`` raises
on anything else, and on C above ``MAX_C`` (the caller computes wider
candidate sets one row a step, through the plain version with a callable
``pair``).  The kernel only compares the numbers its inputs hold, so both
give the same rows bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# kernel launches made by the wrapper below
LAUNCHES = {"robust_prune": 0}
# the widest candidate set the kernel takes: one thread a candidate
MAX_C = 512
INVALID = -1
# the plain loop stops once no row has a live candidate, checked every
# this many steps (one host read each)
_CHECK_EVERY = 8


def robust_prune_select_plain(ids, d_p, pair, alpha: float, r: int):
    """The selection loop in plain PyTorch.  ``ids`` i32[M, C], ``d_p``
    f32[M, C]; ``pair`` is the f32[M, C, C] matrix of d(x_j, x_u), or a
    callable taking the (M,) selected indices j and returning the f32[M, C]
    rows d(x_j, .)."""
    dev = ids.device
    m, c = ids.shape
    a = torch.tensor(alpha, dtype=torch.float32, device=dev)
    big = torch.full_like(d_p, float("inf"))
    alive = ids >= 0
    # selection order per row, INVALID where a step selects nothing; a
    # stable compaction at the end is the reference's ``out[n_out]`` writes
    sel = torch.full((m, r), INVALID, dtype=torch.int32, device=dev)
    none = torch.full((m,), INVALID, dtype=torch.int32, device=dev)
    for step in range(r):
        if step % _CHECK_EVERY == 0 and not bool(alive.any()):
            break
        # first minimum over the live candidates; a row with none left
        # gets +inf (every live candidate has a finite distance to p)
        val, j = torch.where(alive, d_p, big).min(dim=1)
        ok = val < float("inf")
        jj = j[:, None]
        sel[:, step] = torch.where(ok, ids.gather(1, jj)[:, 0], none)
        if callable(pair):
            d_j = pair(j)
        else:
            d_j = torch.gather(pair, 1, jj[:, :, None].expand(-1, 1, c))[:, 0]
        alive &= (a * d_j > d_p) | ~ok[:, None]
        alive.scatter_(1, jj, False)
    order = torch.sort((sel < 0).to(torch.int8), dim=-1, stable=True)[1]
    return torch.gather(sel, -1, order)


def robust_prune_select_cuda(ids, d_p, pair, alpha: float, r: int):
    """One launch of kernel 7 on CUDA tensors; raises on anything else."""
    ids, d_p, pair = ids.contiguous(), d_p.contiguous(), pair.contiguous()
    build.require_cuda(ids, d_p, pair)
    build.require_dtype(ids, torch.int32, "ids")
    build.require_dtype(d_p, torch.float32, "d_p")
    build.require_dtype(pair, torch.float32, "pair")
    m, c = ids.shape
    if d_p.shape != (m, c) or pair.shape != (m, c, c):
        raise ValueError(f"d_p {tuple(d_p.shape)} and pair "
                         f"{tuple(pair.shape)} do not match ids {(m, c)}")
    if c > MAX_C:
        raise ValueError(f"kernel 7 takes at most {MAX_C} candidates, got {c}")
    if r < 1:
        raise ValueError(f"r must be positive, got {r}")
    out = torch.empty((m, r), dtype=torch.int32, device=ids.device)
    if m == 0 or c == 0:
        return out.fill_(INVALID)
    err = build.lib("robust_prune").robust_prune_launch(
        build.ptr(ids), build.ptr(d_p), build.ptr(pair), build.ptr(out),
        m, c, r, ctypes.c_float(alpha), build.stream(ids),
    )
    build.check(err, "robust_prune")
    LAUNCHES["robust_prune"] += 1
    return out


def robust_prune_select(ids, d_p, pair, alpha: float, r: int):
    if build.on_cpu(ids, d_p, pair):
        return robust_prune_select_plain(ids, d_p, pair, alpha, r)
    return robust_prune_select_cuda(ids, d_p, pair, alpha, r)
