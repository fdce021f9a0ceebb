"""The int8 quantized memory tier (``repro/core/quant.py``).

A ``QuantStore`` holds per-row symmetric int8 codes of the vector table, one
f32 scale per row (``max|x| / 127``) and the cached squared norm of the
dequantized row.  The batched beam engine traverses on these codes when
``cfg.quantized`` is set and rescores the surviving beam exactly against
the f32 table (``core/search_batched.py``).  Codes are written at the two
insert write sites (``core/insert.py``, ``core/batched.py``); deletes and
the Alg-6 sweep never touch payloads.

The op order is a contract every engine matches: the raw int8 . q dot
accumulates in f32, THEN the per-row scale multiplies the product, and the
l2 term uses the cached ``qnorms``.  ``torch.round`` rounds half to even,
as ``jnp.round`` does, and ``x / scale`` stays a true division.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QuantStore(NamedTuple):
    """Per-row symmetric int8 quantization of the vector table."""

    codes: torch.Tensor   # i8[n_cap, dim]  round(x / scale), in [-127, 127]
    scale: torch.Tensor   # f32[n_cap]  max|x| / 127 (1.0 for zero rows)
    qnorms: torch.Tensor  # f32[n_cap]  squared norm of the dequantized row


def init_quant_store(n_cap: int, dim: int, device) -> QuantStore:
    return QuantStore(
        codes=torch.zeros((n_cap, dim), dtype=torch.int8, device=device),
        scale=torch.ones((n_cap,), dtype=torch.float32, device=device),
        qnorms=torch.zeros((n_cap,), dtype=torch.float32, device=device),
    )


def quantize_rows(xs: torch.Tensor):
    """``(codes i8, scale f32)`` of rows ``xs`` (..., D): ``scale = max|x| /
    127`` (1.0 for all-zero rows), ``codes = round(x / scale)`` clipped to
    [-127, 127]."""
    xs = xs.to(torch.float32)
    amax = xs.abs().amax(-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.round(xs / scale[..., None]).clamp(-127, 127)
    return codes.to(torch.int8), scale


def dequantize_rows(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 reconstruction ``codes * scale`` of quantized rows (..., D)."""
    return codes.to(torch.float32) * scale[..., None].to(torch.float32)


def quant_write_rows(quant: QuantStore, rows: torch.Tensor,
                     xs: torch.Tensor) -> QuantStore:
    """Quantize ``xs`` (B, D) and write them into rows ``rows`` (i64[B], all
    in range) of the store, IN PLACE (the reference scatters with
    ``mode="drop"``; callers pass only the lanes that write)."""
    codes, scale = quantize_rows(xs)
    deq = dequantize_rows(codes, scale)
    quant.codes[rows] = codes
    quant.scale[rows] = scale
    quant.qnorms[rows] = (deq * deq).sum(-1)
    return quant


def quant_dists_to_ids_batched(state, cfg, queries, ids):
    """f32[B, M] traversal-tier distances from ``queries[b]`` to the int8
    codes of slots ``ids[b]``; inf where INVALID (the plain arithmetic of
    the quantized gather kernel)."""
    from ..kernels.quant_gather import gather_distance_batched_q_plain

    q = state.quant
    return gather_distance_batched_q_plain(
        ids, queries.to(torch.float32), q.codes, q.scale, q.qnorms,
        metric=cfg.metric)


__all__ = [
    "QuantStore", "dequantize_rows", "init_quant_store",
    "quant_dists_to_ids_batched", "quant_write_rows", "quantize_rows",
]
