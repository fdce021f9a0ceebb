"""Bitpacked visited sets (``repro/core/bitset.py``), stored as int32.

Same little-endian layout as the reference: slot i lives at word i >> 5,
bit i & 31, ``ceil(n_cap / 32)`` words per row.  Torch's ``uint32`` has no
CPU shifts, so words are ``int32`` with the identical bit pattern (slot 31
of a word is its sign bit).  ``(w >> s) & 1`` reads bit s under the
arithmetic shift too; sums of bits are taken in int64 and folded back to the
int32 pattern with ``to_i32``.

``setbits_rows`` keeps the reference's formulation: duplicate ids of a row
are masked to their first occurrence and already-set bits drop, so the
scatter-add of single bits into each word is an exact OR.
"""
from __future__ import annotations

import torch

WORD_BITS = 32
_U32 = 1 << 32


def n_words(n_cap: int) -> int:
    """Packed words per row for an ``n_cap``-slot bitmap (ceil division)."""
    return (n_cap + WORD_BITS - 1) // WORD_BITS


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor holding u32 values in [0, 2^32) -> the int32 tensor
    with the same bit pattern."""
    return torch.where(x >= (1 << 31), x - _U32, x).to(torch.int32)


def to_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 holding their unsigned value."""
    return words.to(torch.int64) & (_U32 - 1)


def empty_rows(b: int, n_cap: int, device) -> torch.Tensor:
    return torch.zeros((b, n_words(n_cap)), dtype=torch.int32, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a bool[..., n] mask to int32[..., n_words(n)]."""
    n = bits.shape[-1]
    w = n_words(n)
    pad = w * WORD_BITS - n
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad), value=False)
    weights = torch.ones((), dtype=torch.int64, device=bits.device) << \
        torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device)
    grouped = bits.reshape(bits.shape[:-1] + (w, WORD_BITS)).to(torch.int64)
    return to_i32((grouped * weights).sum(-1))


def getbit(words: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Bit test of ``ids`` (in [0, n_cap)) against ONE packed row."""
    ids = ids.to(torch.int64)
    w = words[ids >> 5]
    return ((w >> (ids & 31).to(torch.int32)) & 1) != 0


def getbit_rows(seen: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row-aligned bit test: ``seen`` int32[B, W], ``ids`` [B, K] in
    [0, n_cap) -> bool[B, K]."""
    ids = ids.to(torch.int64)
    w = torch.gather(seen, 1, ids >> 5)
    return ((w >> (ids & 31).to(torch.int32)) & 1) != 0


def setbits_rows(seen: torch.Tensor, ids: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """OR the bits of masked-in ``ids`` [B, K] into each row of ``seen``
    [B, W]; returns a new tensor.  The scatter-add of single bits is exact
    because in-row duplicates keep only their first masked-in occurrence and
    ids whose bit is already set drop."""
    ids = ids.to(torch.int64)
    k = ids.shape[-1]
    earlier = torch.ones((k, k), dtype=torch.bool,
                         device=ids.device).tril(-1)       # [j, i]: i < j
    dup = ((ids.unsqueeze(2) == ids.unsqueeze(1)) & mask.unsqueeze(1)
           & earlier).any(-1)
    first = mask & ~dup & ~getbit_rows(seen, ids)
    word = ids >> 5
    bit = torch.where(first, torch.ones_like(ids) << (ids & 31),
                      torch.zeros_like(ids))
    # every entry's word receives the sum of the bits aimed at it in its row
    same = word.unsqueeze(2) == word.unsqueeze(1)          # [B, K, K]
    add = (same.to(torch.int64) * bit.unsqueeze(1)).sum(-1)
    new = to_i32(to_u32(torch.gather(seen, 1, word)) + add)
    # entries sharing a word write the same value, so the order is moot
    return seen.clone().scatter_(1, word, new)


def unpack_rows(seen: torch.Tensor, n_cap: int) -> torch.Tensor:
    """Expand int32[B, W] back to bool[B, n_cap] (tests / debugging)."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=seen.device)
    bits = (seen.unsqueeze(-1) >> shifts) & 1
    return (bits != 0).reshape(seen.shape[0], -1)[:, :n_cap]


__all__ = [
    "WORD_BITS", "empty_rows", "getbit", "getbit_rows", "n_words",
    "pack_bits", "setbits_rows", "to_i32", "to_u32", "unpack_rows",
]
