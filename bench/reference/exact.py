"""The plain reference: the live set replayed from the op stream, and exact
nearest neighbours over it in blocks.

Plain PyTorch only.  It reads the inputs the benchmark made (the table of
vectors, the queries, the op stream) and nothing the program made.  The
distance definitions are the configuration's: ``l2`` is the squared
Euclidean distance, ``ip`` the negative inner product, smaller is closer.

``precision`` names the arithmetic of the exact scan: ``float32`` (tensor
cores off), or the rounding of the operands one step below it, ``tf32``
(10 mantissa bits) accumulated in float32, as the hardware does.  The lower
one gives the control: the reference computed in the precision a later
change might be tempted to take.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

PRECISIONS = ("float32", "tf32")
NEVER = np.iinfo(np.int64).max // 4


def round_operands(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` (float32) rounded to the mantissa of ``precision``, as float32."""
    x = x.to(torch.float32)
    if precision == "float32":
        return x
    if precision == "tf32":
        # round to nearest even on the 13 low mantissa bits
        bits = x.contiguous().view(torch.int32)
        lsb = (bits >> 13) & 1
        bits = (bits + 0xFFF + lsb) & ~0x1FFF
        return bits.view(torch.float32)
    raise ValueError(f"unknown precision {precision!r}; known: {PRECISIONS}")


@contextlib.contextmanager
def exact_matmul():
    """float32 GEMMs without TF32 while the block runs."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def distance_matrix(q: torch.Tensor, x: torch.Tensor, metric: str
                    ) -> torch.Tensor:
    """(B, N) distances in float32 from operands already rounded."""
    prod = q @ x.T
    if metric == "ip":
        return -prod
    if metric == "l2":
        return (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * prod
    raise ValueError(f"unknown metric {metric!r}")


def exact_topk(queries: torch.Tensor, table: torch.Tensor,
               live: torch.Tensor, k: int, metric: str,
               precision: str = "float32", col_block: int = 131072):
    """The k nearest live rows of ``table`` to each query: ``(ids i64
    (B, k), dists f32 (B, k))``, ids -1 and dists +inf where fewer than k
    rows are live.  Columns are scanned in blocks of ``col_block`` rows with
    a running top-k, so memory stays at one (B, col_block) block."""
    b = queries.shape[0]
    dev = queries.device
    q = round_operands(queries, precision)
    best_d = torch.full((b, k), float("inf"), device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    with exact_matmul():
        for c0 in range(0, table.shape[0], col_block):
            c1 = min(c0 + col_block, table.shape[0])
            d = distance_matrix(q, round_operands(table[c0:c1], precision),
                                metric)
            d = torch.where(live[c0:c1][None, :], d,
                            torch.full_like(d, float("inf")))
            kk = min(k, c1 - c0)
            bd, bi = torch.topk(d, kk, dim=1, largest=False)
            cat_d = torch.cat([best_d, bd], 1)
            cat_i = torch.cat([best_i, bi + c0], 1)
            best_d, order = torch.topk(cat_d, k, dim=1, largest=False)
            best_i = torch.gather(cat_i, 1, order)
    best_i = torch.where(torch.isfinite(best_d), best_i,
                         torch.full_like(best_i, -1))
    return best_i, best_d


def pair_distances64(queries: torch.Tensor, rows: torch.Tensor,
                     metric: str) -> torch.Tensor:
    """float64 distances of each query (B, D) to its own rows (B, k, D)."""
    q = queries.to(torch.float64)[:, None, :]
    x = rows.to(torch.float64)
    if metric == "l2":
        return ((q - x) ** 2).sum(-1)
    return -(q * x).sum(-1)


def distance_scale64(queries: torch.Tensor, rows: torch.Tensor,
                     metric: str) -> torch.Tensor:
    """The size of the terms a distance is made of, which float32 rounding
    errors scale with: ||q||^2 + ||x||^2 for l2, ||q|| ||x|| for ip."""
    qn = (queries.to(torch.float64) ** 2).sum(-1)[:, None]
    xn = (rows.to(torch.float64) ** 2).sum(-1)
    if metric == "l2":
        return qn + xn
    return torch.sqrt(qn * xn)


class LiveSet:
    """The live set, replayed from the op stream.

    External id ``e`` is row ``e`` of the table.  ``ins_step[e]`` is the
    update step that inserted it (-1 for the starting set, ``NEVER`` if it
    never was), ``del_step[e]`` the step that deleted it (``NEVER`` if none).
    A query batch answered after ``t`` update steps sees ``e`` iff
    ``ins_step[e] < t <= del_step[e]``."""

    def __init__(self, n_rows: int, n_start: int):
        self.ins_step = np.full(n_rows, NEVER, np.int64)
        self.ins_step[:n_start] = -1
        self.del_step = np.full(n_rows, NEVER, np.int64)
        self.n_steps = 0

    def apply(self, inserted, deleted) -> None:
        """Replay one update step: inserts first, then deletes."""
        s = self.n_steps
        inserted = np.asarray(inserted, np.int64)
        deleted = np.asarray(deleted, np.int64)
        if (self.ins_step[inserted] != NEVER).any():
            raise ValueError("an id is inserted twice")
        self.ins_step[inserted] = s
        if not ((self.ins_step[deleted] <= s)
                & (self.del_step[deleted] == NEVER)).all():
            raise ValueError("a delete of an id that is not live")
        self.del_step[deleted] = s
        self.n_steps += 1

    def live_at(self, t: int) -> np.ndarray:
        """bool[n_rows]: the live ids after ``t`` update steps."""
        return (self.ins_step < t) & (t <= self.del_step)

    def is_live(self, ids: np.ndarray, t: np.ndarray) -> np.ndarray:
        """Whether each id (any shape; -1 is never live) was live after
        ``t`` steps (broadcast against ``ids``)."""
        ids = np.asarray(ids, np.int64)
        ok = (ids >= 0) & (ids < len(self.ins_step))
        safe = np.where(ok, ids, 0)
        return ok & (self.ins_step[safe] < t) & (t <= self.del_step[safe])
