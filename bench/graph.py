"""The frozen starting-graph builder.

A deployment loads a graph built offline; so does the benchmark, because the
program's own inserts would take hours at this size.  This builder is plain
PyTorch, imports nothing of the program, and never changes with it.

1. Candidates: each point's ``knn`` nearest other points in its cell of a
   coarse partition (``cells`` centres, farthest-first and a few Lloyd steps
   on a sample of the rows), from an exact scan of the cell in row blocks
   (TF32 GEMMs: the graph is input data, not output).  The scan then costs
   ``n`` times a cell, not ``n`` squared.  ``cells`` is the data's number of
   clusters: a cut through a cluster splits its graph in two.
2. RobustPrune with the configuration's ``alpha`` over the candidates sorted
   by distance: a candidate is kept unless a kept, closer one ``v`` has
   ``alpha * d(v, u) <= d(p, u)``, up to ``r - long_edges`` edges.  ``d`` is
   the squared Euclidean distance under either metric: the inner-product
   sets have unit rows, on which it orders as the inner product does, while
   ``alpha`` times a negative inner product would occlude nearly every
   candidate (a point would keep one near edge).
3. Reverse edges: every kept edge ``p -> q`` offers ``q -> p``; each point
   takes its ``in_edges`` closest offers, and the union with its own edges is
   pruned again as in 2.
4. ``long_edges`` uniform random edges per point, so that the search can
   leave a cluster: without them the mixture's clusters are islands.
5. The start is the medoid: the point nearest the mean.

Degrees are at most ``r``; no self edge and no duplicate.
"""
from __future__ import annotations

import contextlib

import torch

INVALID = -1
SAMPLE_PER_CELL = 256         # rows of the k-means sample, per cell
LLOYD_STEPS = 8
KNN_BLOCK_BYTES = 2 << 30     # one block of a cell's distance matrix
PRUNE_BLOCK_BYTES = 8 << 30   # one block of RobustPrune's working set


@contextlib.contextmanager
def fast_matmul():
    """TF32 GEMMs while the builder runs; the setting is restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _sq_dists(p: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Squared distances of ``p`` (M, D) to its rows (M, C, D): (M, C)."""
    prod = torch.bmm(rows, p.unsqueeze(-1)).squeeze(-1)
    return (p * p).sum(-1)[:, None] + (rows * rows).sum(-1) - 2.0 * prod


def kmeans_centres(x: torch.Tensor, cells: int,
                   gen: torch.Generator) -> torch.Tensor:
    """f32[<= cells, D]: farthest-first seeds from a random first row, then
    Lloyd steps, over ``SAMPLE_PER_CELL`` random rows a cell.  Farthest
    first seeds every well-separated cluster of a mixture once, where
    sampled seeds often put two in one cluster and split it; a seed on an
    outlier keeps under a quarter of its share of the sample and is
    dropped."""
    n = x.shape[0]
    cells = min(cells, n)
    sample = SAMPLE_PER_CELL
    pick = torch.randperm(n, generator=gen, device=x.device)[:cells * sample]
    s = x[pick]
    cent = s[:1]
    d2 = ((s - cent) ** 2).sum(1)
    for _ in range(1, cells):
        far = s[d2.argmax()][None]
        cent = torch.cat([cent, far])
        d2 = torch.minimum(d2, ((s - far) ** 2).sum(1))
    for _ in range(LLOYD_STEPS):
        lab = nearest_centre(s, cent)
        tot = torch.zeros_like(cent).index_add_(0, lab, s)
        cnt = torch.bincount(lab, minlength=cells).to(s.dtype)
        cent = torch.where(cnt[:, None] > 0, tot / cnt.clamp(min=1)[:, None],
                           cent)
    return cent[cnt >= max(1, sample // 4)]


def nearest_centre(x: torch.Tensor, cent: torch.Tensor,
                   block: int = 1 << 20) -> torch.Tensor:
    """i64[n]: the nearest centre of each row (squared Euclidean)."""
    cn = (cent * cent).sum(1)
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for r0 in range(0, x.shape[0], block):
        d = cn[None, :] - 2.0 * (x[r0:r0 + block] @ cent.T)
        out[r0:r0 + block] = d.argmin(1)
    return out


def knn_candidates(x: torch.Tensor, metric: str, k: int, *, cells: int,
                   gen: torch.Generator) -> torch.Tensor:
    """i64[n, k]: each row's k nearest other rows in its cell, nearest
    first (INVALID where the cell is smaller)."""
    n = x.shape[0]
    lab = nearest_centre(x, kmeans_centres(x, cells, gen))
    order = torch.argsort(lab)
    bounds = torch.cumsum(torch.bincount(lab), 0).tolist()
    xn = (x * x).sum(1)
    out = torch.full((n, k), INVALID, dtype=torch.int64, device=x.device)
    for c0, c1 in zip([0] + bounds[:-1], bounds):
        cell = order[c0:c1]
        kk = min(k, cell.numel() - 1)
        if kk <= 0:
            continue
        xc = x[cell]
        rb = max(1, KNN_BLOCK_BYTES // (4 * cell.numel()))
        for r0 in range(0, cell.numel(), rb):
            rows = cell[r0:r0 + rb]
            d = x[rows] @ xc.T
            if metric == "l2":
                d.mul_(-2.0).add_(xn[cell][None, :])
            else:
                d.neg_()
            d.masked_fill_(rows[:, None] == cell[None, :], float("inf"))
            top = torch.topk(d, kk, dim=1, largest=False).indices
            out[rows, :kk] = cell[top]
    return out


def dedupe_rows(ids: torch.Tensor) -> torch.Tensor:
    """INVALID in place of every repeat of an id along a row (first kept)."""
    srt, order = torch.sort(ids, dim=1, stable=True)
    dup = torch.zeros_like(srt, dtype=torch.bool)
    dup[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    dup = torch.zeros_like(dup).scatter_(1, order, dup)
    return torch.where(dup, torch.full_like(ids, INVALID), ids)


def compact_rows(ids: torch.Tensor) -> torch.Tensor:
    """Valid entries to the front of each row, order kept."""
    order = torch.sort((ids < 0).to(torch.int8), dim=1, stable=True).indices
    return torch.gather(ids, 1, order)


def robust_prune(x: torch.Tensor, alpha: float, cand: torch.Tensor,
                 cap: int) -> tuple:
    """Prune each row's candidates (i64[n, C], INVALID padded) to at most
    ``cap`` edges, by squared distances.  Returns ``(ids i64[n, cap],
    dists f32[n, cap])`` in selection order, INVALID / +inf padded."""
    n, c = cand.shape
    dim = x.shape[1]
    dev = x.device
    out = torch.full((n, cap), INVALID, dtype=torch.int64, device=dev)
    out_d = torch.full((n, cap), float("inf"), device=dev)
    rb = max(1, min(n, PRUNE_BLOCK_BYTES // (4 * c * (dim + c))))
    for r0 in range(0, n, rb):
        r1 = min(n, r0 + rb)
        m = r1 - r0
        p = torch.arange(r0, r1, device=dev)
        ids = dedupe_rows(cand[r0:r1])
        ids = torch.where(ids == p[:, None], torch.full_like(ids, INVALID),
                          ids)
        valid = ids >= 0
        rows = x[ids.clamp(min=0)]
        dp = _sq_dists(x[r0:r1], rows)
        dp = torch.where(valid, dp, torch.full_like(dp, float("inf")))
        dp, order = torch.sort(dp, dim=1, stable=True)
        ids = torch.gather(ids, 1, order)
        rows = torch.gather(rows, 1, order[:, :, None].expand(-1, -1, dim))
        nr = (rows * rows).sum(-1)
        adv = alpha * (nr[:, :, None] + nr[:, None, :]
                       - 2.0 * torch.bmm(rows, rows.transpose(1, 2)))
        alive = ids >= 0
        kept = torch.zeros((m, c), dtype=torch.bool, device=dev)
        cnt = torch.zeros((m,), dtype=torch.int64, device=dev)
        for j in range(c):
            take = alive[:, j] & (cnt < cap)
            kept[:, j] = take
            cnt += take
            alive &= ~(take[:, None] & (adv[:, j, :] <= dp))
        pos = torch.cumsum(kept, 1) - 1
        ri, ci = torch.nonzero(kept, as_tuple=True)
        out[r0 + ri, pos[ri, ci]] = ids[ri, ci]
        out_d[r0 + ri, pos[ri, ci]] = dp[ri, ci]
    return out, out_d


def reverse_offers(out: torch.Tensor, out_d: torch.Tensor,
                   n_in: int) -> torch.Tensor:
    """i64[n, n_in]: for each point, the sources of its ``n_in`` closest
    in-edges in ``out``, INVALID padded."""
    n = out.shape[0]
    dev = out.device
    valid = out >= 0
    src = torch.arange(n, device=dev)[:, None].expand_as(out)[valid]
    dst = out[valid]
    w = out_d[valid]
    order = torch.sort(w, stable=True).indices
    src, dst = src[order], dst[order]
    order = torch.sort(dst, stable=True).indices
    src, dst = src[order], dst[order]
    counts = torch.bincount(dst, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(dst.numel(), device=dev) - starts[dst]
    keep = rank < n_in
    rev = torch.full((n, n_in), INVALID, dtype=torch.int64, device=dev)
    rev[dst[keep], rank[keep]] = src[keep]
    return rev


def medoid(x: torch.Tensor, metric: str) -> int:
    """The point nearest the mean of all points."""
    mean = x.mean(0)
    if metric == "ip":
        return int(torch.argmax(x @ mean))
    return int(torch.argmin(((x - mean) ** 2).sum(1)))


def build_graph(x: torch.Tensor, *, metric: str, r: int, alpha: float,
                knn: int, in_edges: int, long_edges: int, cells: int,
                gen: torch.Generator) -> tuple:
    """``(adj i32[n, r] front-compacted and INVALID padded, start)``."""
    n = x.shape[0]
    local = r - long_edges
    with fast_matmul():
        cand = knn_candidates(x, metric, min(knn, n - 1), cells=cells,
                              gen=gen)
        out, out_d = robust_prune(x, alpha, cand, local)
        del cand
        rev = reverse_offers(out, out_d, in_edges)
        out, _ = robust_prune(x, alpha, torch.cat([out, rev], 1), local)
        del rev
        start = medoid(x, metric)
    far = torch.randint(0, max(1, n - 1), (n, long_edges), generator=gen,
                        device=x.device)
    far = far + (far >= torch.arange(n, device=x.device)[:, None])
    adj = compact_rows(dedupe_rows(torch.cat([out, far], 1)))
    return adj.to(torch.int32), start
