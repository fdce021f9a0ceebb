"""Fused multi-hop beam super-step: ``csrc/beam_hop.cu``.

Replaces the TPU kernels ``repro/kernels/beam_hop.py::beam_hop_fused`` (body
``_kernel``, per-lane step ``_lane_hop``) and ``::beam_hop_fused_q`` (body
``_kernel_q``, the ``scales=`` path of ``_lane_hop``): H masked hops per
lane in one launch.  Each hop pops the closest unexpanded beam entry
(first minimum), records it in the visited list if returnable, reads its
adjacency row, keeps the navigable not-yet-seen neighbours, scores them,
sets their seen bits and stable-merges them into the beam, keeping the
best l.  Inactive lanes are exact no-ops.

Bound on the H100: bytes, in the random gathers (per hop and lane one
adjacency row and up to R rows of 4D bytes), and in time the chain of
dependent steps of each hop.  One block per lane keeps the beam sorted in
shared memory across all H hops; a hop loads its neighbours' freshness
words at once, copies every fresh row into shared memory at once (TMA bulk
copies where the rows allow), scores them one warp a row, and merges by
binary searches over the sorted beam, which equals the reference's stable
``lax.sort`` of the concatenation.  The seen row (125 KB per lane at
n_cap = 10^6) stays in global memory and only the words a hop touches are
tested and set in place.  The quantized twin (``beam_hop_fused_q``) is the
same kernel over the int8 code table (D bytes a row instead of 4D): the raw
dot accumulates in f32, the row's scale multiplies the product, and the l2
norm term is the cached ``qnorms``.

The carry is the reference's: ``(beam_ids i32[B,l], beam_dists f32[B,l],
beam_exp i32[B,l], seen i32[B,W], vis_ids i32[B,mv], vis_dists f32[B,mv],
n_vis, n_comps, n_hops i32[B])``; ``seen``, ``nav_words`` and ``ret_words``
are the int32 bit patterns of ``core/bitset.py``.  Each lane's
``beam_dists`` must be non-decreasing, as every carry the search makes is
and every super-step leaves it.  The CUDA launchers update the carry
tensors IN PLACE and return them; the plain version returns new tensors.

The kernel ORs two bits into an int32 status word: ``STATUS_UNSORTED``
when a lane's beam was not sorted (that lane is left untouched) and
``STATUS_ACTIVE`` when a lane is still active after its H hops (the
``lane_active`` test on the carry it leaves).  ``BoundBeamHop`` is the
launcher the batched search binds once: every check at binding, then per
super-step one launch and, in ``active()``, one host read of the status.
"""
from __future__ import annotations

import torch

from . import build

LAUNCHES = {"beam_hop_fused": 0, "beam_hop_fused_q": 0}
INF = float("inf")


def _getbit(words, ids):
    w = words[ids >> 5]
    return ((w >> (ids & 31).to(torch.int32)) & 1) != 0


def _lane_hop(metric, l, mv, n_cap, adj, vectors, norms, nav_words,
              ret_words, queries, c, scales=None):
    """ONE masked hop of every lane: ``_lane_hop`` with a batch axis.
    ``scales`` selects the quantized tier: ``vectors`` are then the int8
    codes, the per-row scale multiplies the dot product and ``norms`` are
    the cached qnorms."""
    from ..core.bitset import getbit_rows, setbits_rows

    bi, bd, be, seen, vi, vd, n_vis, n_comps, n_hops = c
    b = bi.shape[0]
    bidx = torch.arange(b, device=bi.device)
    active = ((bi >= 0) & (be == 0) & torch.isfinite(bd)).any(1) & \
        (n_hops < mv)

    frontier_d = torch.where((bi >= 0) & (be == 0), bd,
                             torch.full_like(bd, INF))
    i = torch.argmin(frontier_d, dim=1)
    v = bi[bidx, i]
    dv = bd[bidx, i]
    be = be.clone()
    be[bidx, i] = be[bidx, i] | active.to(be.dtype)
    sv = v.clamp(0, n_cap - 1).long()

    write = active & _getbit(ret_words, sv)
    vi, vd = vi.clone(), vd.clone()
    rows = bidx[write]
    cols = n_vis[write].long()
    vi[rows, cols] = v[write]
    vd[rows, cols] = dv[write]
    n_vis = n_vis + write.to(torch.int32)

    nbrs = adj[sv]                                          # (B, r)
    safe = nbrs.clamp(0, n_cap - 1).long()
    fresh = (nbrs >= 0) & _getbit(nav_words, safe) & \
        ~getbit_rows(seen, safe) & active[:, None]
    masked = torch.where(fresh, nbrs, torch.full_like(nbrs, -1))
    sm = masked.clamp(min=0).long()
    rows_x = vectors[sm].to(torch.float32)                  # (B, r, D)
    prod = torch.bmm(rows_x, queries.unsqueeze(-1)).squeeze(-1)
    if scales is not None:
        prod = prod * scales[sm]
    if metric == "l2":
        q2 = (queries * queries).sum(1, keepdim=True)
        x2 = torch.where(masked >= 0, norms[masked.clamp(0, n_cap - 1).long()],
                         torch.zeros_like(prod))
        nd = q2 + x2 - 2.0 * prod
    else:
        nd = -prod
    nd = torch.where(masked >= 0, nd, torch.full_like(nd, INF))
    n_comps = n_comps + fresh.sum(1).to(torch.int32)
    seen = setbits_rows(seen, safe, fresh)

    all_d = torch.cat([bd, nd], dim=1)
    all_p = torch.cat([(bi << 1) | be, masked << 1], dim=1)
    sd, order = torch.sort(all_d, dim=1, stable=True)
    sp = torch.gather(all_p, 1, order)
    sp = sp[:, :l].contiguous()
    return (sp >> 1, sd[:, :l].contiguous(), sp & 1, seen, vi, vd, n_vis,
            n_comps, n_hops + active.to(torch.int32))


def beam_hop_fused_plain(queries, beam_ids, beam_dists, beam_exp, seen,
                         vis_ids, vis_dists, n_vis, n_comps, n_hops, adj,
                         vectors, norms, nav_words, ret_words, *,
                         metric: str = "l2", h: int = 4, scales=None):
    """The kernel's semantics in plain PyTorch; returns a new carry."""
    n_cap = adj.shape[0]
    l = beam_ids.shape[1]
    mv = vis_ids.shape[1]
    c = (beam_ids, beam_dists, beam_exp.to(torch.int32), seen, vis_ids,
         vis_dists, n_vis.to(torch.int32), n_comps.to(torch.int32),
         n_hops.to(torch.int32))
    for _ in range(h):
        c = _lane_hop(metric, l, mv, n_cap, adj, vectors, norms, nav_words,
                      ret_words, queries, c, scales=scales)
    return c


def beam_hop_fused_q_plain(queries, beam_ids, beam_dists, beam_exp, seen,
                           vis_ids, vis_dists, n_vis, n_comps, n_hops, adj,
                           codes, scales, qnorms, nav_words, ret_words, *,
                           metric: str = "l2", h: int = 4):
    """The quantized kernel's semantics in plain PyTorch; a new carry."""
    return beam_hop_fused_plain(
        queries, beam_ids, beam_dists, beam_exp, seen, vis_ids, vis_dists,
        n_vis, n_comps, n_hops, adj, codes, qnorms, nav_words, ret_words,
        metric=metric, h=h, scales=scales)


STATUS_UNSORTED, STATUS_ACTIVE = 1, 2


def _check(queries, carry, adj, rows, scales, norms, nav_words, ret_words):
    """Every check of a launch, the device last; returns the kernel's
    dimensions (B, l, r, mv, n_cap, W, D)."""
    (beam_ids, beam_dists, beam_exp, seen, vis_ids, vis_dists, n_vis,
     n_comps, n_hops) = carry
    for t, what in ((beam_ids, "beam_ids"), (beam_exp, "beam_exp"),
                    (seen, "seen"), (vis_ids, "vis_ids"), (n_vis, "n_vis"),
                    (n_comps, "n_comps"), (n_hops, "n_hops"), (adj, "adj"),
                    (nav_words, "nav_words"), (ret_words, "ret_words")):
        build.require_dtype(t, torch.int32, what)
    for t, what in ((queries, "queries"), (beam_dists, "beam_dists"),
                    (vis_dists, "vis_dists"), (norms, "norms"),
                    (scales, "scales")):
        build.require_dtype(t, torch.float32, what)
    build.require_dtype(rows, torch.float32 if scales is None
                        else torch.int8, "rows")
    b, l = beam_ids.shape
    n_cap, r = adj.shape
    d = rows.shape[1]
    w = seen.shape[1]
    mv = vis_ids.shape[1]
    if l > 256 or r > 128 or d > 8192:
        raise ValueError(f"beam_hop kernel takes l <= 256, r <= 128, "
                         f"dim <= 8192; got l={l} r={r} dim={d}")
    if (beam_dists.shape != (b, l) or beam_exp.shape != (b, l)
            or seen.shape != (b, w) or vis_dists.shape != (b, mv)
            or any(t.shape != (b,) for t in (n_vis, n_comps, n_hops))
            or nav_words.shape != (w,) or ret_words.shape != (w,)
            or w * 32 < n_cap or queries.shape != (b, d)
            or rows.shape[0] != n_cap or norms.shape != (n_cap,)
            or (scales is not None and scales.shape != (n_cap,))):
        raise ValueError("beam_hop: inconsistent carry shapes")
    if scales is not None and rows.data_ptr() % 4:
        raise ValueError("codes must be 4-byte aligned")
    if not all(t is None or t.is_contiguous()
               for t in (queries, *carry, adj, rows, scales, norms,
                         nav_words, ret_words)):
        raise ValueError("the CUDA kernels need contiguous tensors")
    build.require_cuda(queries, *carry, adj, rows, scales, norms, nav_words,
                       ret_words)
    return b, l, r, mv, n_cap, w, d


def _entry(scales):
    lib = build.lib("beam_hop")
    return lib.beam_hop_launch if scales is None else lib.beam_hop_q_launch


def _tables(rows, scales, norms):
    return (rows, norms) if scales is None else (rows, scales, norms)


def _launch(queries, carry, adj, rows, scales, norms, nav_words, ret_words,
            metric, h, status, key):
    """Check and launch either kernel (``scales`` None: f32 rows).  With no
    ``status`` the launcher makes one and raises on ``STATUS_UNSORTED``
    (one host read)."""
    queries = queries.contiguous()
    dims = _check(queries, carry, adj, rows, scales, norms, nav_words,
                  ret_words)
    own = status is None
    if own:
        status = torch.zeros(1, dtype=torch.int32, device=queries.device)
    else:
        build.require_dtype(status, torch.int32, "status")
        build.require_cuda(queries, status)
    err = _entry(scales)(
        *(build.ptr(t) for t in (queries, *carry, adj,
                                 *_tables(rows, scales, norms), nav_words,
                                 ret_words, status)),
        None, *dims, h, int(metric == "l2"), build.stream(queries))
    build.check(err, key)
    LAUNCHES[key] += 1
    if own and int(status[0]) & STATUS_UNSORTED:
        raise RuntimeError(f"{key}: a lane's beam is not sorted by distance")
    return carry


class BoundBeamHop:
    """The fused super-step bound to one search: its queries, its carry
    (updated in place; ``beam_exp`` int32), the adjacency, the f32 rows and
    norms or (with ``scales``) the int8 codes, scales and qnorms, the packed
    masks, the metric and H.

    Binding runs every check of ``beam_hop_fused_cuda`` (dtypes, shapes,
    l <= 256, r <= 128, dim <= 8192, the codes' alignment, contiguous CUDA
    tensors on one device) and caches the ``ctypes`` function, the
    pointers and the raw stream handle; it raises on anything the kernel
    does not take and never falls back to the plain version.  ``bound(
    carry)`` takes the bound carry itself (``bound.carry``), launches one
    super-step in place and returns it; ``active()`` reads, with one host read, whether any lane
    is still active after the last launch, and raises when a lane's beam
    was not sorted.  Two status words alternate, so a launch clears the
    word of the next one and no call needs a memset."""

    __slots__ = ("_keep", "carry", "_fn", "_ptrs", "_dims", "_stream",
                 "_status", "_words", "_k", "_key")

    def __init__(self, queries, carry, adj, rows, norms, nav_words,
                 ret_words, *, metric: str = "l2", h: int = 4, scales=None):
        queries = queries.contiguous()
        dims = _check(queries, tuple(carry), adj, rows, scales, norms,
                      nav_words, ret_words)
        tables = _tables(rows, scales, norms)
        self._status = torch.zeros(2, dtype=torch.int32,
                                   device=queries.device)
        self._words = (self._status.data_ptr(), self._status.data_ptr() + 4)
        self._keep = (queries, adj, *tables, nav_words, ret_words)
        self.carry = carry
        self._fn = _entry(scales)
        self._ptrs = tuple(t.data_ptr() for t in (queries, *carry, adj,
                                                  *tables, nav_words,
                                                  ret_words))
        self._dims = (*dims, h, int(metric == "l2"))
        self._stream = build.stream(queries)
        self._k = 0
        self._key = "beam_hop_fused" if scales is None else "beam_hop_fused_q"

    def __call__(self, carry):
        if len(carry) != 9 or any(a is not b
                                  for a, b in zip(carry, self.carry)):
            raise ValueError("BoundBeamHop: not the carry it was bound to")
        k = self._k
        err = self._fn(*self._ptrs, self._words[k], self._words[k ^ 1],
                       *self._dims, self._stream)
        build.check(err, self._key)
        LAUNCHES[self._key] += 1
        self._k = k ^ 1
        return carry

    def active(self) -> bool:
        """Whether a lane is still active after the last launch."""
        word = self._status.tolist()[self._k ^ 1]
        if word & STATUS_UNSORTED:
            raise RuntimeError(f"{self._key}: a lane's beam is not sorted "
                               f"by distance")
        return bool(word & STATUS_ACTIVE)


def beam_hop_fused_cuda(queries, beam_ids, beam_dists, beam_exp, seen,
                        vis_ids, vis_dists, n_vis, n_comps, n_hops, adj,
                        vectors, norms, nav_words, ret_words, *,
                        metric: str = "l2", h: int = 4, status=None):
    """Launch the kernel: updates the carry in place and returns it.
    ``status`` (int32, on the card) collects the ``STATUS_*`` bits."""
    carry = (beam_ids, beam_dists, beam_exp, seen, vis_ids, vis_dists,
             n_vis, n_comps, n_hops)
    return _launch(queries, carry, adj, vectors, None, norms, nav_words,
                   ret_words, metric, h, status, "beam_hop_fused")


def beam_hop_fused_q_cuda(queries, beam_ids, beam_dists, beam_exp, seen,
                          vis_ids, vis_dists, n_vis, n_comps, n_hops, adj,
                          codes, scales, qnorms, nav_words, ret_words, *,
                          metric: str = "l2", h: int = 4, status=None):
    """Launch the quantized kernel: updates the carry in place and returns
    it.  ``status`` as for ``beam_hop_fused_cuda``."""
    carry = (beam_ids, beam_dists, beam_exp, seen, vis_ids, vis_dists,
             n_vis, n_comps, n_hops)
    return _launch(queries, carry, adj, codes, scales, qnorms, nav_words,
                   ret_words, metric, h, status, "beam_hop_fused_q")


def beam_hop_fused(*args, metric: str = "l2", h: int = 4):
    """Plain version for CPU tensors, the kernel for CUDA tensors."""
    if build.on_cpu(*args):
        return beam_hop_fused_plain(*args, metric=metric, h=h)
    return beam_hop_fused_cuda(*args, metric=metric, h=h)


def beam_hop_fused_q(*args, metric: str = "l2", h: int = 4):
    """Plain version for CPU tensors, the quantized kernel for CUDA
    tensors."""
    if build.on_cpu(*args):
        return beam_hop_fused_q_plain(*args, metric=metric, h=h)
    return beam_hop_fused_q_cuda(*args, metric=metric, h=h)
