"""Shared transformer building blocks (``repro/models/layers.py``): pure
functions over parameter trees, on PyTorch tensors.

The arithmetic is the reference's, cast for cast:

  * norms and RoPE compute in float32 and cast back to the input's dtype;
    ``nonparam_layer_norm``'s variance is ``mean(square(x - mu))``, as
    ``jnp.var`` computes it;
  * attention's scores are float32 from (possibly bfloat16) operands (the
    reference's ``preferred_element_type=float32``: exact products, float32
    sums), the softmax is ``exp(x - max) / sum`` in float32, and the
    weights are cast back to the operands' dtype before ``w @ v``;
  * ``_chunked_attention`` is the reference's online softmax over
    ``q_chunk`` x ``kv_chunk`` tiles with its guards for fully-masked
    rows.  Under ``causal``, a key tile wholly after a query tile is
    skipped: in the reference it leaves the running (max, denominator,
    accumulator) as they were (p = 0, correction 1), so skipping it
    changes no value; and the mask is applied only to the tiles that
    straddle the diagonal (elsewhere it keeps every score).

``constrain`` is the reference's sharding anchor: a DTensor is
redistributed to the spec's placements on its own mesh; a plain tensor (no
mesh) or a None spec passes as it is, as the reference's is a no-op
without a mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_F32 = torch.float32


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x, spec):
    """The reference's ``with_sharding_constraint``: ``x`` redistributed to
    the placements of ``spec`` (a ``configs.base.PartitionSpec``) on its
    mesh when ``x`` is a DTensor; else ``x`` itself, as is a None spec.
    As JAX's, the anchor holds for the gradient too: ``redistribute``
    brings the gradient back to ``x``'s placements, even where the forward
    moves nothing."""
    if spec is None or not is_dtensor(x):
        return x
    from ..configs.base import placements

    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def _placed(x, mesh):
    """``x`` itself if a DTensor, else ``x`` replicated on ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate

    if is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _from_local(local, mesh, placements, shape):
    """A DTensor of global ``shape`` over each device's ``local`` (made
    contiguous: the DTensor states a contiguous stride for its shard)."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def take_on_shards(table, ids, fix=None):
    """Rows of ``table`` (dim 0) at ``ids``, of shape ``ids.shape +
    table.shape[1:]``.  ``fix(ids, n)`` gives ``(rows, nan)``: the row of
    each id in ``[0, n)`` and a mask of the ids whose rows are NaN (or
    None); default the ids themselves.

    Plain tensors take the rows as they are.  Where either is a DTensor,
    the lookup runs on each device's local tensors, so its arithmetic is
    the plain one's and no index op meets DTensor's sharding propagation
    (PyTorch 2.11's has no strategy for an indexed table's gradient,
    ``index_put``, with split values).  On each mesh dim:

      * a table split over its rows, with fewer ids than rows (an
        embedding table): the ids are gathered and each device looks up
        those of its own rows (zeros elsewhere), a partial sum that meets
        on the ids' split, or splits the rows' first dim where the ids
        have none; its gradient is each device's own rows';
      * else the ids keep their split and the rows follow it, the table
        whole along dim 0 (gathered: fewer rows than ids, e.g. a graph's
        nodes under its edges); its gradient is a partial sum, brought
        back to the table's placements;
      * a split of another table dim is kept where the ids are whole."""
    fix = fix or _as_rows
    if not (is_dtensor(table) or is_dtensor(ids)):
        return _take_local(table, ids, fix, table.shape[0], None)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = (table if is_dtensor(table) else ids).device_mesh
    table, ids = _placed(table, mesh), _placed(ids, mesh)
    by_rows = ids.numel() < table.shape[0]
    t_pl, i_pl, out_pl, grad_pl, final_pl = [], [], [], [], []
    rows_split = 1
    for m, (tp, ip) in enumerate(zip(table.placements, ids.placements)):
        if by_rows and tp == Shard(0):
            t_pl.append(tp)
            i_pl.append(Replicate())
            out_pl.append(Partial())
            grad_pl.append(tp)
            if type(ip) is Shard:
                final_pl.append(ip)
            elif ids.shape[0] % (rows_split * mesh.size(m)) == 0:
                final_pl.append(Shard(0))
            else:
                final_pl.append(Replicate())
        elif type(ip) is Shard:
            t_pl.append(Replicate())
            i_pl.append(ip)
            out_pl.append(ip)
            grad_pl.append(Partial())
            final_pl.append(ip)
        elif type(tp) is Shard and tp.dim > 0:
            t_pl.append(tp)
            i_pl.append(Replicate())
            out_pl.append(Shard(ids.ndim + tp.dim - 1))
            grad_pl.append(tp)
            final_pl.append(out_pl[-1])
        else:
            t_pl.append(Replicate())
            i_pl.append(Replicate())
            out_pl.append(Replicate())
            grad_pl.append(Replicate())
            final_pl.append(Replicate())
        if final_pl[-1] == Shard(0):
            rows_split *= mesh.size(m)
    lo = None
    if Shard(0) in t_pl:
        lo = compute_local_shape_and_global_offset(table.shape, mesh,
                                                   t_pl)[1][0]
    local = _take_local(
        table.redistribute(mesh, t_pl).to_local(grad_placements=grad_pl),
        ids.redistribute(mesh, i_pl).to_local(), fix, table.shape[0], lo)
    out = _from_local(local, mesh, out_pl,
                      tuple(ids.shape) + tuple(table.shape[1:]))
    return out if out_pl == final_pl else out.redistribute(mesh, final_pl)


def _as_rows(ids, n):
    return ids, None


def _take_local(table, ids, fix, n, lo):
    """``take_on_shards`` on one device: ``table`` holds the global rows
    ``lo, lo + 1, ...`` of ``n`` (all of them where ``lo`` is None); a row
    held elsewhere is zeros."""
    rows, nan = fix(ids, n)
    if lo is None:
        out = table[rows]
    else:
        rows = rows - lo
        mine = (rows >= 0) & (rows < table.shape[0])
        out = table[rows.clamp(0, table.shape[0] - 1)].masked_fill(
            ~mine.unsqueeze(-1), 0.0)
    # the NaN fill in place on the gathered rows: it spares a second copy
    # of them, 4 E d bytes for the GCN's edge messages (11.6 GB at
    # ogb_products' 61,859,328 edges and its last layer's 47 classes).
    # Under autograd their gradient is dropped, as ``jnp.take``'s is
    return out if nan is None else out.masked_fill_(nan.unsqueeze(-1),
                                                    float("nan"))


def add_on_shards(add, src, idx):
    """``add(src, idx)``: ``src``'s rows (dim 0) summed into the rows that
    ``idx`` (one entry a row of ``src``) picks, of shape ``(n,) +
    src.shape[1:]`` (a segment sum, an ``index_add``).  Plain tensors go to
    ``add`` as they are.  Where either is a DTensor, ``add`` runs on each
    device's local rows (PyTorch 2.11 has no ``index_add`` strategy): idx
    is brought to src's split of dim 0, and the sum is a partial one over
    the mesh dims that split src's rows (it meets where a later op needs
    it; an integer one at once) and split as src on its other dims."""
    if not (is_dtensor(src) or is_dtensor(idx)):
        return add(src, idx)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = (src if is_dtensor(src) else idx).device_mesh
    src, idx = _placed(src, mesh), _placed(idx, mesh)
    s_pl, i_pl, out_pl, grad_pl = [], [], [], []
    for sp in src.placements:
        if type(sp) is Shard and sp.dim == 0:
            s_pl.append(sp)
            i_pl.append(Shard(0))
            out_pl.append(Partial())
            grad_pl.append(sp)
        elif type(sp) is Shard or sp.is_partial():
            s_pl.append(sp)
            i_pl.append(Replicate())
            out_pl.append(sp)
            grad_pl.append(sp if type(sp) is Shard else Replicate())
        else:
            s_pl.append(Replicate())
            i_pl.append(Replicate())
            out_pl.append(Replicate())
            grad_pl.append(Replicate())
    local = add(src.redistribute(mesh, s_pl).to_local(
        grad_placements=grad_pl), idx.redistribute(mesh, i_pl).to_local())
    out = _from_local(local, mesh, out_pl,
                      (local.shape[0],) + tuple(src.shape[1:]))
    if out.dtype.is_floating_point or Partial() not in out_pl:
        return out
    # an integer sum (a count) meets at once: DTensor's ops on a pending
    # integer sum may promote it (a cumsum of one comes back float32)
    return out.redistribute(mesh, [Replicate() if p == Partial() else p
                                   for p in out_pl])


def rms_norm(x, weight, eps=1e-6):
    xf = x.to(_F32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight).to(x.dtype)


def nonparam_layer_norm(x, eps=1e-5):
    """OLMo-style non-parametric LayerNorm (no scale, no bias)."""
    xf = x.to(_F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    centered = xf - mu
    var = torch.mean(centered * centered, dim=-1, keepdim=True)
    return (centered * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(kind: str, x, weight=None):
    if kind == "rmsnorm":
        return rms_norm(x, weight)
    return nonparam_layer_norm(x)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 1e6, device=None):
    """``1 / theta ** (arange(0, hd, 2) / hd)`` as the jitted reference
    computes it: XLA rewrites the quotient into ``theta ** -e``, a correctly
    rounded float32 power (the float64 power, rounded, here)."""
    exps = torch.arange(0, head_dim, 2, dtype=_F32, device=device) / head_dim
    return torch.pow(theta, -exps.double()).to(_F32)


def apply_rope(x, positions, theta: float = 1e6):
    """x: (..., S, n_heads, head_dim); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)           # (hd/2,)
    angles = positions[..., None].to(_F32) * freqs           # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(_F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA) — plain for short sequences, chunked online-softmax for long
# ---------------------------------------------------------------------------


def _scale(hd: int) -> float:
    """``1 / sqrt(hd)`` rounded as the reference rounds it: a float32
    square root, then a float32 reciprocal."""
    return float(1.0 / torch.sqrt(torch.tensor(float(hd), dtype=_F32)))


def matmul_f32(a, b):
    """``a @ b`` (batched, 3-D) with float32 products and sums: the
    reference's ``preferred_element_type=float32``.  Products of bfloat16
    operands are exact in float32, so on the card, outside autograd,
    cuBLAS's bfloat16 product with a float32 result computes the same as
    the float32 product of the widened operands, at a third of the time;
    elsewhere the operands are widened."""
    if (a.is_cuda and a.dtype == b.dtype == torch.bfloat16
            and not (torch.is_grad_enabled()
                     and (a.requires_grad or b.requires_grad))):
        return torch.bmm(a, b, out_dtype=_F32)
    return torch.bmm(a.to(_F32), b.to(_F32))


def _scores(q, k, scale: float):
    """q (B,S,KV,G,hd), k (B,T,KV,hd) -> float32 (B,KV,G,S,T) * scale."""
    b, s, n_kv, g, hd = q.shape
    t = k.shape[1]
    qm = q.permute(0, 2, 3, 1, 4).reshape(b * n_kv, g * s, hd)
    km = k.permute(0, 2, 3, 1).reshape(b * n_kv, hd, t)
    return matmul_f32(qm, km).view(b, n_kv, g, s, t).mul_(scale)


def _weighted_values(w, v, out_f32: bool):
    """w (B,KV,G,S,T), v (B,T,KV,hd) -> (B,S,KV,G,hd): float32 sums, the
    result float32 (``out_f32``) or in v's dtype."""
    b, n_kv, g, s, t = w.shape
    hd = v.shape[-1]
    wm = w.reshape(b * n_kv, g * s, t)
    vm = v.permute(0, 2, 1, 3).reshape(b * n_kv, t, hd)
    out = matmul_f32(wm, vm) if out_f32 else torch.bmm(wm, vm)
    return out.view(b, n_kv, g, s, hd).permute(0, 3, 1, 2, 4)


def _softmax(scores):
    """``jax.nn.softmax``: ``exp(x - max) / sum``, the max held constant
    under autograd."""
    m = torch.amax(scores, dim=-1, keepdim=True).detach()
    u = torch.exp(scores - m)
    return u / torch.sum(u, dim=-1, keepdim=True)


def _plain_attention(q, k, v, *, causal, q_offset=0, kv_len=None):
    """q: (B,S,KV,G,hd)  k,v: (B,T,KV,hd).  Returns (B,S,KV,G,hd)."""
    s, t = q.shape[1], k.shape[1]
    scores = _scores(q, k, _scale(q.shape[-1]))
    if causal:
        qpos = q_offset + torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(t, device=q.device)[None, :]
        scores = scores.masked_fill(kpos > qpos, float("-inf"))
    if kv_len is not None:
        valid = (torch.arange(t, device=q.device)[None, :]
                 < kv_len[:, None])                           # (B, T)
        scores = scores.masked_fill(~valid[:, None, None, None, :],
                                    float("-inf"))
    w = _softmax(scores).to(q.dtype)
    return _weighted_values(w, v, out_f32=False)


def _chunked_attention(q, k, v, *, causal, q_chunk=2048, kv_chunk=2048):
    """Memory-efficient online-softmax attention: a loop over query chunks,
    and within it over KV chunks carrying the running (max, denom,
    accumulator).  Never materialises the (S, T) score matrix — the peak
    intermediate is (B, KV, G, q_chunk, kv_chunk).  As the reference, keys
    past the last whole KV chunk are not read, and S must be a multiple of
    ``q_chunk``."""
    b, s, n_kv, g, hd = q.shape
    t = k.shape[1]
    nq, nk = s // q_chunk, t // kv_chunk
    if nq * q_chunk != s:
        raise ValueError(f"chunked attention over S = {s} queries needs a "
                         f"multiple of q_chunk = {q_chunk}")
    scale = _scale(hd)
    inf = float("-inf")
    chunks = []
    for qi in range(nq):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        m = torch.full((b, n_kv, g, q_chunk), inf, dtype=_F32,
                       device=q.device)
        l = torch.zeros((b, n_kv, g, q_chunk), dtype=_F32, device=q.device)
        acc = torch.zeros((b, q_chunk, n_kv, g, hd), dtype=_F32,
                          device=q.device)
        for ki in range(nk):
            k_lo = ki * kv_chunk
            if causal and k_lo > qi * q_chunk + q_chunk - 1:
                continue          # every key after every query: p = 0
            kc = k[:, k_lo:k_lo + kv_chunk]
            vc = v[:, k_lo:k_lo + kv_chunk]
            sc = _scores(qc, kc, scale)
            if causal and k_lo + kv_chunk - 1 > qi * q_chunk:
                k_pos = k_lo + torch.arange(kv_chunk, device=q.device)
                sc = sc.masked_fill(k_pos[None, :] > q_pos[:, None], inf)
            m_new = torch.maximum(m, torch.amax(sc, dim=-1))
            # guard fully-masked rows (m_new = -inf)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(torch.isfinite(sc),
                            torch.exp(sc - m_safe[..., None]), 0.0)
            del sc
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = corr * l + torch.sum(p, dim=-1)
            pv = _weighted_values(p.to(q.dtype), vc, out_f32=True)
            del p
            acc = corr.permute(0, 3, 1, 2)[..., None] * acc + pv
            m = m_new
        denom = torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
        chunks.append((acc / denom).to(q.dtype))
    return torch.cat(chunks, dim=1)


def gqa_attention(q, k, v, *, causal=True, q_offset=0, kv_len=None,
                  chunked_threshold=8192):
    """Dispatch between plain and chunked attention by sequence length;
    DTensors go device by device (``_sharded_attention``) unless the keys
    are split over their sequence (a decode cache), where DTensor's own
    ops keep that split and q keeps only its batch split: the scores'
    flatten of (batch, KV heads) must not meet a split KV-head axis, which
    PyTorch 2.11's DTensor cannot flatten."""
    if is_dtensor(q):
        if not _sequence_split(k):
            return _sharded_attention(q, k, v, causal=causal,
                                      q_offset=q_offset, kv_len=kv_len,
                                      chunked_threshold=chunked_threshold)
        from torch.distributed.tensor import Replicate, Shard

        # its local block made contiguous: the scores' reshape views the
        # local tensor where the global strides allow, and PyTorch 2.11's
        # gathered block may be a strided view
        pl = [p if p == Shard(0) else Replicate() for p in q.placements]
        q = _from_local(q.redistribute(q.device_mesh, pl).to_local(),
                        q.device_mesh, pl, q.shape)
    s, t = q.shape[1], k.shape[1]
    if s == t and s > chunked_threshold and kv_len is None:
        return _chunked_attention(q, k, v, causal=causal)
    return _plain_attention(q, k, v, causal=causal, q_offset=q_offset,
                            kv_len=kv_len)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, its gradient made contiguous on the way back."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _sequence_split(k) -> bool:
    from torch.distributed.tensor import Shard

    return is_dtensor(k) and any(isinstance(p, Shard) and p.dim == 1
                                 for p in k.placements)


def _sharded_attention(q, k, v, *, causal, q_offset, kv_len,
                       chunked_threshold):
    """Attention on DTensors q (B,S,KV,G,hd), k / v (B,T,KV,hd), device by
    device: attention is independent per (batch row, KV head), so q, k and
    v are brought to one layout that keeps q's splits of the batch (dim 0)
    and KV-head (dim 2) axes and replicates the rest, and each device runs
    ``gqa_attention`` on its own block (the same values as on the whole
    tensors).  This spares DTensor the strided splits of the reshapes
    inside, which its redistribution planner searches at length."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    layout = [p if type(p) is Shard and p.dim in (0, 2) else Replicate()
              for p in q.placements]
    # each block's gradient made contiguous on its way back: DTensor runs
    # the views before it on the local layout it is handed
    ql, kl, vl = (_ContiguousGrad.apply(
        x.redistribute(mesh, layout).to_local()) for x in (q, k, v))
    if kv_len is not None:
        kv_len = _placed(kv_len, mesh).redistribute(mesh, [
            p if p == Shard(0) else Replicate() for p in layout]).to_local()
    out = gqa_attention(ql, kl, vl, causal=causal, q_offset=q_offset,
                        kv_len=kv_len, chunked_threshold=chunked_threshold)
    return _from_local(out, mesh, layout, q.shape)


# ---------------------------------------------------------------------------
# MLPs and the loss
# ---------------------------------------------------------------------------


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def cross_entropy_loss(logits, labels, ignore_id: int = -1):
    """Token-mean CE in fp32.  logits (..., V), labels (...,) int.

    As the reference's ``take_along_axis``, a label at or past V reads a
    NaN logit; a negative label reads class 0, and ``ignore_id`` is left
    out of the mean."""
    logits = logits.to(_F32)
    lse = torch.logsumexp(logits, dim=-1)
    v = logits.shape[-1]
    lab = torch.clamp(labels.long(), min=0)
    if is_dtensor(logits):
        # the gather as a masked sum over the (possibly split) vocabulary:
        # each device keeps its own label columns, zeros elsewhere, and the
        # sum meets them; the same value (x plus zeros is x).  Plain
        # logits take the gather, which spares a float32 select and a bool
        # mask as large as the logits (5 bytes a logit)
        hit = (torch.arange(v, device=logits.device)
               == lab.clamp(max=v - 1)[..., None])
        ll = torch.where(hit, logits, 0.0).sum(-1)
    else:
        ll = torch.gather(logits, -1,
                          lab.clamp(max=v - 1)[..., None])[..., 0]
    ll = ll.masked_fill(lab >= v, float("nan"))
    nll = lse - ll
    mask = labels != ignore_id
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)


__all__ = ["add_on_shards", "apply_norm", "apply_rope", "constrain",
           "cross_entropy_loss", "gqa_attention", "is_dtensor", "matmul_f32",
           "nonparam_layer_norm", "rms_norm", "rope_freqs", "swiglu",
           "take_on_shards"]
