"""Decoder-only transformer family (``repro/models/transformer.py``):
Qwen2/2.5, Qwen3-MoE and OLMo, on PyTorch tensors, with GQA attention and
optional QKV bias / non-parametric LN / MoE.

Step functions, per serving kind:
  * ``loss_fn`` / ``forward`` — causal LM loss over (B, S) token batches;
  * ``prefill``               — build the KV cache for a prompt batch;
  * ``decode_step``           — one token with a (B, S_max) KV cache.

The parameter tree is the reference's: ``layers`` holds every layer's
weights stacked on a leading (L, ...) axis (the reference scans over it;
here a loop takes each layer's slices, ``torch.unbind``, whose gradient is
one stack).  ``remat`` is ``torch.utils.checkpoint.checkpoint`` (not
reentrant) around each layer, and ``remat_block`` > 1 (dividing L) adds
the reference's outer checkpoint around each block of layers; both change
memory, not values.

Two indexing semantics follow JAX rather than PyTorch:
  * the embedding lookup is ``embed[tokens]``: a negative id wraps once,
    then every id is clamped into [0, V) (plain indexing would raise);
  * ``decode_step``'s cache write at ``len`` drops the write when ``len``
    is past the cache (the reference's scatter out of bounds), after a
    negative ``len`` wraps once.  The cache is written in place: the
    returned cache holds the same ``k`` / ``v`` tensors, a new ``len``.

The activation anchors are the reference's: with ``dp_axes`` set (by
``LMSpec.make_step(shape, axes)``) ``act`` gives a ``PartitionSpec`` and
``layers.constrain`` redistributes a DTensor activation to it at the same
points of the layer; on plain tensors every anchor is the identity.  The
prefill's per-layer K / V go into one preallocated stack, or, when they
are DTensors (which cannot be written into a plain buffer), are stacked
at the end with their placements.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.types import resolve_device
from .layers import (apply_norm, apply_rope, constrain, cross_entropy_loss,
                     gqa_attention, is_dtensor, take_on_shards)
from .moe import MoEConfig, init_moe_params, moe_ffn
from .recsys import _normal


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    norm: str = "rmsnorm"           # "rmsnorm" | "nonparam_ln" (OLMo)
    rope_theta: float = 1e6
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = False
    remat: bool = True
    # activation-sharding anchors: (dp_axes, tp_axis) or None
    dp_axes: Optional[Tuple[str, ...]] = None
    tp_axis: Optional[str] = None
    # how attention is split over tp_axis, chosen per arch by divisibility:
    #   "kv": kv-head axis (kv_heads % tp == 0); "q": q-head axis, KV
    #   replicated; "hd": head_dim axis
    attn_shard: str = "kv"
    # Megatron-style sequence parallelism for train/prefill: the residual
    # stream shards S over tp
    seq_parallel: bool = False
    # nested ("sqrt") remat: checkpoint blocks of remat_block layers
    remat_block: int = 1

    def act(self, *dims):
        """PartitionSpec for an activation.  Entries:
        "dp" (batch axes) | "tp" (tensor axis) | "sp" (tp when
        seq_parallel else unsharded) | "dp+sp" (flattened token dim) | None.
        """
        if self.dp_axes is None:
            return None
        from ..configs.base import PartitionSpec

        def one(d):
            if d == "dp":
                return self.dp_axes
            if d == "tp":
                return self.tp_axis
            if d == "sp":
                return self.tp_axis if self.seq_parallel else None
            if d == "dp+sp":
                return (
                    tuple(self.dp_axes) + (self.tp_axis,)
                    if self.seq_parallel else self.dp_axes
                )
            return None

        return PartitionSpec(*[one(d) for d in dims])

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    def n_params(self) -> int:
        """Total parameter count (for roofline MODEL_FLOPS)."""
        d, hd, h, kv, v = (self.d_model, self.hd, self.n_heads,
                           self.n_kv_heads, self.vocab)
        attn = d * hd * (h + 2 * kv) + h * hd * d
        if self.moe:
            ff = (self.moe.n_experts * 3 * d * self.moe.d_ff_expert
                  + d * self.moe.n_experts)
        else:
            ff = 3 * d * self.d_ff
        embed = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ff) + embed

    def n_active_params(self) -> int:
        """Active-per-token parameters (MoE: top_k experts only)."""
        if not self.moe:
            return self.n_params()
        d, hd, h, kv, v = (self.d_model, self.hd, self.n_heads,
                           self.n_kv_heads, self.vocab)
        attn = d * hd * (h + 2 * kv) + h * hd * d
        ff = (self.moe.top_k * 3 * d * self.moe.d_ff_expert
              + d * self.moe.n_experts)
        embed = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ff) + embed


# ---------------------------------------------------------------------------
# Parameter init (stacked layers)
# ---------------------------------------------------------------------------


def init_params(generator, cfg: TransformerConfig, dtype=torch.float32,
                device=None):
    """The reference's tree, shapes, dtypes and scales, drawn from
    ``generator`` on ``device`` (``"meta"``: shapes only): N(0, 1/d) input
    projections, N(0, 1/(h*hd)) for ``wo``, N(0, 1/d_ff) for ``w_down``,
    0.02 for the embedding, ones for RMSNorm weights, zero QKV biases; an
    OLMo-style arch has no norm weights and a zero-size ``final_norm``."""
    dev = resolve_device(device)
    d, hd, h, kv, n = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, \
        cfg.n_layers
    s_in = 1.0 / d ** 0.5

    def normal(shape, scale):
        return _normal(generator, shape, dtype, dev, scale)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    layers = {
        "wq": normal((n, d, h, hd), s_in),
        "wk": normal((n, d, kv, hd), s_in),
        "wv": normal((n, d, kv, hd), s_in),
        "wo": normal((n, h, hd, d), 1.0 / (h * hd) ** 0.5),
    }
    if cfg.norm == "rmsnorm":
        layers["attn_norm"] = ones((n, d))
        layers["mlp_norm"] = ones((n, d))
    if cfg.qkv_bias:
        layers["bq"] = zeros((n, h, hd))
        layers["bk"] = zeros((n, kv, hd))
        layers["bv"] = zeros((n, kv, hd))
    if cfg.moe:
        layers["moe"] = init_moe_params(generator, d, cfg.moe, dtype, dev,
                                        lead=(n,))
    else:
        layers["w_gate"] = normal((n, d, cfg.d_ff), s_in)
        layers["w_up"] = normal((n, d, cfg.d_ff), s_in)
        layers["w_down"] = normal((n, cfg.d_ff, d), 1.0 / cfg.d_ff ** 0.5)
    params = {
        "embed": normal((cfg.vocab, d), 0.02),
        "layers": layers,
        "final_norm": ones((d,)) if cfg.norm == "rmsnorm" else zeros((0,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab), s_in)
    return params


def layer_slices(layers, n_layers: int):
    """The stacked ``layers`` tree as a list of per-layer trees (views)."""
    out = [{} for _ in range(n_layers)]
    for key, leaf in layers.items():
        parts = (layer_slices(leaf, n_layers) if isinstance(leaf, dict)
                 else torch.unbind(leaf, 0))
        for i in range(n_layers):
            out[i][key] = parts[i]
    return out


def embed_lookup(embed, tokens):
    """``embed[tokens]`` as JAX indexes: a negative id wraps once, then
    every id is clamped into range.  On DTensors it runs on each device's
    local tensors (``layers.take_on_shards``)."""
    return take_on_shards(embed, tokens, _embed_rows)


def _embed_rows(tokens, v: int):
    ids = tokens.long()
    return torch.where(ids < 0, ids + v, ids).clamp_(0, v - 1), None


# ---------------------------------------------------------------------------
# Layer body
# ---------------------------------------------------------------------------


def _proj(x, w):
    """``einsum("bsd,d...->bs...", x, w)``: x (B, S, d) @ w (d, ...).  A
    DTensor w (d, heads, head_dim) split over its head_dim ("q" / "hd"
    attention sharding) takes one product per head, stacked: the merged
    (heads x head_dim) axis of the one product cannot carry that split."""
    b, s, d = x.shape
    if is_dtensor(w) and _splits_dim(w, 2):
        return torch.stack([torch.matmul(x, w[:, i])
                            for i in range(w.shape[1])], dim=2)
    return torch.matmul(x, w.reshape(d, -1)).reshape((b, s) + w.shape[1:])


def _splits_dim(t, dim: int) -> bool:
    from torch.distributed.tensor import Shard

    return any(isinstance(p, Shard) and p.dim == dim for p in t.placements)


def _project_qkv(p, cfg: TransformerConfig, x, positions):
    b, s, _ = x.shape
    q = _proj(x, p["wq"].to(x.dtype))
    k = _proj(x, p["wk"].to(x.dtype))
    v = _proj(x, p["wv"].to(x.dtype))
    if cfg.seq_parallel:
        # sequence parallel: q shards S over tp; k / v carry the whole
        # sequence
        q = constrain(q, cfg.act("dp", "sp", None, None))
        kv_spec = cfg.act("dp", None, None, None)
    else:
        # on the head axes, however the params are sharded
        q = constrain(q, cfg.act("dp", None, "tp", None))
        kv_spec = cfg.act("dp", None, "tp", None)
    k = constrain(k, kv_spec)
    v = constrain(v, kv_spec)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if is_dtensor(q):
        q = _fit_heads(q, cfg.n_kv_heads)
    q = q.reshape(b, s, cfg.n_kv_heads, cfg.groups, cfg.hd)
    return q, k, v


def _fit_heads(q, n_kv: int):
    """A DTensor q (B, S, H, hd) whose split of the heads axis the (KV, G)
    unflatten cannot keep (KV not a multiple of the split) with that split
    dropped (the heads replicated there), where GSPMD pads."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 2
          and n_kv % mesh.size(i) else p for i, p in enumerate(q.placements)]
    return q if pl == list(q.placements) else q.redistribute(mesh, pl)


def _out_proj(attn, wo, x):
    """``einsum("bshx,hxd->bsd", attn, wo)``.  A DTensor ``attn`` is held
    on its layout for the gradient too (a redistribute that moves nothing
    forward), before and after its (heads, head_dim) flatten: a gradient
    split over heads would not unflatten into the (KV, G) heads of the
    attention behind it, nor (on PyTorch 2.11) one split over the
    flattened axis into (heads, head_dim)."""
    b, s = attn.shape[:2]
    flat = _held(_held(attn).reshape(b, s, -1))
    if is_dtensor(wo) and _splits_dim(wo, 1):
        # wo (heads, head_dim, d) split over head_dim ("hd" attention
        # sharding) gathered there: the flatten of (heads, head_dim) below
        # cannot carry that split on PyTorch 2.11
        from torch.distributed.tensor import Replicate, Shard

        wo = wo.redistribute(wo.device_mesh, [
            Replicate() if p == Shard(1) else p for p in wo.placements])
    return torch.matmul(flat, wo.to(x.dtype).reshape(-1, wo.shape[-1]))


def _held(x):
    """A DTensor redistributed to its own placements (the identity forward),
    so that its gradient comes back on them; any other tensor itself."""
    return x.redistribute(x.device_mesh, x.placements) if is_dtensor(x) \
        else x


def _mlp_block(p, cfg: TransformerConfig, h):
    """SwiGLU with the hidden-state anchor: ff over tp normally, S over tp
    under sequence parallelism."""
    g = F.silu(h @ p["w_gate"].to(h.dtype))
    u = h @ p["w_up"].to(h.dtype)
    spec = (cfg.act("dp", "sp", None) if cfg.seq_parallel
            else cfg.act("dp", None, "tp"))
    return constrain(g * u, spec) @ p["w_down"].to(h.dtype)


def _ffn(p, cfg: TransformerConfig, x, h):
    """x + the layer's MLP (or MoE) of h; and the MoE's aux loss."""
    if cfg.moe:
        out, aux = moe_ffn(p["moe"], h.reshape(-1, cfg.d_model), cfg.moe,
                           dp_spec=cfg.act("dp+sp", None),
                           ep_spec=cfg.act("tp", None, None))
        return x + out.reshape(x.shape), aux
    return x + _mlp_block(p, cfg, h), None


def _layer_train(p, cfg: TransformerConfig, x, positions):
    x = constrain(x, cfg.act("dp", "sp", None))
    h = apply_norm(cfg.norm, x, p.get("attn_norm"))
    q, k, v = _project_qkv(p, cfg, h, positions)
    attn = gqa_attention(q, k, v, causal=True)
    b, s = x.shape[:2]
    x = x + _out_proj(attn.reshape(b, s, cfg.n_heads, cfg.hd), p["wo"], x)
    x = constrain(x, cfg.act("dp", "sp", None))
    h = apply_norm(cfg.norm, x, p.get("mlp_norm"))
    x, aux = _ffn(p, cfg, x, h)
    return constrain(x, cfg.act("dp", "sp", None)), \
        _zero(x) if aux is None else aux


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _final_logits(params, cfg: TransformerConfig, x, eq, spec):
    x = apply_norm(cfg.norm, x,
                   params["final_norm"] if cfg.norm == "rmsnorm" else None)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return constrain(torch.einsum(eq, x, head.to(x.dtype)), spec)


def forward(params, cfg: TransformerConfig, tokens,
            compute_dtype=torch.bfloat16):
    """Training/prefill forward.  tokens (B, S) -> (logits (B, S, V), aux)."""
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens).to(compute_dtype)
    x = constrain(x, cfg.act("dp", "sp", None))
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    layers = layer_slices(params["layers"], cfg.n_layers)

    def one_layer(p, x):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(_layer_train, p, cfg, x, positions,
                              use_reentrant=False)
        return _layer_train(p, cfg, x, positions)

    blk = cfg.remat_block
    aux = _zero(x)
    if blk > 1 and cfg.n_layers % blk == 0:
        # nested remat: each block of layers checkpointed as a unit, its
        # layers (when cfg.remat) checkpointed inside it
        def block_fn(x, *ps):
            a_blk = _zero(x)
            for p in ps:
                x, a = one_layer(p, x)
                a_blk = a_blk + a
            return x, a_blk

        for i in range(0, cfg.n_layers, blk):
            ps = layers[i:i + blk]
            if torch.is_grad_enabled():
                x, a = checkpoint(block_fn, x, *ps, use_reentrant=False)
            else:
                x, a = block_fn(x, *ps)
            aux = aux + a
    else:
        for p in layers:
            x, a = one_layer(p, x)
            aux = aux + a
    spec = (cfg.act("dp", "sp", None) if cfg.seq_parallel
            else cfg.act("dp", None, "tp"))
    return _final_logits(params, cfg, x, "bsd,dv->bsv", spec), aux


def loss_fn(params, cfg: TransformerConfig, batch):
    logits, aux = forward(params, cfg, batch["tokens"])
    return cross_entropy_loss(logits, batch["labels"]) + aux


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def prefill(params, cfg: TransformerConfig, tokens,
            compute_dtype=torch.bfloat16):
    """Prompt pass: returns (last-position logits (B, V), cache)."""
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens).to(compute_dtype)
    x = constrain(x, cfg.act("dp", "sp", None))
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    ks, vs = _LayerStack(cfg.n_layers), _LayerStack(cfg.n_layers)
    for li, p in enumerate(layer_slices(params["layers"], cfg.n_layers)):
        x = constrain(x, cfg.act("dp", "sp", None))
        h = apply_norm(cfg.norm, x, p.get("attn_norm"))
        q, k, v = _project_qkv(p, cfg, h, positions)
        ks.put(li, k)
        vs.put(li, v)
        attn = gqa_attention(q, k, v, causal=True)
        del q, k, v
        x = x + _out_proj(attn.reshape(b, s, cfg.n_heads, cfg.hd), p["wo"],
                          x)
        del attn
        x = constrain(x, cfg.act("dp", "sp", None))
        x, _ = _ffn(p, cfg, x, apply_norm(cfg.norm, x, p.get("mlp_norm")))
        x = constrain(x, cfg.act("dp", "sp", None))
    logits = _final_logits(params, cfg, x[:, -1], "bd,dv->bv",
                           cfg.act("dp", "tp"))
    cache = {"k": ks.stacked(), "v": vs.stacked(),
             "len": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    return logits, cache


class _LayerStack:
    """Per-layer tensors gathered into one (L, ...) stack: written into a
    preallocated buffer as they come, or, for DTensors (which cannot be
    written into a plain buffer), kept and stacked at the end
    (``torch.stack`` keeps their placements).  The buffer spares the stack
    at the end a second copy of the cache: L B S KV hd 2 bytes each for K
    and V, 64 GiB for olmo-1b's ``prefill_32k`` (B = 32)."""

    def __init__(self, n_layers: int):
        self.n, self.buf, self.parts = n_layers, None, []

    def put(self, li: int, t):
        if is_dtensor(t):
            self.parts.append(t)
            return
        if self.buf is None:
            self.buf = t.new_empty((self.n,) + tuple(t.shape))
        self.buf[li] = t

    def stacked(self):
        return self.buf if self.buf is not None else torch.stack(self.parts)


def _write_rows(cache_l, new, idx):
    """``cache_l.at[arange(B)[:, None], idx[:, None]].set(new)`` in place:
    cache_l (B, T, ...), new (B, 1, ...), idx (B,); a negative index wraps
    once, an index still outside [0, T) drops its row's write."""
    if is_dtensor(cache_l):
        _write_rows_sharded(cache_l, new, idx)
        return
    b, t = cache_l.shape[:2]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + t, idx)
    ok = (idx >= 0) & (idx < t)
    safe = idx.clamp(0, t - 1)
    bidx = torch.arange(b, device=cache_l.device)
    old = cache_l[bidx, safe]
    okb = ok.reshape((b,) + (1,) * (old.dim() - 1))
    cache_l[bidx, safe] = torch.where(okb, new[:, 0].to(cache_l.dtype), old)


def _write_rows_sharded(cache_l, new, idx):
    """``_write_rows`` on a DTensor cache split over (B, T) in any way:
    each device writes the rows that fall in its own block (what the
    reference's scatter does under GSPMD), with ``new`` and ``idx``
    brought to the cache's batch split first."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh, pl = cache_l.device_mesh, tuple(cache_l.placements)
    if not all(isinstance(p, (Replicate, Shard)) for p in pl):
        raise NotImplementedError(f"a cache placed as {pl}")
    by_batch = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0
                     else Replicate() for p in pl)

    def batch_split(x):
        if not is_dtensor(x):
            x = DTensor.from_local(x, mesh, [Replicate()] * len(pl),
                                   run_check=False)
        return x.redistribute(mesh, by_batch).to_local()

    t = cache_l.shape[1]
    local = cache_l.to_local()
    _, offset = compute_local_shape_and_global_offset(cache_l.shape, mesh,
                                                      pl)
    lb, lt = local.shape[:2]
    new_l, idx_l = batch_split(new), batch_split(idx).long()
    idx_l = torch.where(idx_l < 0, idx_l + t, idx_l)
    ok = (idx_l >= 0) & (idx_l < t)
    idx_l = idx_l - offset[1]
    ok = ok & (idx_l >= 0) & (idx_l < lt)
    safe = idx_l.clamp(0, lt - 1)
    bidx = torch.arange(lb, device=local.device)
    old = local[bidx, safe]
    okb = ok.reshape((lb,) + (1,) * (old.dim() - 1))
    local[bidx, safe] = torch.where(okb, new_l[:, 0].to(local.dtype), old)


def decode_step(params, cfg: TransformerConfig, cache, tokens,
                compute_dtype=torch.bfloat16):
    """One decode step.  tokens (B,) -> (logits (B, V), new cache), the
    cache's ``k`` / ``v`` written in place."""
    b = tokens.shape[0]
    x = embed_lookup(params["embed"], tokens)[:, None].to(compute_dtype)
    x = constrain(x, cfg.act("dp", "sp", None))
    positions = cache["len"][:, None]                            # (B, 1)
    K, V = cache["k"], cache["v"]
    for li, p in enumerate(layer_slices(params["layers"], cfg.n_layers)):
        h = apply_norm(cfg.norm, x, p.get("attn_norm"))
        q, k_new, v_new = _project_qkv(p, cfg, h, positions)
        _write_rows(K[li], k_new, cache["len"])
        _write_rows(V[li], v_new, cache["len"])
        attn = gqa_attention(q, K[li].to(x.dtype), V[li].to(x.dtype),
                             causal=False, kv_len=cache["len"] + 1)
        x = x + _out_proj(attn.reshape(b, 1, cfg.n_heads, cfg.hd), p["wo"],
                          x)
        x, _ = _ffn(p, cfg, x, apply_norm(cfg.norm, x, p.get("mlp_norm")))
        x = constrain(x, cfg.act("dp", None, None))
    logits = _final_logits(params, cfg, x[:, 0], "bd,dv->bv",
                           cfg.act("dp", "tp"))
    return logits, {"k": K, "v": V, "len": cache["len"] + 1}


__all__ = ["TransformerConfig", "decode_step", "embed_lookup", "forward",
           "init_cache", "init_params", "layer_slices", "loss_fn",
           "prefill"]
