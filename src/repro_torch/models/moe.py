"""Capacity-based top-k MoE with gather/scatter dispatch
(``repro/models/moe.py``), on PyTorch tensors.

Tokens are sorted into per-expert capacity slots and moved with gathers:

    route -> rank tokens per expert -> gather into (E, C, d) buffers
          -> batched expert SwiGLU  -> gather back with combine weights

Routing is the reference's, tie for tie: ``lax.top_k`` over the router's
softmax (ties to the lower expert), a stable sort of the dispatches by
expert (ties keep token order), and a token's rank within its expert
decides whether it keeps a slot (rank < capacity) or is dropped and passes
through the residual.  The inverse map slot -> token is a scatter whose
dropped entries aim one past the last slot (the reference's ``mode="drop"``
write out of bounds): here they land in one spare entry that is cut off.
The k-way combine adds each choice's weighted rows in ``j`` order, in the
tokens' dtype.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .layers import _softmax, add_on_shards, constrain, take_on_shards
from .recsys import _normal, _top_k


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # Token-chunked dispatch: bound the (E, C, d) buffer + expanded gather to
    # one chunk's worth (a sequential loop over chunks — same FLOPs, 1/n
    # the live memory).  None disables.
    dispatch_chunk: int = 131072

    def capacity(self, n_tokens: int) -> int:
        c = int(n_tokens * self.top_k / self.n_experts * self.capacity_factor)
        return max(8, -(-c // 8) * 8)  # round up to 8


def init_moe_params(generator, d_model: int, cfg: MoEConfig,
                    dtype=torch.float32, device=None, lead=()):
    """``{"router" (d, E), "w_gate" / "w_up" (E, d, f), "w_down" (E, f, d)}``
    ~ N(0, 1/fan_in), each with the leading dims ``lead`` (the stacked
    layer axis), drawn from ``generator`` on ``device``."""
    e, f = cfg.n_experts, cfg.d_ff_expert
    lead = tuple(lead)
    s_in, s_out = 1.0 / d_model ** 0.5, 1.0 / f ** 0.5
    return {
        "router": _normal(generator, lead + (d_model, e), dtype, device,
                          s_in),
        "w_gate": _normal(generator, lead + (e, d_model, f), dtype, device,
                          s_in),
        "w_up": _normal(generator, lead + (e, d_model, f), dtype, device,
                        s_in),
        "w_down": _normal(generator, lead + (e, f, d_model), dtype, device,
                          s_out),
    }


def moe_ffn(params, x, cfg: MoEConfig, dp_spec=None, ep_spec=None):
    """x: (T, d) tokens.  Returns (out (T, d), aux_loss scalar).

    ``dp_spec`` anchors token activations (tokens sharded over data),
    ``ep_spec`` anchors the (E, C, d) expert buffers (experts over model);
    both act on DTensors only (``layers.constrain``).  Long token streams
    are processed in ``dispatch_chunk`` chunks, one after another, and
    their aux losses averaged."""
    t = x.shape[0]
    chunk = cfg.dispatch_chunk
    if chunk and t > chunk and t % chunk == 0:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        outs = []
        # sliced, not unflattened: a DTensor's token axis may be split
        # across chunks
        for xc in torch.split(x, chunk):
            out_c, aux_c = _moe_once(params, xc, cfg, dp_spec, ep_spec)
            aux = aux + aux_c
            outs.append(out_c)
        # a divisor on the device: CUDA turns division by a host scalar
        # into a product with its reciprocal
        n = torch.full((), float(t // chunk), device=x.device)
        return torch.cat(outs, dim=0), aux / n
    return _moe_once(params, x, cfg, dp_spec, ep_spec)


def _moe_once(params, x, cfg: MoEConfig, dp_spec=None, ep_spec=None):
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = cfg.capacity(t)
    dev = x.device
    params = {n: w.to(x.dtype) for n, w in params.items()}
    x = constrain(x, dp_spec)

    logits = (x @ params["router"]).to(torch.float32)        # (T, E)
    probs = _softmax(logits)
    top_p, top_i = _top_k(probs, k)                          # (T, k)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)   # renormalise

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    me = torch.mean(probs, dim=0)
    flat_e = top_i.reshape(-1).long()                        # (T*k,)
    # the adds on each device's local rows where the tokens are DTensors
    # (``add_on_shards``); the scatters out of place, into buffers made
    # from the routed tensors; they are (E,) and (T*k,) long
    ce = add_on_shards(_count_into(e), torch.full_like(
        flat_e, 1.0 / (t * k), dtype=probs.dtype), flat_e)
    aux = cfg.router_aux_weight * e * torch.sum(me * ce)

    # --- rank tokens within each expert (stable by token order) ------------
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    counts = add_on_shards(_count_into(e), torch.ones_like(flat_e), flat_e)
    group_start = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(t * k, device=dev) - group_start[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter(0, order, rank_sorted)

    keep = rank < cap
    slot = torch.where(keep, flat_e * cap + rank,
                       torch.full_like(rank, e * cap))      # drop -> spare
    token_of = torch.arange(t, device=dev).repeat_interleave(k)

    # --- dispatch: invert the routing (slot -> token), gather rows ---------
    inv = slot.new_full((e * cap + 1,), t).scatter(0, slot,
                                                   token_of)[:e * cap]
    filled = inv < t
    buf = torch.where(filled[:, None],
                      take_on_shards(x, inv.clamp(max=t - 1)), 0.0)
    buf = constrain(buf.reshape(e, cap, d), ep_spec)

    # --- expert computation (batched SwiGLU over the expert axis) ----------
    h = F.silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(
        buf, params["w_up"])
    h = constrain(h, ep_spec)
    out_buf = constrain(torch.bmm(h, params["w_down"]),
                        ep_spec).reshape(e * cap, d)

    # --- combine: k per-choice gathers, accumulated in j order --------------
    slot_tk = slot.reshape(t, k)
    keep_tk = keep.reshape(t, k)
    w_tk = top_p.to(x.dtype)
    out = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for j in range(k):
        rows = constrain(take_on_shards(
            out_buf, slot_tk[:, j].clamp(max=e * cap - 1)), dp_spec)
        out = out + torch.where(keep_tk[:, j][:, None],
                                rows * w_tk[:, j][:, None], 0.0)
    return constrain(out, dp_spec), aux


def _count_into(n: int):
    """``src`` summed into ``n`` bins by ``idx``."""
    def add(src, idx):
        return src.new_zeros((n,)).index_add_(0, idx, src)

    return add


__all__ = ["MoEConfig", "init_moe_params", "moe_ffn"]
