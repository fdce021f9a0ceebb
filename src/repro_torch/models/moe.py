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

from .layers import _softmax
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


def moe_ffn(params, x, cfg: MoEConfig):
    """x: (T, d) tokens.  Returns (out (T, d), aux_loss scalar).

    Long token streams are processed in ``dispatch_chunk`` chunks, one
    after another, and their aux losses averaged.  (The reference's
    ``dp_spec`` / ``ep_spec`` sharding anchors wait for the mesh.)"""
    t, d = x.shape
    chunk = cfg.dispatch_chunk
    if chunk and t > chunk and t % chunk == 0:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        outs = []
        for xc in x.reshape(t // chunk, chunk, d):
            out_c, aux_c = _moe_once(params, xc, cfg)
            aux = aux + aux_c
            outs.append(out_c)
        # a divisor on the device: CUDA turns division by a host scalar
        # into a product with its reciprocal
        n = torch.full((), float(t // chunk), device=x.device)
        return torch.cat(outs, dim=0), aux / n
    return _moe_once(params, x, cfg)


def _moe_once(params, x, cfg: MoEConfig):
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = cfg.capacity(t)
    dev = x.device
    params = {n: w.to(x.dtype) for n, w in params.items()}

    logits = (x @ params["router"]).to(torch.float32)        # (T, E)
    probs = _softmax(logits)
    top_p, top_i = _top_k(probs, k)                          # (T, k)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)   # renormalise

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    me = torch.mean(probs, dim=0)
    flat_e = top_i.reshape(-1).long()                        # (T*k,)
    ce = torch.zeros((e,), dtype=torch.float32, device=dev).index_add_(
        0, flat_e, torch.full((t * k,), 1.0 / (t * k), device=dev))
    aux = cfg.router_aux_weight * e * torch.sum(me * ce)

    # --- rank tokens within each expert (stable by token order) ------------
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=e)
    group_start = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(t * k, device=dev) - group_start[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)

    keep = rank < cap
    slot = torch.where(keep, flat_e * cap + rank,
                       torch.full_like(rank, e * cap))      # drop -> spare
    token_of = torch.arange(t, device=dev).repeat_interleave(k)

    # --- dispatch: invert the routing (slot -> token), gather rows ---------
    inv = torch.full((e * cap + 1,), t, dtype=torch.long, device=dev)
    inv = inv.scatter_(0, slot, token_of)[:e * cap]
    filled = inv < t
    buf = torch.where(filled[:, None], x[inv.clamp(max=t - 1)], 0.0)
    buf = buf.reshape(e, cap, d)

    # --- expert computation (batched SwiGLU over the expert axis) ----------
    h = F.silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(
        buf, params["w_up"])
    out_buf = torch.bmm(h, params["w_down"]).reshape(e * cap, d)

    # --- combine: k per-choice gathers, accumulated in j order --------------
    slot_tk = slot.reshape(t, k)
    keep_tk = keep.reshape(t, k)
    w_tk = top_p.to(x.dtype)
    out = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for j in range(k):
        rows = out_buf[slot_tk[:, j].clamp(max=e * cap - 1)]
        out = out + torch.where(keep_tk[:, j][:, None],
                                rows * w_tk[:, j][:, None], 0.0)
    return out, aux


__all__ = ["MoEConfig", "init_moe_params", "moe_ffn"]
