"""AdamW (``repro/training/optimizer.py``) on trees of PyTorch tensors, plus
the int8 error-feedback gradient compression of the reference's
data-parallel loop, here over a list of per-device gradients.

A tree is the reference's: dicts, and lists (an MLP's ``w`` / ``b``, the
GCN's layers), tensors at the leaves.  ``tree_leaves`` walks it in
``jax.tree.leaves`` order (dict keys sorted, so DLRM's tables run ``t0,
t1, t10, ..., t19, t2, t20, ...``), which fixes the order of the global
norm's sum.

``adamw_update`` computes the reference's expression, operation for
operation and in its order (no fused multiply-add, no ``scalar / tensor``,
which PyTorch turns into a reciprocal and a product, a correctly rounded
square root), and runs in place,
leaf by leaf: the parameters and float32 moments are updated where they
lie, bfloat16 moments through a float32 copy.  The gradients are left as
they are: the clip scales each leaf's float32 copy, since autograd may
hand one gradient tensor to two leaves.  ``b1 ** step`` and ``b2 ** step`` in float32 differ from XLA's
``pow`` in the last bit at some steps; a step where ``1 -`` them still
differs would move the new parameters by at most an ulp.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    # moment storage dtype; "bfloat16" halves optimizer memory — update
    # math is always fp32
    moment_dtype: str = "float32"


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves in ``jax.tree.leaves`` order: dict keys sorted, lists in
    order; ``None`` is an empty subtree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping its structure and key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def adamw_init(params, cfg: AdamWConfig = AdamWConfig()):
    """Zero moments in ``cfg.moment_dtype`` beside each parameter and an
    int32 step count on the first parameter's device."""
    mdt = _DTYPES[cfg.moment_dtype]

    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                              device=p.device), params)

    return {
        "m": zeros(),
        "v": zeros(),
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device),
    }


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA's.  PyTorch's
    vectorised float32 ``sqrt`` on the CPU is not (about 0.6% of results an
    ulp off); the float64 root rounded to float32 is.  The card's ``sqrtf``
    is correctly rounded."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of per-leaf sums of squares, leaves in
    ``jax.tree.leaves`` order (the reference's Python ``sum``)."""
    return _sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                     for x in tree_leaves(tree)))


def _upd_one(p, g, m, v, b1t, b2t, scale, cfg: AdamWConfig) -> None:
    """One leaf, in place: the reference's ``g * scale`` (``scale`` None
    without a clip) and ``upd_one``."""
    g = g.to(torch.float32)
    if scale is not None:
        g = g * scale
    m32 = m.to(torch.float32)
    v32 = v.to(torch.float32)
    tmp = g.mul(1 - cfg.b1)                        # (1 - b1) * g
    m32.mul_(cfg.b1).add_(tmp)                     # b1 * m + ...
    torch.mul(g, 1 - cfg.b2, out=tmp).mul_(g)      # (1 - b2) * g * g
    v32.mul_(cfg.b2).add_(tmp)                     # b2 * v + ...
    del g                          # a scaled copy is freed before den's
    mh = torch.div(m32, b1t, out=tmp)              # m / b1t
    den = _sqrt(torch.div(v32, b2t)).add_(cfg.eps)  # sqrt(v / b2t) + eps
    mh.div_(den)
    mh.add_(torch.mul(p, cfg.weight_decay, out=den))   # ... + wd * p
    p.sub_(mh.mul_(cfg.lr))                        # p - lr * (...)
    if m32 is not m:
        m.copy_(m32)
    if v32 is not v:
        v.copy_(v32)


def _bias_corrections(step: torch.Tensor, cfg: AdamWConfig):
    """``1 - b1 ** step`` and ``1 - b2 ** step`` in float32 (``step`` the
    int32 count after this update)."""
    step_f = step.to(torch.float32)
    return 1.0 - torch.pow(cfg.b1, step_f), 1.0 - torch.pow(cfg.b2, step_f)


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig):
    """One AdamW step with the global-norm clip and bias correction.

    Updates ``params`` and the moments in place, leaves ``grads`` as they
    are, and returns ``(params, {"m", "v", "step"})``: the same parameter
    and moment tensors, and a new step count."""
    step = opt_state["step"] + 1
    scale = None
    if cfg.grad_clip is not None:
        gnorm = _global_norm(grads)
        clip = torch.full_like(gnorm, cfg.grad_clip)
        scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)

    b1t, b2t = _bias_corrections(step, cfg)

    flat_p = tree_leaves(params)
    flat_m = tree_leaves(opt_state["m"])
    flat_v = tree_leaves(opt_state["v"])
    for p, g, m, v in zip(flat_p, tree_leaves(grads), flat_m, flat_v):
        _upd_one(p, g, m, v, b1t.to(p.device), b2t.to(p.device),
                 None if scale is None else scale.to(p.device), cfg)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback, over per-device gradients
# ---------------------------------------------------------------------------


@torch.no_grad()
def compressed_psum(grads: Sequence[torch.Tensor],
                    residuals: Optional[Sequence[torch.Tensor]] = None):
    """All-reduce int8-quantised gradients with a shared scale.

    ``grads``: one gradient per device (the reference's ``g`` on each
    member of the named axis), each on its own device.  Returns the summed
    float32 gradient, on the first gradient's device, and each device's new
    residual (error feedback: add it to that device's next gradient).  The
    scale comes from the max of ``|g|`` over every device; the quantised
    gradients are summed in int32.
    """
    gs = list(grads)
    if residuals is not None:
        gs = [g + r for g, r in zip(gs, residuals)]
    home = gs[0].device
    amax = torch.stack([g.abs().max().to(home) for g in gs]).max()
    # a divisor on the device: CUDA turns division by a host scalar into a
    # product with its reciprocal
    scale = torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)
    total = torch.zeros(gs[0].shape, dtype=torch.int32, device=home)
    new_residuals = []
    for g in gs:
        s = scale.to(g.device)
        q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
        new_residuals.append(g - q.to(torch.float32) * s)
        total += q.to(device=home, dtype=torch.int32)
    return total.to(torch.float32) * scale, new_residuals


__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "compressed_psum",
           "tree_leaves", "tree_map"]
