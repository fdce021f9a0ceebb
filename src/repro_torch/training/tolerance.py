"""The stated tolerance of one train step against another run of it: the
reference's jitted step, or the port's on another device.

autograd's gradients and ``jax.grad``'s (or the card's scatter-adds and
the CPU's) sum in other orders, and a gradient that sums many terms may
carry their rounding at up to about 1e-5 of the tree's largest gradient;
m and v carry that (their atol below, times the tree's largest |m|, |v|).
The parameters are held to that error carried through AdamW's update
p - lr * (m / b1t / (sqrt(v / b2t) + eps) + wd * p), elementwise:
lr * 2 * dm / b1t / (sqrt(v / b2t) + eps), dm the moments' tolerance at
that element, plus 1e-6.  Where a gradient vanishes mathematically (the
last bias before a softmax, which is shift-invariant) both sides hold
rounding noise, sqrt(v) is near eps, and the bound opens up to the
update's own size, lr * 2.  The loss is held to rtol 2e-5 / atol 1e-5,
the step count exactly.  Those are ``F32_STEP``'s numbers, for steps that
compute in float32.

An LM step computes in bfloat16 (``repro/models/transformer.py``'s
default), and two runs round its bfloat16 products and sums apart: its
gradients differ by up to about 1.5% of the tree's largest (measured on
the five reduced archs against the reference), so ``BF16_STEP`` holds the
moments to rtol 3e-2 / atol 3e-2 of the largest and the loss to 1e-3.  In
an MoE arch a near-tie among the router's bfloat16 logits can send a token
to another expert in one run than in the other (both right), which moves
that expert's gradient: up to 12% of the largest m (measured), so
``BF16_MOE_STEP`` opens the moments' atol to 0.25 and the loss to 2e-3.
The float32 path (``forward(..., compute_dtype=float32)``) is held to
``F32_STEP`` for every arch, the MoE's included.

Logits (``logits_errors``) are held to ``LOGITS[dtype]``: |got - want| <=
atol * max|want| + rtol * |want|; float32 1e-5 / 2e-5 (measured within
1.1e-6 of the largest), bfloat16 3e-2 / 0 (measured within 1.3%).  In an
MoE arch at bfloat16 the rows a routing near-tie moves are allowed: at
least ``MOE_BF16_ROW_SHARE`` of the rows (tokens) within the tolerance
(measured at least 0.78).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from .optimizer import AdamWConfig


@dataclasses.dataclass(frozen=True)
class StepTolerance:
    loss_rtol: float
    loss_atol: float
    moment_rtol: float    # m (v: twice this)
    moment_atol: float    # m and v: times the largest |m| (|v|) in the tree
    param_atol: float     # params, beside the carried moment error


F32_STEP = StepTolerance(2e-5, 1e-5, 1e-4, 1e-5, 1e-6)
BF16_STEP = StepTolerance(1e-3, 1e-3, 3e-2, 3e-2, 1e-6)
BF16_MOE_STEP = StepTolerance(2e-3, 1e-3, 3e-2, 0.25, 1e-6)

# logits: (atol as a share of the largest |want|, rtol)
LOGITS = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (3e-2, 0.0)}
MOE_BF16_ROW_SHARE = 0.7


def step_tolerance(compute_dtype=torch.float32, moe: bool = False,
                   moment_dtype: str = "float32"):
    """The train-step tolerance for a step computing in ``compute_dtype``
    (an MoE arch's own at bfloat16).  bfloat16 moments round two nearby
    values up to one bfloat16 ulp apart (2^-7 of the value), so their rtol
    is at least that."""
    tol = F32_STEP if compute_dtype == torch.float32 else (
        BF16_MOE_STEP if moe else BF16_STEP)
    if moment_dtype == "bfloat16":
        tol = dataclasses.replace(
            tol, moment_rtol=max(tol.moment_rtol, 2.0 ** -7))
    return tol


def logits_errors(got, want, dtype=torch.float32, moe: bool = False):
    """``got`` and ``want`` float tensors of one shape (the last axis the
    vocabulary), computed in ``dtype``.  Returns (largest |got - want| as a
    share of the largest |want|, share of rows within the tolerance, ok)."""
    got = got.detach().to("cpu", torch.float32)
    want = want.detach().to("cpu", torch.float32)
    atol, rtol = LOGITS[dtype]
    top = float(want.abs().max())
    err = (got - want).abs()
    row_ok = (err <= atol * top + rtol * want.abs()).all(dim=-1)
    share = float(row_ok.float().mean())
    need = MOE_BF16_ROW_SHARE if (moe and dtype == torch.bfloat16) else 1.0
    ok = bool(torch.isfinite(got).all()) and share >= need
    return float(err.max()) / max(top, 1e-30), share, ok


def flat(tree, prefix: str = "") -> Dict[str, object]:
    """``{path: leaf}`` in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return {p: x for k in sorted(tree)
                for p, x in flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: x for i, v in enumerate(tree)
                for p, x in flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def train_step_errors(got, got_loss: float, want, want_loss: float,
                      cfg: AdamWConfig = AdamWConfig(),
                      tol: StepTolerance = F32_STEP
                      ) -> Tuple[Dict[str, float], List[str]]:
    """``got`` and ``want``: train states ``{"params", "opt": {"m", "v",
    "step"}}`` of one tree, tensors on any device and in any float dtype;
    the tolerance is taken about ``want``.  Returns the largest absolute
    error of the loss, parameters, m and v, and a message for each leaf
    (and for the loss or step) beyond its tolerance."""
    bad = []
    worst = {"loss": abs(got_loss - want_loss)}
    if not worst["loss"] <= tol.loss_atol + tol.loss_rtol * abs(want_loss):
        bad.append(f"loss {got_loss} against {want_loss}")
    if int(got["opt"]["step"]) != int(want["opt"]["step"]):
        bad.append(f"step {int(got['opt']['step'])} against "
                   f"{int(want['opt']['step'])}")

    def f32(tree):
        return {k: x.detach().to("cpu", torch.float32)
                for k, x in flat(tree).items()}

    parts = {"p": (f32(got["params"]), f32(want["params"])),
             "m": (f32(got["opt"]["m"]), f32(want["opt"]["m"])),
             "v": (f32(got["opt"]["v"]), f32(want["opt"]["v"]))}
    # zero-size leaves (an OLMo-style ``final_norm``) have no largest
    scale = {k: max((float(x.abs().max()) for x in parts[k][1].values()
                     if x.numel()), default=0.0)
             for k in "mv"}
    t = float(want["opt"]["step"])
    b1t, b2t = 1.0 - cfg.b1 ** t, 1.0 - cfg.b2 ** t
    for k in ("m", "v", "p"):
        worst[k] = 0.0
        for key, b in parts[k][1].items():
            err = (parts[k][0][key] - b).abs()
            if k == "p":
                dm = tol.moment_atol * scale["m"] + \
                    tol.moment_rtol * parts["m"][1][key].abs()
                v = parts["v"][1][key]
                bound = tol.param_atol + cfg.lr * 2 * dm / b1t / (
                    torch.sqrt(v / b2t) + cfg.eps)
            else:
                bound = tol.moment_atol * scale[k] + \
                    tol.moment_rtol * (2 if k == "v" else 1) * b.abs()
            out = ~(err <= bound)
            worst[k] = max(worst[k], float(err.max()) if err.numel() else 0.0)
            if out.any():
                bad.append(f"{k} {key}: {int(out.sum())} of {out.numel()} "
                           f"beyond the tolerance; worst {float(err.max())}")
    return worst, bad


__all__ = ["BF16_MOE_STEP", "BF16_STEP", "F32_STEP", "LOGITS",
           "MOE_BF16_ROW_SHARE", "StepTolerance", "flat", "logits_errors",
           "step_tolerance", "train_step_errors"]
