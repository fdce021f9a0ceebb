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
the step count exactly.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .optimizer import AdamWConfig

LOSS_RTOL, LOSS_ATOL = 2e-5, 1e-5
MOMENT_RTOL = 1e-4        # m (v: twice this)
MOMENT_ATOL = 1e-5        # m and v: times the largest |m| (|v|) in the tree
PARAM_ATOL = 1e-6         # params, beside the carried moment error


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
                      cfg: AdamWConfig = AdamWConfig()
                      ) -> Tuple[Dict[str, float], List[str]]:
    """``got`` and ``want``: train states ``{"params", "opt": {"m", "v",
    "step"}}`` of one tree, tensors on any device and in any float dtype;
    the tolerance is taken about ``want``.  Returns the largest absolute
    error of the loss, parameters, m and v, and a message for each leaf
    (and for the loss or step) beyond its tolerance."""
    bad = []
    worst = {"loss": abs(got_loss - want_loss)}
    if not worst["loss"] <= LOSS_ATOL + LOSS_RTOL * abs(want_loss):
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
    scale = {k: max(float(x.abs().max()) for x in parts[k][1].values())
             for k in "mv"}
    t = float(want["opt"]["step"])
    b1t, b2t = 1.0 - cfg.b1 ** t, 1.0 - cfg.b2 ** t
    for k in ("m", "v", "p"):
        worst[k] = 0.0
        for key, b in parts[k][1].items():
            err = (parts[k][0][key] - b).abs()
            if k == "p":
                dm = MOMENT_ATOL * scale["m"] + \
                    MOMENT_RTOL * parts["m"][1][key].abs()
                v = parts["v"][1][key]
                tol = PARAM_ATOL + cfg.lr * 2 * dm / b1t / (
                    torch.sqrt(v / b2t) + cfg.eps)
            else:
                tol = MOMENT_ATOL * scale[k] + \
                    MOMENT_RTOL * (2 if k == "v" else 1) * b.abs()
            out = ~(err <= tol)
            worst[k] = max(worst[k], float(err.max()) if err.numel() else 0.0)
            if out.any():
                bad.append(f"{k} {key}: {int(out.sum())} of {out.numel()} "
                           f"beyond the tolerance; worst {float(err.max())}")
    return worst, bad


__all__ = ["flat", "train_step_errors"]
