"""Generic train-step factory (``repro/training/train.py``):
value-and-grad -> AdamW, with optional microbatch gradient accumulation.

Gradients come from ``torch.autograd``: ``value_and_grad(loss_fn)`` runs
``loss_fn`` on detached copies of the parameter leaves (the same storage,
``requires_grad``) and returns the loss and a tree of gradients shaped
like the parameters (zeros where a leaf does not reach the loss, as
``jax.grad`` gives); a DTensor gradient comes on its parameter's
placements.  Dense: an embedding lookup's gradient is a full
table, as ``jnp.take``'s scatter-add transpose is.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .optimizer import AdamWConfig, adamw_update, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    optimizer: AdamWConfig = AdamWConfig()
    accum_steps: int = 1


def value_and_grad(loss_fn: Callable) -> Callable:
    """``jax.value_and_grad`` over a tree of tensors: ``fn(params, *args)
    -> (loss, grads)``, the loss detached."""

    def fn(params, *args):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss = loss_fn(leaves, *args)
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        by_id = {id(p): (torch.zeros_like(p) if g is None
                         else _placed_like(g, p))
                 for p, g in zip(flat, grads)}
        return loss.detach(), tree_map(lambda p: by_id[id(p)], leaves)

    return fn


def _placed_like(g, p):
    """A DTensor gradient on its parameter's placements (a pending sum is
    reduced, or reduced and scattered, as GSPMD gives the gradient of a
    sharded parameter); a plain one as it is."""
    from ..models.layers import is_dtensor

    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(loss_fn: Callable,
                    cfg: TrainStepConfig = TrainStepConfig()):
    """loss_fn(params, batch) -> scalar loss.

    Returns step(params, opt_state, batch) -> (params, opt_state, metrics),
    the parameters and moments updated in place.  With accum_steps > 1 the
    batch's leading axis is split into microbatches and gradients
    accumulate in fp32, in microbatch order, before one optimiser
    application (the reference's ``lax.scan``)."""
    grads_of = value_and_grad(loss_fn)

    def step(params, opt_state, batch):
        if cfg.accum_steps == 1:
            loss, grads = grads_of(params, batch)
        else:
            a = cfg.accum_steps
            rows = tree_leaves(batch)[0].shape[0]
            if rows % a:
                raise ValueError(f"a batch of {rows} rows does not split "
                                 f"into {a} microbatches")
            m = rows // a
            grads = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            loss = 0.0
            for i in range(a):
                # microbatch i is rows [i m, (i + 1) m), the reference's
                # reshape to (a, m, ...); a slice, which a DTensor batch
                # split over more devices than a takes too
                mb_loss, g = grads_of(params, tree_map(
                    lambda x: x[i * m:(i + 1) * m], batch))
                tree_map(lambda acc, b: acc.add_(b.to(torch.float32)),
                         grads, g)
                loss = loss + mb_loss
            # divisors on the device: CUDA turns division by a host scalar
            # into a product with its reciprocal
            div = torch.full((), float(a), device=loss.device)
            grads = tree_map(lambda g: g.div_(div.to(g.device)), grads)
            loss = loss / div
        params, opt_state = adamw_update(grads, opt_state, params,
                                         cfg.optimizer)
        return params, opt_state, {"loss": loss}

    return step


__all__ = ["TrainStepConfig", "make_train_step", "value_and_grad"]
