"""Shared layers (``repro/models/layers.py``).  Ported so far: the
cross-entropy loss the GCN trains with; the transformer layers come with
the LM family."""
from __future__ import annotations

import torch


def cross_entropy_loss(logits, labels, ignore_id: int = -1):
    """Token-mean CE in fp32.  logits (..., V), labels (...,) int.

    As the reference's ``take_along_axis``, a label at or past V reads a
    NaN logit; a negative label reads class 0, and ``ignore_id`` is left
    out of the mean."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    v = logits.shape[-1]
    lab = torch.clamp(labels.long(), min=0)
    ll = torch.gather(logits, -1, lab.clamp(max=v - 1)[..., None])[..., 0]
    ll = ll.masked_fill(lab >= v, float("nan"))
    nll = lse - ll
    mask = labels != ignore_id
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)


__all__ = ["cross_entropy_loss"]
