"""Deterministic, stateless synthetic data streams
(``repro/data/pipeline.py``).

Every stream computes ``batch = f(seed, step)`` with no mutable cursor, so
resume after a restart is an exact skip-ahead: the launcher's crash replay
rebuilds the state an uninterrupted run would have had.  Only
``VectorStream`` is here; the reference's ``TokenStream`` and
``ClickStream`` feed the models of ROADMAP slice 15.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


@dataclasses.dataclass(frozen=True)
class VectorStream:
    """Streaming ANN updates: per-step insert / delete vectors (a
    runbook-free continuous stream for the serving launcher)."""
    dim: int
    rate: int            # inserts per step
    seed: int = 0
    lifetime: int = 50   # steps until deletion

    def step_at(self, step: int):
        rng = _rng(self.seed, step)
        ins_ids = np.arange(step * self.rate, (step + 1) * self.rate)
        vecs = rng.normal(size=(self.rate, self.dim)).astype(np.float32)
        del_step = step - self.lifetime
        del_ids = (
            np.arange(del_step * self.rate, (del_step + 1) * self.rate)
            if del_step >= 0 else np.array([], np.int64)
        )
        return ins_ids, vecs, del_ids

    def queries_at(self, step: int, n: int = 32) -> np.ndarray:
        rng = _rng(self.seed + 1, step)
        return rng.normal(size=(n, self.dim)).astype(np.float32)


__all__ = ["VectorStream"]
