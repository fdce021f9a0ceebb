"""Deterministic, stateless synthetic data streams
(``repro/data/pipeline.py``).

Every stream computes ``batch = f(seed, step)`` with no mutable cursor, so
resume after a restart is an exact skip-ahead: the launcher's crash replay
rebuilds the state an uninterrupted run would have had, and each
data-parallel host can slice its shard of the global batch independently
(``TokenStream.host_shard``).  The streams draw with numpy, so each is
bitwise the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


@dataclasses.dataclass(frozen=True)
class TokenStream:
    """LM batches: Zipfian tokens with a shifted-label convention."""
    vocab: int
    batch: int
    seq: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = _rng(self.seed, step)
        # Zipf-ish marginal over the vocab (realistic logit statistics)
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = (z % self.vocab).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def host_shard(self, step: int, host: int, n_hosts: int) -> dict:
        b = self.batch_at(step)
        lo = host * self.batch // n_hosts
        hi = (host + 1) * self.batch // n_hosts
        return {k: v[lo:hi] for k, v in b.items()}


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


@dataclasses.dataclass(frozen=True)
class ClickStream:
    """RecSys impressions for DLRM-style models."""
    n_dense: int
    vocab_sizes: tuple
    batch: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = _rng(self.seed, step)
        dense = rng.normal(size=(self.batch, self.n_dense)).astype(np.float32)
        sparse = np.stack(
            [rng.integers(0, v, size=self.batch) for v in self.vocab_sizes],
            axis=1,
        ).astype(np.int32)
        labels = (rng.uniform(size=self.batch) < 0.25).astype(np.float32)
        return {"dense": dense, "sparse": sparse, "labels": labels}


__all__ = ["ClickStream", "TokenStream", "VectorStream"]
