"""Inputs made from the seed: the vectors of the starting set, the pool the
update stream inserts from, and the pool of queries.

The form is the program's runbook generator (``core/runbook.py::
make_dataset``): a Gaussian mixture, cluster centres N(0, 1) at the
configuration's width, rows normalised to unit length for the inner-product
sets.  One change: a point's offset from its centre lies in a random
``intrinsic``-dimensional subspace of its cluster, with the same expected
length as ``noise`` times N(0, 1) at the full width.  Embedding sets have an
intrinsic dimension far below their width; an offset spread over every
coordinate makes each cluster a ball in which the nearest neighbours are
barely nearer than the rest, and no graph search at the configured beam
keeps its recall as the clusters fill.  It is drawn here on the device with
one ``torch.Generator`` in a few large calls, so that set-up stays short and
a later change to the program cannot change the inputs.  Every seed gives the
same sizes; only the values differ.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Inputs:
    """``table`` holds every vector the stream can name: row ``e`` is
    external id ``e``; rows ``[0, n_start)`` are the starting set, the rest
    the insert pool in the order the stream inserts them."""

    table: torch.Tensor      # f32[n_start + n_pool, D]
    queries: torch.Tensor    # f32[n_query_batches, B, D]
    n_start: int

    @property
    def n_rows(self) -> int:
        return self.table.shape[0]


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator for one stream of draws (data, graph) of a seed, which
    may be any non-negative integer.  The seed and the stream are hashed
    into 64 bits whose low 32 already differ (the CPU's generator keeps
    only those)."""
    state = np.random.SeedSequence([int(seed), stream]).generate_state(
        1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(state) & (2 ** 63 - 1))
    return g


def gaussian_mixture(n: int, dim: int, *, n_clusters: int, noise: float,
                     intrinsic: int, normalize: bool, gen: torch.Generator,
                     device, clusters: tuple = None) -> tuple:
    """``(points f32[n, dim], clusters)``; ``clusters`` is ``(centres,
    bases)``, drawn when not given: centres f32[C, dim] and, per cluster, an
    orthonormal basis f32[C, dim, intrinsic] of its offsets."""
    if clusters is None:
        centres = torch.randn((n_clusters, dim), generator=gen, device=device)
        g = torch.randn((n_clusters, dim, intrinsic), generator=gen,
                        device=device)
        clusters = (centres, torch.linalg.qr(g).Q)
    centres, bases = clusters
    assign = torch.randint(0, n_clusters, (n,), generator=gen, device=device)
    z = torch.randn((n, intrinsic), generator=gen, device=device)
    z.mul_(noise * (dim / intrinsic) ** 0.5)
    out = torch.empty((n, dim), dtype=torch.float32, device=device)
    for c in range(n_clusters):
        rows = torch.nonzero(assign == c).squeeze(1)
        out[rows] = centres[c] + z[rows] @ bases[c].T
    if normalize:
        out /= out.norm(dim=1, keepdim=True) + 1e-9
    return out, clusters


def insert_pool_rows(traffic: dict) -> int:
    """Rows of the insert pool: ``max_update_steps`` cycles' inserts."""
    per_cycle = sum(int(op["count"]) for op in traffic["cycle"]
                    if op["op"] == "insert")
    return int(traffic.get("max_update_steps", 0)) * per_cycle


def make_inputs(config: dict, traffic: dict, seed: int, device) -> Inputs:
    """The inputs of one run of a cell."""
    data = config["data"]
    dim = int(config["dim"])
    n_start = int(config["n_live"])
    n_pool = insert_pool_rows(traffic)
    gen = generator(seed, device, stream=0)
    kw = dict(n_clusters=int(data["n_clusters"]), noise=float(data["noise"]),
              intrinsic=int(data["intrinsic"]),
              normalize=bool(data["normalize"]), gen=gen, device=device)
    table, clusters = gaussian_mixture(n_start + n_pool, dim, **kw)
    nq = int(traffic["query_pool_batches"]) * int(traffic["query_batch"])
    queries, _ = gaussian_mixture(nq, dim, clusters=clusters, **kw)
    queries = queries.reshape(int(traffic["query_pool_batches"]),
                              int(traffic["query_batch"]), dim)
    return Inputs(table=table, queries=queries, n_start=n_start)
