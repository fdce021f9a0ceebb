"""GCN family (``repro/models/gnn.py``): full-batch message passing, the
sampled minibatch regime and batched small graphs, on PyTorch tensors.

Message passing is built as the reference builds it: a gather of source
rows (``take_rows``, ``jnp.take``'s semantics: NaN rows for ids out of
range) and a scatter-add into destinations (``_segment_sum``, ``index_add_``:
ids out of range dropped).  Three execution shapes:

  * full-batch (cora / ogb-products): edge-list segment-sum over the whole
    graph, symmetric GCN normalisation;
  * sampled minibatch (reddit-scale): a uniform neighbour sampler over CSR
    (fanout 15-10) drawing from a ``torch.Generator``, mean aggregation
    over the sampled blocks;
  * batched small graphs (molecule): disjoint-union batching with
    per-graph mean pooling for graph classification (``n_graphs`` static).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.types import resolve_device
from .layers import cross_entropy_loss, take_on_shards
from .recsys import _normal, _segment_sum, take_rows


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 16
    d_feat: int = 1433
    n_classes: int = 7
    aggregator: str = "mean"
    norm: str = "sym"
    graph_level: bool = False  # molecule: mean-pool + graph classification

    def layer_dims(self):
        dims = [self.d_feat] + [self.d_hidden] * (self.n_layers - 1)
        return list(zip(dims, dims[1:] + [self.n_classes]))

    def n_params(self) -> int:
        return sum(i * o + o for i, o in self.layer_dims())


def init_gcn_params(generator, cfg: GCNConfig, dtype=torch.float32,
                    device=None):
    """Per layer ``{"w": (d_in, d_out) ~ N(0, 1/d_in), "b": zeros}``, drawn
    from ``generator`` on ``device`` (``"meta"``: shapes only)."""
    dev = resolve_device(device)
    return [{"w": _normal(generator, (d_in, d_out), dtype, dev,
                          1.0 / d_in ** 0.5),
             "b": torch.zeros((d_out,), dtype=dtype, device=dev)}
            for d_in, d_out in cfg.layer_dims()]


def _div(x, n: int):
    """``x / n`` with the divisor on x's device: CUDA turns division by a
    host scalar into a product with its reciprocal."""
    return x / torch.full((), float(n), dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Full-batch message passing (edge-list segment-sum)
# ---------------------------------------------------------------------------


def _sym_norm_coef(src, dst, n_nodes: int):
    """Per-edge ``deg^-1/2[src] * deg^-1/2[dst]`` and ``deg^-1/2`` per node
    (deg counts in-edges plus the self loop).  The per-node gathers index
    as ``x[ids]`` does in JAX: a negative id wraps once, then every id is
    clamped into range."""
    deg = _segment_sum(torch.ones_like(dst, dtype=torch.float32), dst,
                       n_nodes) + 1.0
    inv_sqrt = torch.rsqrt(deg)
    coef = (take_on_shards(inv_sqrt, src, _clamped_rows)
            * take_on_shards(inv_sqrt, dst, _clamped_rows))
    return coef, inv_sqrt


def _clamped_rows(ids, n: int):
    return _clamped(ids, n), None


def _clamped(ids, n: int):
    ids = ids.long()
    return torch.where(ids < 0, ids + n, ids).clamp_(0, n - 1)


def gcn_forward(params, cfg: GCNConfig, feats, edges, *, n_nodes: int):
    """feats (N, F), edges (2, E) src->dst.  Returns per-node logits."""
    src, dst = edges[0], edges[1]
    coef, inv_sqrt = _sym_norm_coef(src, dst, n_nodes)
    self_w = (inv_sqrt * inv_sqrt)[:, None]
    x = feats
    for li, p in enumerate(params):
        h = x @ p["w"]                                       # transform first
        # the product in place on the gathered rows (one E-row copy)
        msg = take_rows(h, src).mul_(coef[:, None])
        agg = _segment_sum(msg, dst, n_nodes)
        del msg
        # self loop with 1/deg weight (sym-normalised adjacency with selfloops)
        agg = agg + h * self_w
        x = agg + p["b"]
        if li < len(params) - 1:
            x = torch.relu(x)
    return x


def gcn_loss(params, cfg: GCNConfig, batch):
    logits = gcn_forward(params, cfg, batch["feats"], batch["edges"],
                         n_nodes=batch["feats"].shape[0])
    if cfg.graph_level:
        n_graphs = batch["n_graphs"]
        pooled = _segment_sum(logits, batch["graph_ids"], n_graphs)
        counts = _segment_sum(
            torch.ones_like(batch["graph_ids"], dtype=torch.float32),
            batch["graph_ids"], n_graphs)
        pooled = pooled / torch.clamp(counts, min=1.0)[:, None]
        return cross_entropy_loss(pooled, batch["labels"])
    return cross_entropy_loss(logits, batch["labels"])


# ---------------------------------------------------------------------------
# Neighbour sampling (the "real sampler" over CSR)
# ---------------------------------------------------------------------------


def sample_neighbors(generator, row_offsets, cols, seeds, fanout: int):
    """Uniform-with-replacement neighbour sampling from a CSR graph.

    row_offsets (N+1,), cols (E,), seeds (B,) -> (B, fanout) int32
    neighbour ids, drawn from ``generator`` (on the seeds' device).
    Isolated nodes self-loop."""
    s = seeds.long()
    starts = row_offsets[s].long()
    degs = row_offsets[s + 1].long() - starts
    r = torch.randint(0, torch.iinfo(torch.int32).max,
                      (seeds.shape[0], fanout), generator=generator,
                      device=seeds.device)
    off = r % torch.clamp(degs, min=1)[:, None]
    self_loops = seeds[:, None].expand(-1, fanout).to(torch.int32)
    if cols.shape[0] == 0:
        return self_loops.clone()
    # an isolated node at the end of the CSR reads past it: clamped, as the
    # reference's gather clamps, and replaced by the self loop
    nbrs = cols[(starts[:, None] + off).clamp_(max=cols.shape[0] - 1)]
    return torch.where(degs[:, None] > 0, nbrs.to(torch.int32), self_loops)


def sampled_gcn_forward(params, cfg: GCNConfig, feats, blocks):
    """GraphSAGE-style mean aggregation over sampled blocks.

    ``blocks`` is a list, innermost first: blocks[-1] are the seed nodes,
    blocks[i] the sampled neighbours at hop (L - i): shapes
    [(B*f1*f2,), (B*f1,), (B,)] for fanout (f2, f1).
    """
    h = take_rows(feats, blocks[0])                      # deepest hop feats
    for li, p in enumerate(params):
        nodes = blocks[li + 1]
        fanout = h.shape[0] // nodes.shape[0]
        hw = h @ p["w"]
        agg = _div(hw.reshape(nodes.shape[0], fanout, -1).sum(dim=1), fanout)
        if li == 0:
            agg = agg + take_rows(feats, nodes) @ p["w"]
        x = agg + p["b"]
        if li < len(params) - 1:
            x = torch.relu(x)
        h = x
    return h


def sampled_gcn_loss(params, cfg: GCNConfig, batch):
    logits = sampled_gcn_forward(
        params, cfg, batch["feats"],
        [batch["hop2"], batch["hop1"], batch["seeds"]],
    )
    return cross_entropy_loss(logits, batch["labels"])


__all__ = ["GCNConfig", "gcn_forward", "gcn_loss", "init_gcn_params",
           "sample_neighbors", "sampled_gcn_forward", "sampled_gcn_loss"]
