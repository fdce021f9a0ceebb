"""The frozen starting-graph builder: degrees, no self or repeated edge, a
graph the program's search can navigate."""
from __future__ import annotations

import pytest
import torch

from bench_tiny import tiny

from bench import datagen, graph, loader
from bench.reference.exact import exact_topk


@pytest.mark.parametrize("workload", ["msturing100-hr.runbook",
                                      "cohere768-int8-hr.query"])
def test_builder_graph_is_sound_and_navigable(workload):
    cfg, tr = tiny(workload)
    inp = datagen.make_inputs(cfg, tr, 21, "cpu")
    base = inp.table[:cfg["n_live"]]
    b = cfg["builder"]
    adj, start = graph.build_graph(
        base, metric=cfg["metric"], r=cfg["r"], alpha=cfg["alpha"],
        knn=b["knn"], in_edges=b["in_edges"],
        long_edges=b["long_edges"], cells=b["cells"],
        gen=datagen.generator(21, "cpu", 1))
    n = base.shape[0]
    assert adj.shape == (n, cfg["r"]) and adj.dtype == torch.int32
    valid = adj >= 0
    assert (adj < n).all()
    assert not (adj == torch.arange(n)[:, None]).any()
    # front-compacted, no repeats
    assert (valid[:, 1:] <= valid[:, :-1]).all()
    for row in adj.tolist():
        ids = [i for i in row if i >= 0]
        assert len(ids) == len(set(ids))
    # RobustPrune keeps each point's closest candidate: its nearest point
    live = torch.ones(n, dtype=torch.bool)
    nearest, _ = exact_topk(base, base, live, 2, cfg["metric"])
    assert (adj == nearest[:, 1:]).any(1).all()
    assert 0 <= start < n

    from repro_torch.core.api import search

    state = loader.numpy_state(cfg, base, adj, start,
                               loader.max_external_id(cfg))
    idx = loader.load_index(cfg, state, "cpu")
    q = inp.queries[0]
    ext, dists, _ = search(idx.istate, idx.cfg, q, k=10, l=cfg["l_search"])
    truth, _ = exact_topk(q, base, torch.ones(n, dtype=torch.bool), 10,
                          cfg["metric"])
    hits = sum(len(set(a.tolist()) & set(t.tolist()))
               for a, t in zip(ext, truth))
    assert hits / truth.numel() >= 0.9


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_partitioned_candidates_find_the_exact_neighbours(metric):
    x, _ = datagen.gaussian_mixture(
        3000, 24, n_clusters=8, noise=0.35, intrinsic=8,
        normalize=metric == "ip",
        gen=datagen.generator(4, "cpu", 0), device="cpu")
    cand = graph.knn_candidates(x, metric, 16, cells=8,
                                gen=datagen.generator(4, "cpu", 1))
    assert cand.shape == (3000, 16)
    assert not (cand == torch.arange(3000)[:, None]).any()
    live = torch.ones(3000, dtype=torch.bool)
    truth, _ = exact_topk(x, x, live, 17, metric)
    hits = sum(len(set(c.tolist()) & set(t.tolist()))
               for c, t in zip(cand, truth[:, 1:]))
    assert hits / cand.numel() >= 0.95


def test_partition_of_one_cell_is_the_exact_scan():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(400, 8, generator=g)
    cand = graph.knn_candidates(x, "l2", 6, cells=1,
                                gen=datagen.generator(5, "cpu", 1))
    live = torch.ones(400, dtype=torch.bool)
    truth, _ = exact_topk(x, x, live, 7, "l2")
    assert cand.tolist() == truth[:, 1:].tolist()


def test_reverse_offers_keep_the_closest():
    out = torch.tensor([[1, 2, -1], [2, -1, -1], [1, -1, -1]])
    out_d = torch.tensor([[1.0, 5.0, 9.0], [2.0, 9.0, 9.0], [3.0, 9.0, 9.0]])
    rev = graph.reverse_offers(out, out_d, 1)
    # 2 is offered by 0 (5.0) and 1 (2.0): 1 is closer
    assert rev.tolist() == [[-1], [0], [1]]


def test_quantize_rows_follows_the_documented_rule():
    x = torch.tensor([[0.5, -1.27, 0.0], [0.0, 0.0, 0.0]])
    q = loader.quantize_rows(x)
    assert q["scale"].tolist() == pytest.approx([1.27 / 127, 1.0])
    assert q["codes"].tolist() == [[50, -127, 0], [0, 0, 0]]
    deq = q["codes"].float() * q["scale"][:, None]
    assert torch.allclose(q["qnorms"], (deq * deq).sum(1))
