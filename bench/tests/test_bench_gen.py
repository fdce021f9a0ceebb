"""The inputs are a function of the seed, with the same sizes for every
seed."""
from __future__ import annotations

import pytest
import torch

from bench_tiny import tiny

from bench import datagen

CELLS = ["msturing100-hr.runbook", "cohere768-int8-hr.query"]


@pytest.mark.parametrize("workload", CELLS)
def test_same_seed_same_inputs(workload):
    cfg, tr = tiny(workload)
    a = datagen.make_inputs(cfg, tr, 2 ** 31 + 3, "cpu")
    b = datagen.make_inputs(cfg, tr, 2 ** 31 + 3, "cpu")
    assert torch.equal(a.table, b.table) and torch.equal(a.queries, b.queries)


@pytest.mark.parametrize("workload", CELLS)
def test_other_seed_other_values_same_sizes(workload):
    cfg, tr = tiny(workload)
    a = datagen.make_inputs(cfg, tr, 7, "cpu")
    b = datagen.make_inputs(cfg, tr, 2 ** 32 + 7, "cpu")
    assert a.table.shape == b.table.shape
    assert a.queries.shape == b.queries.shape
    assert not torch.equal(a.table, b.table)
    n_pool = int(tr["max_update_steps"]) * sum(
        int(op["count"]) for op in tr["cycle"] if op["op"] == "insert")
    assert a.table.shape == (cfg["n_live"] + n_pool, cfg["dim"])
    assert a.queries.shape == (tr["query_pool_batches"], tr["query_batch"],
                               cfg["dim"])


def test_inner_product_rows_are_unit():
    cfg, tr = tiny("cohere768-int8-hr.query")
    a = datagen.make_inputs(cfg, tr, 5, "cpu")
    n = a.table.norm(dim=1)
    assert torch.allclose(n, torch.ones_like(n), atol=1e-5)


def test_streams_of_one_seed_differ():
    g0 = datagen.generator(9, "cpu", 0)
    g1 = datagen.generator(9, "cpu", 1)
    assert not torch.equal(torch.randn(8, generator=g0),
                           torch.randn(8, generator=g1))
