"""The plain reference against brute-force loops."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench.reference import exact


def _brute(q, x, live, k, metric):
    out = []
    for row in q:
        best = []
        for i, v in enumerate(x):
            if not live[i]:
                continue
            d = (float(((row - v) ** 2).sum()) if metric == "l2"
                 else -float((row * v).sum()))
            best.append((d, i))
        best.sort()
        out.append([i for _, i in best[:k]])
    return out


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_exact_topk_against_a_loop(metric):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(300, 12, generator=g, dtype=torch.float64)
    q = torch.randn(7, 12, generator=g, dtype=torch.float64)
    live = torch.rand(300, generator=g) > 0.3
    ids, dists = exact.exact_topk(q.float(), x.float(), live, 10, metric,
                                  col_block=37)
    want = _brute(q.numpy(), x.numpy(), live.numpy(), 10, metric)
    assert ids.tolist() == want
    d64 = exact.pair_distances64(q, x[ids], metric)
    assert torch.allclose(dists.double(), d64, rtol=1e-4, atol=1e-4)


def test_fewer_live_than_k():
    x = torch.randn(20, 4)
    live = torch.zeros(20, dtype=torch.bool)
    live[[3, 9]] = True
    ids, dists = exact.exact_topk(torch.randn(2, 4), x, live, 5, "l2")
    assert sorted(ids[0, :2].tolist()) == [3, 9]
    assert (ids[:, 2:] == -1).all() and torch.isinf(dists[:, 2:]).all()


def test_live_set_replay_against_sets():
    rng = np.random.default_rng(0)
    n_start, n_rows = 50, 90
    live = exact.LiveSet(n_rows, n_start)
    ref = [set(range(n_start))]
    nxt = n_start
    for _ in range(8):
        ins = np.arange(nxt, nxt + 5)
        nxt += 5
        cur = sorted(ref[-1] | set(ins.tolist()))
        dels = rng.choice(cur, size=4, replace=False)
        live.apply(ins, dels)
        ref.append((ref[-1] | set(ins.tolist())) - set(dels.tolist()))
    for t, s in enumerate(ref):
        assert set(np.nonzero(live.live_at(t))[0].tolist()) == s
        ids = np.arange(-1, n_rows + 2)
        want = np.array([i in s for i in ids])
        assert (live.is_live(ids, t) == want).all()


def test_live_set_refuses_impossible_streams():
    live = exact.LiveSet(10, 5)
    with pytest.raises(ValueError):
        live.apply([4], [])
    with pytest.raises(ValueError):
        live.apply([], [7])


def test_tf32_rounds_the_mantissa():
    bits = 10
    x = torch.randn(10000, dtype=torch.float32) * 100
    r = exact.round_operands(x, "tf32")
    rel = ((r - x).abs() / x.abs()).max().item()
    assert 2.0 ** -(bits + 3) < rel <= 2.0 ** -(bits + 1)
    m = r.view(torch.int32) & ((1 << (23 - bits)) - 1)
    assert (m == 0).all()
    assert torch.equal(exact.round_operands(x, "float32"), x)
