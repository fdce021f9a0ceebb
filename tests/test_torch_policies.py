"""The ``fresh`` and ``local`` update policies of the port against the JAX
reference, on the CPU.

Each new module alone on a graph built by the reference and carried over
with ``repro_torch.convert``: ``lazy_delete_many``, ``local_delete_many``,
``remove_target_everywhere``, ``fresh_consolidate`` (Algorithm 4, whole and
in chunks), the wide prune's two formulations against each other and the
reference, and the batched search's per-lane ``starts`` against the
reference's ``greedy_search`` per lane.  Then the slice through
``StreamingIndex``: the counterparts of ``test_updates.py::
test_fresh_mode_invariants_and_consolidation`` and ``test_consolidate.py::
test_fresh_consolidate_restores_recall``.  Bitwise on grid data; on
Gaussian data ids and counters exactly, distances to rtol 2e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from invariants import assert_graph_invariants
from torch_parity import (assert_field, assert_graph_equal,
                          assert_index_equal, assert_search_equal, cfg_pair,
                          grid_data, jax_index_numpy, small_kw)

from repro.core import api as japi
from repro.core import consolidate as jcons
from repro.core import delete as jdel
from repro.core import edges as jedges
from repro.core import make_dataset
from repro.core import prune as jprune
from repro.core import search as jsearch
from repro.core import StreamingIndex as JIndex
from repro.core.types import init_index_state as j_init
from repro_torch import convert
from repro_torch.core import StreamingIndex as TIndex
from repro_torch.core import api as tapi
from repro_torch.core import consolidate as tcons
from repro_torch.core import delete as tdel
from repro_torch.core import edges as tedges
from repro_torch.core import prune as tprune
from repro_torch.core import search_batched as tsb
from repro_torch.core import types as ttypes
from repro_torch.core.types import GraphState

DIM = 24
GRAPH = tuple(f for f in GraphState._fields if f != "quant")
KINDS = ["grid", "gauss"]


def _data(kind, n=240, metric="l2"):
    if kind == "grid":
        return grid_data(n, DIM, 41), grid_data(16, DIM, 42)
    return make_dataset(n, DIM, metric, n_queries=16, seed=41)


def _built(kind, policy="ip", n=200, **cfg_kw):
    """The same graph in both packages: the reference builds it (a serial
    bootstrap, then one batched window) and ``convert`` carries it over."""
    jcfg, tcfg = cfg_pair(**{**small_kw(), **cfg_kw})
    data, q = _data(kind)
    js = j_init(jcfg, 500)
    js, _ = japi.apply(js, jcfg, japi.insert_batch(np.arange(64), data[:64]),
                       sequential=True, policy=policy)
    js, _ = japi.apply(js, jcfg, japi.insert_batch(np.arange(64, n),
                                                   data[64:n]), policy=policy)
    ts = convert.index_state_from_numpy(jax_index_numpy(js), "cpu")
    return jcfg, tcfg, js, ts, data, q


def _slots(ts, ext):
    return ts.ext2slot[torch.as_tensor(ext)].numpy().astype(np.int32)


def _stats_equal(jst, tst):
    for f in ("ok", "n_comps", "n_in"):
        assert_field(getattr(jst, f), getattr(tst, f), f"stats {f}")


def test_lazy_delete_many_matches_reference():
    jcfg, tcfg, js, ts, *_ = _built("grid")
    # duplicates, an INVALID lane and a free slot are no-ops
    ps = np.concatenate([_slots(ts, [3, 3, 17, 40]), [-1, 650]]).astype(
        np.int32)
    jg, jst = jdel.lazy_delete_many(js.graph, jcfg, jnp.asarray(ps))
    tg, tst = tdel.lazy_delete_many(ts.graph, tcfg, torch.from_numpy(ps))
    _stats_equal(jst, tst)
    assert tst.ok.tolist() == [True, False, True, True, False, False]
    assert_graph_equal(jg, tg, GRAPH, where="lazy")


@pytest.mark.parametrize("kind,cap", [("grid", 0), ("grid", 2),
                                      ("gauss", 0)])
def test_local_delete_many_matches_reference(kind, cap):
    jcfg, tcfg, js, ts, *_ = _built(kind, policy="local", local_in_cap=cap)
    assert tcfg.resolved_local_in_cap() == (cap or 2 * tcfg.r)
    ps = np.concatenate([_slots(ts, [5, 9, 9, 60, 61, 150]), [-1]]).astype(
        np.int32)
    # include the entry point: its replacement follows the reference
    ps[0] = int(ts.graph.start)
    jg, jst = jdel.local_delete_many(js.graph, jcfg, jnp.asarray(ps))
    tg, tst = tdel.local_delete_many(ts.graph, tcfg, torch.from_numpy(ps))
    _stats_equal(jst, tst)
    assert tst.ok.tolist() == [True, True, False, True, True, True, False]
    assert int(tst.n_in.max()) > 0
    assert_graph_equal(jg, tg, GRAPH, exact=kind == "grid", where="local")
    assert int(tg.n_pending) == 0


def test_remove_target_everywhere_matches_reference():
    jcfg, tcfg, js, ts, *_ = _built("grid")
    adj = ts.graph.adj.numpy()
    target = int(np.bincount(adj[adj >= 0]).argmax())   # most in-edges
    assert (adj == target).any(1).sum() > 3
    before = ts.graph.adj.clone()
    jadj = jedges.remove_target_everywhere(js.graph, jcfg,
                                           jnp.int32(target))
    tadj = tedges.remove_target_everywhere(ts.graph, tcfg, target)
    assert tadj is ts.graph.adj
    assert_field(jadj, tadj, "adj")
    untouched = ~(before == target).any(1)
    assert torch.equal(tadj[untouched], before[untouched])
    # INVALID targets are no-ops
    tedges.remove_target_everywhere(ts.graph, tcfg, -1)
    assert_field(jadj, ts.graph.adj, "adj after INVALID target")


@pytest.mark.parametrize("kind", KINDS)
def test_fresh_consolidate_matches_reference(kind):
    jcfg, tcfg, js, ts, _, q = _built(kind, policy="fresh")
    # tombstone a quarter, then the entry point
    start_ext = int(ts.slot2ext[int(ts.graph.start)])
    for ext in (np.arange(0, 200, 4), [start_ext]):
        js, _ = japi.apply(js, jcfg, japi.delete_batch(ext, DIM),
                           policy="fresh")
        ts, _ = tapi.apply(ts, tcfg, tapi.delete_batch(np.asarray(ext), DIM,
                                                       device="cpu"),
                           policy="fresh")
    assert_index_equal(js, ts, kind == "grid", "tombstoned")
    chunked = tcons.fresh_consolidate(
        convert.graph_state_from_numpy(
            convert.graph_state_to_numpy(ts.graph), "cpu"), tcfg, chunk=7)
    jg = jcons.fresh_consolidate(js.graph, jcfg)
    tg = tcons.fresh_consolidate(ts.graph, tcfg)
    assert_graph_equal(jg, tg, GRAPH, exact=kind == "grid", where="alg4")
    assert_graph_equal(tg, chunked, GRAPH, where="alg4 chunked")
    assert not bool(tg.tombstone.any()) and int(tg.n_pending) == 0
    adj = tg.adj
    assert bool(tg.active[adj[adj >= 0].long()].all())


@pytest.mark.parametrize("kind,alpha", [("grid", 1.2), ("grid", 1.0),
                                        ("gauss", 1.2)])
def test_wide_prune_matches_reference_and_dense(kind, alpha, monkeypatch):
    """The per-step formulation (C > ``WIDE_PRUNE_C``) and the dense pair
    matrix give the same rows, and both the reference's per row."""
    jcfg, tcfg, js, ts, *_ = _built(kind, alpha=alpha)
    rng = np.random.default_rng(5)
    m, c = 5, 600
    assert c > tprune.WIDE_PRUNE_C
    cand = rng.integers(-1, 220, size=(m, c)).astype(np.int32)  # dups too
    p_ids = _slots(ts, [1, 2, 3, 4, 5])
    tg = ts.graph
    p_vecs = tg.vectors[torch.from_numpy(p_ids).long()]
    args = (tg, tcfg, p_vecs, torch.from_numpy(cand))
    wide = tprune.robust_prune_rows(*args, p_ids=torch.from_numpy(p_ids))
    monkeypatch.setattr(tprune, "WIDE_PRUNE_C", c)
    dense = tprune.robust_prune_rows(*args, p_ids=torch.from_numpy(p_ids))
    if kind == "grid":
        assert torch.equal(wide, dense)
    for i in range(m):
        ref = jprune.robust_prune(js.graph, jcfg, jnp.asarray(p_vecs[i]),
                                  jnp.asarray(cand[i]),
                                  p_id=jnp.int32(p_ids[i]))
        assert_field(ref, wide[i], f"row {i}")
    assert bool((wide >= 0).sum(1).min() > 0)


def test_sorted_dedupe_equals_pair_compare():
    """``mask_duplicates`` (a stable sort) keeps exactly the first
    occurrence of each id, as the O(C^2) pair compare does, at an insert's
    width and an Alg-4 splice's."""
    rng = np.random.default_rng(6)
    for c in (13, 192, 700):
        ids = torch.from_numpy(rng.integers(-3, 40, size=(4, c)).astype(
            np.int32))
        earlier = torch.ones((c, c), dtype=torch.bool).tril(-1)
        dup = ((ids[..., :, None] == ids[..., None, :]) & earlier).any(-1)
        want = torch.where(dup | (ids < 0), -1, ids)
        assert torch.equal(ttypes.mask_duplicates(ids), want)


@pytest.mark.parametrize("kind,l,hops", [("grid", 16, 0), ("grid", 16, 4),
                                         ("gauss", 16, 0), ("grid", 1, 0)])
def test_per_lane_starts_match_greedy_search(kind, l, hops):
    """Per-lane ``starts`` through the batched engine equal the reference's
    ``greedy_search`` from each start (HNSW's per-query descent), also at
    l = 1 with 64 visits and through the super-step at H = 4."""
    jcfg, tcfg, js, ts, data, q = _built(kind)
    tcfg = dataclasses.replace(tcfg, hop_fused=hops)
    mv = 64 if l == 1 else None
    starts = np.concatenate([_slots(ts, [0, 7, 33, 90, 120, 150, 199]),
                             [-1]]).astype(np.int32)
    q8 = q[:8]
    res = tsb.batched_greedy_search(ts.graph, tcfg, torch.from_numpy(q8),
                                    k=5, l=l, max_visits=mv,
                                    starts=torch.from_numpy(starts))
    for i, s in enumerate(starts):
        jres = jsearch.greedy_search(js.graph._replace(start=jnp.int32(s)),
                                     jcfg, jnp.asarray(q8[i]), k=5, l=l,
                                     max_visits=mv)
        lane = type(res)(*(x[i] for x in res))
        assert_search_equal(jres, lane, kind == "grid", f"lane {i}")
    assert int(res.n_hops[-1]) == 0 and int(res.topk_ids[-1].max()) == -1


def _updates_cfg():
    return dict(dim=12, n_cap=160, r=8, l_build=16, l_search=16,
                l_delete=16, k_delete=10, n_copies=2, alpha=1.2)


def test_fresh_mode_invariants_and_consolidation():
    """``test_updates.py``'s fresh case, both packages, state for state."""
    jcfg, tcfg = cfg_pair(**_updates_cfg())
    data, _ = make_dataset(120, 12, n_queries=4, seed=3)
    ji = JIndex(jcfg, mode="fresh", max_external_id=300)
    ti = TIndex(tcfg, mode="fresh", max_external_id=300, device="cpu")
    for idx in (ji, ti):
        idx.insert(np.arange(120), data)
        idx.delete(np.arange(40))    # 33% > threshold: Alg 4 fires
    assert ji.counters.n_consolidations == ti.counters.n_consolidations >= 1
    assert_index_equal(ji.istate, ti.istate, exact=False, where="fresh")
    assert_graph_invariants(ji.istate, jcfg, policy="fresh",
                            consolidated=True)
    assert not bool(ti.state.tombstone.any())
    adj = ti.state.adj
    assert bool(ti.state.active[adj[adj >= 0].long()].all())


def test_fresh_consolidate_restores_recall():
    """``test_consolidate.py``'s Alg-4 case: 60 of 150 tombstoned, a forced
    consolidation, recall restored; both packages, state for state."""
    kw = dict(_updates_cfg(), n_cap=200, consolidation_threshold=10.0)
    kw.pop("alpha")
    jcfg, tcfg = cfg_pair(**kw)
    data, queries = make_dataset(150, 12, n_queries=8, seed=0)
    ji = JIndex(jcfg, mode="fresh", max_external_id=1000)
    ti = TIndex(tcfg, mode="fresh", max_external_id=1000, device="cpu")
    for idx in (ji, ti):
        idx.insert(np.arange(150), data)
        idx.delete(np.arange(0, 60))
    assert ti.counters.n_consolidations == 0
    assert_index_equal(ji.istate, ti.istate, exact=False, where="pre")
    for idx in (ji, ti):
        assert idx.maybe_consolidate(force=True)
    assert_index_equal(ji.istate, ti.istate, exact=False, where="post")
    assert_graph_invariants(ji.istate, jcfg, policy="fresh",
                            consolidated=True)
    assert not bool(ti.state.tombstone.any())
    r = ti.recall(queries, k=10)
    assert r == ji.recall(queries, k=10) and r >= 0.9
