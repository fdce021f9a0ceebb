"""The int8 quantized tier and capacity growth of the port against the JAX
reference, on the CPU.

``qgrid`` data (grid values with one entry of each row at +-127/16) makes
every row's scale exactly 2^-4, so codes, dequantized rows, qnorms and every
quantized distance are exact in float32 and the packages must agree
bitwise; Gaussian data is held to rtol 1e-6 for qnorms and to the
reference's kernel bar (ids and counters exact, distances rtol 2e-5) for
distances.  The Pallas kernels run in interpret mode, at n_cap <= 512 and
B <= 8 because interpret mode is slow.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_parity import (assert_field, assert_index_equal,
                          assert_search_equal, cfg_pair, jax_index_numpy, n,
                          qgrid_data, small_kw, t)

from repro.core import api as japi
from repro.core import grow as jgrow
from repro.core import quant as jquant
from repro.core.search_batched import batched_greedy_search as j_search
from repro.core.types import init_index_state as j_init
from repro_torch import convert
from repro_torch.core import grow as tgrow
from repro_torch.core import quant as tquant
from repro_torch.core.backend import get_backend
from repro_torch.core.search_batched import batched_greedy_search as t_search
from repro_torch.kernels import beam_hop as tbh
from repro_torch.kernels import quant_gather as tqg
from repro_torch.kernels import ref as tref

N_CAP = 250  # not a multiple of 32


def _data(kind, nrow, dim, seed, metric="l2"):
    if kind == "qgrid":
        return qgrid_data(nrow, dim, seed)
    from repro.core.runbook import make_dataset

    return make_dataset(nrow, dim, metric, n_queries=1, seed=seed)[0]


def _tables(vec):
    """(codes, scale, qnorms) of a numpy table through the reference."""
    q = jquant.quant_write_rows(jquant.init_quant_store(*vec.shape),
                                jnp.arange(vec.shape[0]), jnp.asarray(vec))
    return tuple(np.asarray(x) for x in q)


# -- codes ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["qgrid", "gauss"])
def test_quantize_and_write_rows_match_reference(kind):
    """Codes and scales bitwise; qnorms bitwise on qgrid rows, rtol 1e-6 on
    Gaussian rows (a sum in another order); zero rows take scale 1."""
    xs = _data(kind, 40, 24, 5)
    xs[3] = 0.0
    jc, js = jquant.quantize_rows(jnp.asarray(xs))
    tc, ts = tquant.quantize_rows(torch.from_numpy(xs))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert_field(jc, tc, "codes")
    assert_field(js, ts, "scale")
    assert float(ts[3]) == 1.0
    assert_field(jquant.dequantize_rows(jc, js),
                 tquant.dequantize_rows(tc, ts), "dequantized rows")
    rows = np.array([7, 0, 33, 12], np.int32)
    jq = jquant.quant_write_rows(jquant.init_quant_store(50, 24),
                                 jnp.asarray(rows), jnp.asarray(xs[:4]))
    tq = tquant.quant_write_rows(tquant.init_quant_store(50, 24, "cpu"),
                                 torch.from_numpy(rows).long(),
                                 torch.from_numpy(xs[:4]))
    assert_field(jq.codes, tq.codes, "store codes")
    assert_field(jq.scale, tq.scale, "store scale")
    if kind == "qgrid":
        assert_field(jq.qnorms, tq.qnorms, "store qnorms")
    else:
        np.testing.assert_allclose(n(tq.qnorms), np.asarray(jq.qnorms),
                                   rtol=1e-6, err_msg="store qnorms")


# -- kernel 5: gather_distance_batched_q ------------------------------------


@pytest.mark.parametrize("kind", ["qgrid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dim", [24, 130])
def test_quant_gather_plain_vs_pallas_and_ref(kind, metric, dim):
    from repro.kernels import ref as jref
    from repro.kernels.quant_gather import gather_distance_batched_q

    rng = np.random.default_rng(dim)
    vec = _data(kind, N_CAP, dim, 1, metric)
    q = _data(kind, 6, dim, 2, metric)
    ids = rng.integers(0, N_CAP, size=(6, 20)).astype(np.int32)
    ids[rng.random((6, 20)) < 0.2] = -1
    ids[:, 1] = ids[:, 0]                       # duplicates
    tables = _tables(vec)
    out = tqg.gather_distance_batched_q(t(ids), t(q), *map(t, tables),
                                        metric=metric)
    jargs = (jnp.asarray(ids), jnp.asarray(q),
             *(jnp.asarray(x) for x in tables))
    pal = gather_distance_batched_q(*jargs, metric=metric, interpret=True)
    jr = jref.quant_gather_distance_batched_ref(*jargs, metric=metric)
    tr = tref.quant_gather_distance_batched_ref(t(ids), t(q),
                                                *map(t, tables),
                                                metric=metric)
    exact = kind == "qgrid"
    assert_field(pal, out, "plain vs pallas", exact)
    assert_field(jr, tr, "ref vs ref", exact)
    assert_field(tr, out, "plain vs ref", exact)
    assert np.isinf(n(out)[ids < 0]).all()


# -- kernel 6: beam_hop_fused_q ---------------------------------------------


def _beam_inputs_q(kind, metric, b, l, r, dim, seed=0):
    """A random graph over quantized rows with duplicate neighbour ids, a
    tombstoned (navigable, not returnable) entry point and a masked lane,
    plus an initial carry (d0 from the quantized gather)."""
    rng = np.random.default_rng(seed)
    vec = _data(kind, N_CAP, dim, seed + 1, metric)
    codes, scale, qnorms = _tables(vec)
    adj = rng.integers(0, N_CAP, size=(N_CAP, r)).astype(np.int32)
    adj[rng.random((N_CAP, r)) < 0.2] = -1
    adj[:, 1] = adj[:, 0]
    nav = rng.random(N_CAP) < 0.95
    ret = nav & (rng.random(N_CAP) < 0.9)
    start = int(np.nonzero(nav & ~ret)[0][0])
    q = _data(kind, b, dim, seed + 2, metric)
    starts = np.full((b,), start, np.int32)
    starts[b // 2] = -1
    d0 = n(tqg.gather_distance_batched_q(
        t(starts[:, None]), t(q), t(codes), t(scale), t(qnorms),
        metric=metric))[:, 0]
    bi = np.full((b, l), -1, np.int32)
    bi[:, 0] = starts
    bd = np.full((b, l), np.inf, np.float32)
    bd[:, 0] = d0
    seen = np.zeros((b, (N_CAP + 31) // 32), np.uint32)
    for i, s in enumerate(starts):
        if s >= 0:
            seen[i, s >> 5] |= np.uint32(1 << (s & 31))
    mv = l + 8
    carry = (bi, bd, np.zeros((b, l), np.int32), seen,
             np.full((b, mv), -1, np.int32),
             np.full((b, mv), np.inf, np.float32), np.zeros((b,), np.int32),
             (starts >= 0).astype(np.int32), np.zeros((b,), np.int32))
    from repro.core import bitset as jbitset

    words = [np.asarray(jbitset.pack_bits(jnp.asarray(m))) for m in (nav, ret)]
    return q, carry, (adj, codes, scale, qnorms, *words)


@pytest.mark.parametrize("kind", ["qgrid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("h", [1, 3])
def test_beam_hop_q_plain_vs_ref(kind, metric, h):
    """Super-steps of the plain quantized hop against ``beam_hop_ref_q``,
    each fed its own output until every lane converges."""
    from repro.kernels.beam_hop import beam_hop_ref_q

    q, carry, static = _beam_inputs_q(kind, metric, b=8, l=16, r=8, dim=20)
    jc = tuple(jnp.asarray(x) for x in carry)
    tc = tuple(t(x) for x in carry)
    js = tuple(jnp.asarray(x) for x in static)
    ts = tuple(t(x) for x in static)
    exact = kind == "qgrid"
    for step in range(12):
        jc = beam_hop_ref_q(jnp.asarray(q), *jc, *js, metric=metric, h=h)
        tc = tbh.beam_hop_fused_q(t(q), *tc, *ts, metric=metric, h=h)
        for i, (a, b) in enumerate(zip(jc, tc)):
            assert_field(a, b, f"step {step} carry field {i}", exact)
    assert n(tc[8]).sum() > 0  # the lanes did hop


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("h", [1, 3])
def test_beam_hop_q_plain_vs_pallas_interpret(metric, h):
    """Against the Pallas kernel itself (interpret mode), on qgrid data."""
    from repro.kernels import ops

    q, carry, static = _beam_inputs_q("qgrid", metric, b=3, l=8, r=6, dim=8)
    jc = ops.beam_hop_q(jnp.asarray(q), *(jnp.asarray(x) for x in carry),
                        *(jnp.asarray(x) for x in static), metric=metric,
                        h=h, interpret=True)
    tc = tbh.beam_hop_fused_q(t(q), *(t(x) for x in carry),
                              *(t(x) for x in static), metric=metric, h=h)
    for i, (a, b) in enumerate(zip(jc, tc)):
        assert_field(a, b, f"carry field {i}")
    assert n(tc[8]).sum() > 0


# -- the quantized batched engine -------------------------------------------


def _built_pair(metric, kind="qgrid", n_pts=220):
    """A quantized index built and churned by the reference, and the same
    state carried into the port."""
    jcfg, tcfg = cfg_pair(**small_kw(metric, dim=20, n_cap=300),
                          quantized=True)
    data = _data(kind, n_pts, 20, 7, metric)
    st = j_init(jcfg, 400)
    st, _ = japi.apply(st, jcfg, japi.insert_batch(np.arange(64), data[:64]),
                       sequential=True)
    st, _ = japi.apply(st, jcfg, japi.insert_batch(
        np.arange(64, n_pts), data[64:]))
    st, _ = japi.apply(st, jcfg, japi.delete_batch(np.arange(0, 40, 3), 20))
    tst = convert.index_state_from_numpy(jax_index_numpy(st), "cpu")
    return jcfg, tcfg, st, tst


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("engine", ["torch", "ref"])
@pytest.mark.parametrize("hops", [0, 3])
def test_quantized_batched_search_matches_reference(metric, engine, hops):
    """Ids, visited lists and counters exact; ``topk_dists`` bitwise equal
    to the f32 rescore of the returned ids (and to the reference's)."""
    import dataclasses

    jcfg, tcfg, jst, tst = _built_pair(metric)
    jcfg = dataclasses.replace(jcfg, hop_fused=hops)
    tcfg = dataclasses.replace(tcfg, backend=engine, hop_fused=hops)
    qs = qgrid_data(8, 20, 9)
    valid = np.ones(8, bool)
    valid[5] = False
    jr = j_search(jst.graph, jcfg, jnp.asarray(qs), k=10, l=32,
                  valid=jnp.asarray(valid))
    tr = t_search(tst.graph, tcfg, torch.from_numpy(qs), k=10, l=32,
                  valid=torch.from_numpy(valid))
    assert_search_equal(jr, tr)
    rescore = get_backend(engine).dists_to_ids_batched(
        tst.graph, tcfg, torch.from_numpy(qs), tr.topk_ids)
    assert torch.equal(rescore, tr.topk_dists)
    assert (n(tr.topk_ids)[valid] >= 0).any()


def test_quantized_torch_engine_gaussian_matches_reference():
    """The same on Gaussian data: ids and counters exact, distances to the
    reference's bar."""
    jcfg, tcfg, jst, tst = _built_pair("l2", kind="gauss")
    qs = _data("gauss", 6, 20, 11)
    jr = j_search(jst.graph, jcfg, jnp.asarray(qs), k=10, l=32)
    tr = t_search(tst.graph, tcfg, torch.from_numpy(qs), k=10, l=32)
    assert_search_equal(jr, tr, exact=False)


# -- capacity growth ----------------------------------------------------------


@pytest.mark.parametrize("needed,n_cap", [(1, 1), (10, 16), (15, 16),
                                          (16, 16), (100, 100), (900, 300),
                                          (5000, 1024)])
def test_next_capacity_matches_reference(needed, n_cap):
    assert tgrow.next_capacity(needed, n_cap) == \
        jgrow.next_capacity(needed, n_cap)


@pytest.mark.parametrize("quantized", [False, True])
def test_grow_index_matches_reference_leaf_for_leaf(quantized):
    """Every leaf, the quant store and the free-stack order included; the
    input handle is left as it was."""
    jcfg, tcfg, jst, tst = _built_pair("l2")
    if not quantized:
        jst = jst._replace(graph=jst.graph._replace(quant=None))
        tst = tst._replace(graph=tst.graph._replace(quant=None))
    before = convert.index_state_to_numpy(tst)
    jg, jc2 = jgrow.grow_index(jst, jcfg, 1024)
    tg, tc2 = tgrow.grow_index(tst, tcfg, 1024)
    assert jc2.n_cap == tc2.n_cap == 1024
    assert_index_equal(jg, tg, where="grown")
    after = convert.index_state_to_numpy(tst)
    for f in ("ext2slot", "slot2ext", "n_inserts"):
        np.testing.assert_array_equal(before[f], after[f])
    assert after["graph"]["free_stack"].shape == (300,)
    # the grown slots pop in ascending order, n_cap first
    top = int(tg.graph.free_top)
    assert n(tg.graph.free_stack)[top - 3:top].tolist() == [302, 301, 300]
    tg.graph.n_active.add_(1)  # the two handles share no tensor
    assert int(tst.graph.n_active) == int(jst.graph.n_active)
    with pytest.raises(ValueError):
        tgrow.grow_index(tst, tcfg, 100)


def test_ensure_capacity_matches_reference():
    jcfg, tcfg, jst, tst = _built_pair("l2")
    for incoming in (10, 60, 400):
        js2, jc2, jgrew = jgrow.ensure_capacity(jst, jcfg, incoming)
        ts2, tc2, tgrew = tgrow.ensure_capacity(tst, tcfg, incoming)
        assert jgrew == tgrew and jc2.n_cap == tc2.n_cap
        assert_index_equal(js2, ts2, where=f"incoming {incoming}")
