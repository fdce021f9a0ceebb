"""The port's kernels: plain versions against the JAX kernels, and (on a
card) the CUDA kernels against their plain versions.

On the CPU every plain version (``repro_torch/kernels/*``) is held against
the reference's Pallas kernel in interpret mode and against
``repro/kernels/ref.py``, on grid-valued data bitwise and on Gaussian data
to the reference's bar.  The matrix covers both metrics, INVALID ids, D not
a multiple of 128, duplicate neighbour ids, a tombstoned entry point,
masked lanes, H not dividing the hop count and n_cap not a multiple of 32.

The int8 tier's kernels (``quant_gather``, ``beam_hop_fused_q``) are held
against the reference in ``tests/test_torch_quant.py``.  The plain fused
hops, and the torch engine's batched search, are also held to the
invariant the CUDA hop kernel's merge relies on: every super-step leaves
each lane's beam sorted by distance.

The ``requires_cuda`` tests run the CUDA kernels against their plain
versions on the card (``python -m pytest --noconftest -m requires_cuda
tests/test_torch_kernels.py``: the card's machine has no JAX, which
``tests/conftest.py`` imports); elsewhere they skip.  JAX is imported inside
the CPU tests only, so the card-only tests collect without it.
"""
import numpy as np
import pytest
import torch

from torch_parity import (assert_field, cuda_device,  # noqa: F401
                          grid_data, n, qgrid_data, t)

from repro_torch.core import bitset as tbitset
from repro_torch.core.quant import quantize_rows
from repro_torch.kernels import beam_hop as tbh
from repro_torch.kernels import gather_distance as tgd
from repro_torch.kernels import quant_gather as tqg
from repro_torch.kernels import ref as tref
from repro_torch.kernels import robust_prune as trp
from repro_torch.kernels import topk_score as ttk

N_CAP = 250  # not a multiple of 32


def _data(kind, nrow, dim, seed, metric="l2"):
    if kind == "grid":
        return grid_data(nrow, dim, seed)
    if kind == "qgrid":
        return qgrid_data(nrow, dim, seed)
    from repro_torch.core.runbook import make_dataset

    return make_dataset(nrow, dim, metric, n_queries=1, seed=seed)[0]


def _close(a, b, exact, msg):
    assert_field(a, b, msg, exact)


def _ids(rng, b, k, n_cap):
    ids = rng.integers(0, n_cap, size=(b, k)).astype(np.int32)
    ids[rng.random((b, k)) < 0.2] = -1
    return ids


@pytest.mark.parametrize("kind", ["grid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dim", [24, 130])
def test_gather_distance_batched_plain(kind, metric, dim):
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.gather_distance import gather_distance_batched

    rng = np.random.default_rng(dim)
    vec = _data(kind, N_CAP, dim, 1, metric)
    q = _data(kind, 6, dim, 2, metric)
    ids = _ids(rng, 6, 20, N_CAP)
    norms = (vec * vec).sum(1).astype(np.float32)
    out = tgd.gather_distance_batched(t(ids), t(q), t(vec), t(norms),
                                      metric=metric)
    pal = gather_distance_batched(jnp.asarray(ids), jnp.asarray(q),
                                  jnp.asarray(vec), jnp.asarray(norms),
                                  metric=metric, interpret=True)
    jr = jref.gather_distance_batched_ref(jnp.asarray(ids), jnp.asarray(q),
                                          jnp.asarray(vec), metric=metric)
    tr = tref.gather_distance_batched_ref(t(ids), t(q), t(vec),
                                          metric=metric)
    exact = kind == "grid"
    _close(pal, out, exact, "plain vs pallas")
    _close(jr, tr, exact, "ref vs ref")
    _close(tr, out, exact, "plain vs ref")
    assert np.isinf(n(out)[ids < 0]).all()


@pytest.mark.parametrize("kind", ["grid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("with_norms", [True, False])
def test_gather_distance_plain(kind, metric, with_norms):
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.gather_distance import gather_distance

    rng = np.random.default_rng(3)
    vec = _data(kind, N_CAP, 20, 4, metric)
    q = _data(kind, 1, 20, 5, metric)[0]
    ids = _ids(rng, 1, 17, N_CAP)[0]
    norms = (vec * vec).sum(1).astype(np.float32) if with_norms else None
    out = tgd.gather_distance(t(ids), t(q), t(vec),
                              None if norms is None else t(norms),
                              metric=metric)
    pal = gather_distance(jnp.asarray(ids), jnp.asarray(q), jnp.asarray(vec),
                          None if norms is None else jnp.asarray(norms),
                          metric=metric, interpret=True)
    jr = jref.gather_distance_ref(jnp.asarray(ids), jnp.asarray(q),
                                  jnp.asarray(vec), metric=metric)
    exact = kind == "grid"
    _close(pal, out, exact, "plain vs pallas")
    _close(jr, tref.gather_distance_ref(t(ids), t(q), t(vec), metric=metric),
           exact, "ref vs ref")


def quant_tables(vec):
    """(codes, scale, qnorms) of a numpy table, through the port's
    ``quantize_rows``."""
    codes, scale = quantize_rows(torch.from_numpy(vec))
    deq = codes.float() * scale[:, None]
    return n(codes), n(scale), n((deq * deq).sum(1))


def _beam_inputs(kind, metric, b=6, l=16, r=8, dim=20, seed=0,
                 tombstoned_start=True):
    """A random graph with duplicate neighbour ids, a tombstoned (navigable,
    not returnable) entry point and masked lanes, plus an initial carry."""
    rng = np.random.default_rng(seed)
    vec = _data(kind, N_CAP, dim, seed + 1, metric)
    norms = (vec * vec).sum(1).astype(np.float32)
    adj = rng.integers(0, N_CAP, size=(N_CAP, r)).astype(np.int32)
    adj[rng.random((N_CAP, r)) < 0.2] = -1
    adj[:, 1] = adj[:, 0]                      # duplicate neighbours
    nav = rng.random(N_CAP) < 0.95
    ret = nav & (rng.random(N_CAP) < 0.9)
    start = int(np.nonzero(nav & ~ret)[0][0]) if tombstoned_start \
        else int(np.nonzero(ret)[0][0])
    q = _data(kind, b, dim, seed + 2, metric)
    mv = l + 8
    starts = np.full((b,), start, np.int32)
    starts[b // 2] = -1                        # a masked lane
    bi = np.full((b, l), -1, np.int32)
    bi[:, 0] = starts
    d0 = n(tgd.gather_distance_batched(t(starts[:, None]), t(q), t(vec),
                                       t(norms), metric=metric))[:, 0]
    bd = np.full((b, l), np.inf, np.float32)
    bd[:, 0] = d0
    seen = np.zeros((b, (N_CAP + 31) // 32), np.uint32)
    for i, s in enumerate(starts):
        if s >= 0:
            seen[i, s >> 5] |= np.uint32(1 << (s & 31))
    carry = (bi, bd, np.zeros((b, l), np.int32), seen,
             np.full((b, mv), -1, np.int32), np.full((b, mv), np.inf,
                                                     np.float32),
             np.zeros((b,), np.int32), (starts >= 0).astype(np.int32),
             np.zeros((b,), np.int32))
    pack = lambda m: np.asarray(  # noqa: E731
        [int(sum(int(x) << i for i, x in enumerate(m[w * 32:w * 32 + 32])))
         for w in range((N_CAP + 31) // 32)], np.uint32)
    static = (adj, vec, norms, pack(nav), pack(ret))
    return q, carry, static


@pytest.mark.parametrize("kind", ["grid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("h", [3, 4])
def test_beam_hop_plain_vs_ref(kind, metric, h):
    """Super-steps of the plain fused hop against ``beam_hop_ref``, fed
    their own outputs until every lane converges."""
    import jax.numpy as jnp

    from repro.kernels.beam_hop import beam_hop_ref

    q, carry, static = _beam_inputs(kind, metric)
    jc = tuple(jnp.asarray(x) for x in carry)
    tc = tuple(t(x) for x in carry)
    js = tuple(jnp.asarray(x) for x in static)
    ts = tuple(t(x) for x in static)
    exact = kind == "grid"
    for step in range(12):
        jc = beam_hop_ref(jnp.asarray(q), *jc, *js, metric=metric, h=h)
        tc = tbh.beam_hop_fused(t(q), *tc, *ts, metric=metric, h=h)
        for i, (a, b) in enumerate(zip(jc, tc)):
            _close(a, b, exact, f"step {step} carry field {i}")
    assert n(tc[8]).sum() > 0  # the lanes did hop


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_beam_hop_plain_vs_pallas_interpret(metric):
    """One tiny case against the Pallas kernel itself (interpret mode)."""
    import jax.numpy as jnp

    from repro.kernels import ops

    q, carry, static = _beam_inputs("grid", metric, b=2, l=8, r=4, dim=8,
                                    tombstoned_start=False)
    jc = ops.beam_hop(jnp.asarray(q), *(jnp.asarray(x) for x in carry),
                      *(jnp.asarray(x) for x in static), metric=metric, h=2,
                      interpret=True)
    tc = tbh.beam_hop_fused(t(q), *(t(x) for x in carry),
                            *(t(x) for x in static), metric=metric, h=2)
    for i, (a, b) in enumerate(zip(jc, tc)):
        _close(a, b, True, f"carry field {i}")


@pytest.mark.parametrize("kind", ["grid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n_rows,live", [(1500, 0.7), (40, 0.15)])
def test_topk_score_plain(kind, metric, n_rows, live):
    """Against ``ops.topk_search`` (the padded Pallas scan, interpret mode)
    and ``ref.topk_score_ref``, with dead rows biased out; the (40, 0.15)
    case has fewer than k live rows."""
    import jax.numpy as jnp

    from repro.kernels import ops
    from repro.kernels import ref as jref

    rng = np.random.default_rng(n_rows)
    vec = _data(kind, n_rows, 24, 6, metric)
    q = _data(kind, 5, 24, 7, metric)
    norms = (vec * vec).sum(1).astype(np.float32)
    bias = np.where(rng.random(n_rows) < live, 0.0, np.inf).astype(
        np.float32)
    k = 10
    tv, ti = ttk.topk_score(t(q), t(vec), t(norms), t(bias), k=k,
                            metric=metric)
    jv, ji = ops.topk_search(jnp.asarray(q), jnp.asarray(vec),
                             jnp.asarray(norms), k=k, metric=metric,
                             bias=jnp.asarray(bias), interpret=True)
    exact = kind == "grid"
    _close(jv, tv, exact, "plain vs pallas dists")
    _close(ji, ti, True, "plain vs pallas ids")
    rv, ri = jref.topk_score_ref(jnp.asarray(q), jnp.asarray(vec),
                                 jnp.asarray(norms), jnp.asarray(bias), k=k,
                                 metric=metric)
    fin = np.isfinite(np.asarray(rv))
    np.testing.assert_array_equal(np.where(fin, np.asarray(ri), -1), n(ti))
    tv2, ti2 = tref.topk_score_ref(t(q), t(vec), t(norms), t(bias), k=k,
                                   metric=metric)
    _close(rv, tv2, exact, "ref vs ref dists")
    _close(ri, ti2, True, "ref vs ref ids")


def _sorted_rows(x):
    """True when every row of ``x`` is non-decreasing (inf included)."""
    x = n(x)
    return bool((x[:, :-1] <= x[:, 1:]).all())


@pytest.mark.parametrize("kind", ["grid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("quantized", [False, True])
def test_plain_superstep_keeps_beam_sorted(kind, metric, quantized):
    """Every plain super-step of the ``_beam_inputs`` streams, and the
    reference's ``beam_hop_ref`` / ``beam_hop_ref_q`` beside it, leaves each
    lane's ``beam_dists`` non-decreasing: the invariant the CUDA kernel's
    merge relies on (it refuses a beam that breaks it)."""
    import jax.numpy as jnp

    from repro.kernels.beam_hop import beam_hop_ref, beam_hop_ref_q

    if quantized and kind == "grid":
        kind = "qgrid"
    q, carry, static = _beam_inputs(kind, metric)
    if quantized:
        adj, vec, _, nav, ret = static
        static = (adj, *quant_tables(vec), nav, ret)
    tc = tuple(t(x) for x in carry)
    jc = tuple(jnp.asarray(x) for x in carry)
    ts = tuple(t(x) for x in static)
    js = tuple(jnp.asarray(x) for x in static)
    assert _sorted_rows(tc[1])
    for step in range(12):
        if quantized:
            tc = tbh.beam_hop_fused_q(t(q), *tc, *ts, metric=metric, h=3)
            jc = beam_hop_ref_q(jnp.asarray(q), *jc, *js, metric=metric,
                                h=3)
        else:
            tc = tbh.beam_hop_fused(t(q), *tc, *ts, metric=metric, h=3)
            jc = beam_hop_ref(jnp.asarray(q), *jc, *js, metric=metric, h=3)
        assert _sorted_rows(tc[1]), f"plain, step {step}"
        assert _sorted_rows(jc[1]), f"reference, step {step}"
    assert n(tc[8]).sum() > 0


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("quantized", [False, True])
def test_torch_engine_search_keeps_beam_sorted(metric, quantized,
                                               monkeypatch):
    """Every super-step of ``batched_greedy_search`` on the torch engine,
    through inserts and a query batch, starts and ends with each lane's
    ``beam_dists`` non-decreasing."""
    import dataclasses

    from torch_parity import small_kw

    from repro_torch.core import api as tapi
    from repro_torch.core import backend as tbackend
    from repro_torch.core.search_batched import batched_greedy_search
    from repro_torch.core.types import ANNConfig, init_index_state

    steps = []

    def checked(name):
        inner = getattr(tbackend.DistanceBackend, name)

        def superstep(self, state, cfg, queries, carry, **kw):
            assert _sorted_rows(carry.beam_dists), f"{name} input"
            out = inner(self, state, cfg, queries, carry, **kw)
            assert _sorted_rows(out.beam_dists), f"{name} output"
            steps.append(name)
            return out
        return superstep

    for name in ("beam_superstep", "beam_superstep_q"):
        monkeypatch.setattr(tbackend.TorchBackend, name, checked(name))
    cfg = dataclasses.replace(
        ANNConfig(**small_kw(metric, dim=16, n_cap=200), backend="torch",
                  quantized=quantized), hop_fused=3)
    kind = "qgrid" if quantized else "grid"
    data = _data(kind, 140, 16, 3, metric)
    st = init_index_state(cfg, 140, device="cpu")
    st, _ = tapi.apply(st, cfg, tapi.insert_batch(np.arange(20), data[:20],
                                                  device="cpu"),
                       sequential=True)
    st, _ = tapi.apply(st, cfg, tapi.insert_batch(np.arange(20, 140),
                                                  data[20:], device="cpu"))
    res = batched_greedy_search(st.graph, cfg, t(_data(kind, 9, 16, 4)),
                                k=5, l=24)
    assert ("beam_superstep_q" if quantized else "beam_superstep") in steps
    assert (n(res.n_hops) > 0).all()


def test_stable_topk_breaks_ties_low():
    d = torch.tensor([[3.0, 1.0, 1.0, 0.0, 1.0, float("inf")]])
    vals, idx = tref.stable_topk_smallest(d, 4)
    assert idx.tolist() == [[3, 1, 2, 4]]


def _prune_inputs(metric, m, c, dev, seed):
    """Kernel 7's inputs as ``core/prune.py::robust_prune_rows`` makes them,
    on grid data with ties: ids i32[M, C] (distinct in a row, INVALID where
    dead), d_p f32[M, C] (+inf where dead) and the pair matrix
    f32[M, C, C].  The table holds equal vectors in distinct slots, and
    d_p's columns 2 and 3 are equal; row 1 has no live candidate and row 2
    ten, fewer than r."""
    from repro_torch.core.distance import pair_dists

    rng = np.random.default_rng(seed)
    n_rows = 1024
    vec = grid_data(n_rows, 24, seed)
    vec[512:552] = vec[:40]
    ids = np.stack([rng.permutation(n_rows)[:c] for _ in range(m)])
    ids = ids.astype(np.int32)
    ids[rng.random((m, c)) < 0.15] = -1
    if m > 1:
        ids[1] = -1
    if m > 2:
        ids[2, 10:] = -1
    ids_d, vec_d, p_d = _to(dev, ids, vec, grid_data(m, 24, seed + 1))
    cv = vec_d[ids_d.clamp(min=0).long()]                     # (M, C, D)
    cn = (cv * cv).sum(-1)
    prod = torch.bmm(cv, p_d.unsqueeze(-1)).squeeze(-1)
    d_p = ((p_d * p_d).sum(1)[:, None] + cn - 2.0 * prod
           if metric == "l2" else -prod)
    if c > 3:
        d_p[:, 3] = d_p[:, 2]
    d_p = torch.where(ids_d >= 0, d_p, torch.full_like(d_p, float("inf")))
    return ids_d, d_p, pair_dists(metric, cv, cn, cv, cn)


def test_robust_prune_routes_cpu_to_plain():
    """CPU tensors take the plain loop (no launch); the CUDA launcher
    refuses them."""
    ids, d_p, pair = _prune_inputs("l2", 3, 65, "cpu", 0)
    n0 = trp.LAUNCHES["robust_prune"]
    got = trp.robust_prune_select(ids, d_p, pair, 1.2, 64)
    assert trp.LAUNCHES["robust_prune"] == n0
    assert torch.equal(got, trp.robust_prune_select_plain(ids, d_p, pair,
                                                          1.2, 64))
    assert got.dtype == torch.int32 and got.shape == (3, 64)
    assert (got[1] == -1).all() and (got[0] >= 0).any()
    with pytest.raises(ValueError, match="CUDA"):
        trp.robust_prune_select_cuda(ids, d_p, pair, 1.2, 64)


# ---------------------------------------------------------------------------
# on the card: CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


def _to(dev, *xs):
    return tuple(None if x is None else t(x).to(dev) for x in xs)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["grid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("with_norms", [True, False])
def test_cuda_gather_distance(cuda_device, kind, metric, with_norms):
    rng = np.random.default_rng(11)
    vec = _data(kind, N_CAP, 130, 1, metric)
    q = _data(kind, 7, 130, 2, metric)
    ids = _ids(rng, 7, 64, N_CAP)
    norms = (vec * vec).sum(1).astype(np.float32) if with_norms else None
    ids_d, q_d, vec_d, norms_d = _to(cuda_device, ids, q, vec, norms)
    a = tgd.gather_distance_batched_cuda(ids_d, q_d, vec_d, norms_d,
                                         metric=metric)
    p = tgd.gather_distance_batched_plain(ids_d, q_d, vec_d, norms_d,
                                          metric=metric)
    _close(p, a, kind == "grid", "batched kernel vs plain")
    a1 = tgd.gather_distance_cuda(ids_d[0], q_d[0], vec_d, norms_d,
                                  metric=metric)
    p1 = tgd.gather_distance_plain(ids_d[0], q_d[0], vec_d, norms_d,
                                   metric=metric)
    _close(p1, a1, kind == "grid", "single kernel vs plain")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["grid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("h", [1, 3, 4])
def test_cuda_beam_hop(cuda_device, kind, metric, h):
    q, carry, static = _beam_inputs(kind, metric, b=9, l=32, r=16, dim=40)
    qd = _to(cuda_device, q)[0]
    sd = _to(cuda_device, *static)
    c = _to(cuda_device, *carry)
    for step in range(10):
        p = tbh.beam_hop_fused_plain(qd, *c, *sd, metric=metric, h=h)
        k = tbh.beam_hop_fused_cuda(qd, *(x.clone() for x in c), *sd,
                                    metric=metric, h=h)
        for i, (a, b) in enumerate(zip(p, k)):
            _close(a, b, kind == "grid", f"step {step} field {i}")
        c = p


def _q_ids(rng, b, k):
    """A (b, k) int8-gather id tile over ``N_CAP`` rows: INVALID ids, and
    ids >= N_CAP (the kernel reads row N_CAP - 1 for those)."""
    ids = _ids(rng, b, k, N_CAP)
    past = rng.random((b, k)) < 0.05
    ids[past] = N_CAP + rng.integers(0, 5, size=int(past.sum()))
    return ids


# K = 1 packs several queries into a block (the search's start distance),
# 7 leaves a warp's rows part-used, 64 is a hop's tile, 65 takes a second
# round of rows; D = 32 and 100 use fewer than 32 lanes' chunks, 130 takes
# the byte loads, 2,048 stages 8 KB of query a block.
@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["qgrid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dim", [32, 100, 128, 130, 2048])
@pytest.mark.parametrize("k", [1, 7, 64, 65])
def test_cuda_quant_gather(cuda_device, kind, metric, dim, k):
    rng = np.random.default_rng(dim + k)
    vec = _data(kind, N_CAP, dim, 1, metric)
    q = _data(kind, 9, dim, 2, metric)
    ids = _q_ids(rng, 9, k)
    args = _to(cuda_device, ids, q, *quant_tables(vec))
    a = tqg.gather_distance_batched_q_cuda(*args, metric=metric)
    p = tqg.gather_distance_batched_q_plain(*args, metric=metric)
    _close(p, a, kind == "qgrid", "quantized kernel vs plain")
    assert np.isinf(n(a)[ids < 0]).all()
    assert np.isfinite(n(a)[ids >= 0]).all()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("k", [1, 64])
def test_cuda_bound_quant_gather_matches_public(cuda_device, metric, k):
    """The launcher bound once per batched search gives the public
    wrapper's bits, counts one launch a call, returns a fresh tensor each
    call and refuses ids of another batch."""
    rng = np.random.default_rng(14)
    vec = _data("gauss", N_CAP, 128, 1, metric)
    q = _data("gauss", 9, 128, 2, metric)
    ids_d, q_d, *tab = _to(cuda_device, _q_ids(rng, 18, k), q,
                           *quant_tables(vec))
    bound = tqg.BoundQuantGather(q_d, *tab, metric=metric)
    before = tqg.LAUNCHES["gather_distance_batched_q"]
    a = bound(ids_d[:9].contiguous())
    a_copy = a.clone()
    b = bound(ids_d[9:].contiguous())
    torch.cuda.synchronize()
    assert tqg.LAUNCHES["gather_distance_batched_q"] == before + 2
    assert a.data_ptr() != b.data_ptr()
    _close(a_copy, a, True, "first result after the second call")
    for got, rows in ((a, ids_d[:9]), (b, ids_d[9:])):
        pub = tqg.gather_distance_batched_q_cuda(rows, q_d, *tab,
                                                 metric=metric)
        _close(pub, got, True, "bound vs public")
    with pytest.raises(ValueError, match="id rows"):
        bound(ids_d)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["qgrid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_quant_gather_matches_beam_hop_q(cuda_device, kind, metric):
    """The distances one fused int8 hop (kernel 6) writes into the beam are
    the int8 gather kernel's (kernel 5) for the same (query, row) pairs,
    bit for bit: both sum a row with ``warp_dot_i8``."""
    q, carry, static = _beam_inputs(kind, metric, b=6, l=32, r=16, dim=40)
    adj, vec, _, nav, ret = static
    qd = _to(cuda_device, q)[0]
    sd = _to(cuda_device, adj, *quant_tables(vec), nav, ret)
    c = _to(cuda_device, *carry)
    out = tbh.beam_hop_fused_q_cuda(qd, *(x.clone() for x in c), *sd,
                                    metric=metric, h=1)
    ids, dists = out[0], out[1]
    # the start's distance came with the carry, not from kernel 6
    keep = (ids >= 0) & (ids != c[0][:, :1])
    assert int(keep.sum()) > 0
    bound = tqg.BoundQuantGather(qd, *sd[1:4], metric=metric)
    got = bound(torch.where(keep, ids, torch.full_like(ids, -1)))
    _close(dists[keep], got[keep], True, "fused int8 hop vs int8 gather")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["qgrid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("h", [1, 3, 4])
def test_cuda_beam_hop_q(cuda_device, kind, metric, h):
    q, carry, static = _beam_inputs(kind, metric, b=9, l=32, r=16, dim=40)
    adj, vec, _, nav, ret = static
    qd = _to(cuda_device, q)[0]
    sd = _to(cuda_device, adj, *quant_tables(vec), nav, ret)
    c = _to(cuda_device, *carry)
    for step in range(10):
        p = tbh.beam_hop_fused_q_plain(qd, *c, *sd, metric=metric, h=h)
        k = tbh.beam_hop_fused_q_cuda(qd, *(x.clone() for x in c), *sd,
                                      metric=metric, h=h)
        for i, (a, b) in enumerate(zip(p, k)):
            _close(a, b, kind == "qgrid", f"step {step} field {i}")
        c = p


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["grid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("n_rows,k", [(10_000, 10), (9_000, 64), (30, 10)])
def test_cuda_topk_score(cuda_device, kind, metric, n_rows, k):
    rng = np.random.default_rng(n_rows)
    vec = _data(kind, n_rows, 40, 6, metric)
    q = _data(kind, 37, 40, 7, metric)
    norms = (vec * vec).sum(1).astype(np.float32)
    bias = np.where(rng.random(n_rows) < 0.8, 0.0, np.inf).astype(np.float32)
    args = _to(cuda_device, q, vec, norms, bias)
    kv, ki = ttk.topk_score_cuda(*args, k=k, metric=metric)
    pv, pi = ttk.topk_score_plain(*args, k=k, metric=metric)
    _close(pv, kv, kind == "grid", "dists")
    _close(pi, ki, True, "ids")


# Shapes around the redesigned top-k kernel's tiles: 128-query tiles,
# 128-row tiles, 4,096-row chunks, 16-deep slices, 16-byte row copies.
# (B, N, D, k, case)
TOPK_CASES = {
    "one_query": (1, 9_000, 40, 10, None),
    "ragged_query_tiles": (300, 5_000, 40, 10, None),
    "d_not_multiple_of_4": (37, 5_000, 37, 10, None),
    "misaligned_table": (37, 5_000, 40, 10, "misaligned"),
    "n_below_one_row_tile": (37, 50, 40, 10, None),
    "n_not_multiple_of_chunk": (130, 2 * 4096 + 77, 24, 10, None),
    "ties_across_chunk_boundary": (37, 2 * 4096 + 77, 24, 10, "ties"),
    "all_rows_biased_out": (37, 5_000, 40, 10, "dead"),
    "k_1": (37, 9_000, 40, 1, None),
    "k_64": (37, 9_000, 40, 64, None),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["grid", "gauss"])
@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_cuda_topk_score_shapes(cuda_device, kind, case):
    """The kernel against its plain version at the edges of its tiling:
    dists bitwise on grid data, ids exactly."""
    b, n_rows, dim, k, extra = TOPK_CASES[case]
    rng = np.random.default_rng(len(case))
    vec = _data(kind, n_rows, dim, 6)
    q = _data(kind, b, dim, 7)
    bias = np.where(rng.random(n_rows) < 0.8, 0.0, np.inf).astype(np.float32)
    if extra == "ties":
        # one row copied to both sides of the first chunk boundary and
        # into the second chunk, and a query on it: exact ties that must
        # go to the lower row, whichever block reports first
        for r in (4095, 4096, 8191, 8192):
            vec[r] = vec[100]
        q[:5] = vec[100]
        bias[[100, 4095, 4096, 8191, 8192]] = 0.0
    if extra == "dead":
        bias[:] = np.inf
    norms = (vec * vec).sum(1).astype(np.float32)
    args = list(_to(cuda_device, q, vec, norms, bias))
    if extra == "misaligned":
        # 16-byte-divisible D on a table 4 bytes off alignment: 4-byte copies
        buf = torch.empty(vec.size + 1, device=cuda_device)
        buf[1:] = args[1].reshape(-1)
        args[1] = buf[1:].view(n_rows, dim)
        assert args[1].data_ptr() % 16 != 0
    kv, ki = ttk.topk_score_cuda(*args, k=k)
    pv, pi = ttk.topk_score_plain(*args, k=k)
    _close(pv, kv, kind == "grid", "dists")
    _close(pi, ki, True, "ids")
    if extra == "ties":
        assert n(ki)[:5, :5].tolist() == [[100, 4095, 4096, 8191, 8192]] * 5
    if extra == "dead":
        assert (n(ki) == -1).all() and np.isinf(n(kv)).all()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["grid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("with_norms", [True, False])
def test_cuda_gather_one_matches_batched(cuda_device, kind, metric,
                                         with_norms):
    """The single-query kernel (public wrapper and bound launcher) gives the
    bits of the batched kernel's B = 1 row, and of the plain version on
    grid data."""
    rng = np.random.default_rng(12)
    vec = _data(kind, N_CAP, 130, 1, metric)
    q = _data(kind, 3, 130, 2, metric)
    ids = _ids(rng, 3, 64, N_CAP)
    norms = (vec * vec).sum(1).astype(np.float32) if with_norms else None
    ids_d, q_d, vec_d, norms_d = _to(cuda_device, ids, q, vec, norms)
    for b in range(3):
        one = tgd.gather_distance_cuda(ids_d[b], q_d[b], vec_d, norms_d,
                                       metric=metric)
        bound = tgd.BoundGather(q_d[b], vec_d, norms_d, metric=metric)
        row = tgd.gather_distance_batched_cuda(ids_d[b:b + 1], q_d[b:b + 1],
                                               vec_d, norms_d,
                                               metric=metric)[0]
        _close(row, one, True, "single vs batched row")
        _close(row, bound(ids_d[b]), True, "bound vs batched row")
        _close(tgd.gather_distance_plain(ids_d[b], q_d[b], vec_d, norms_d,
                                         metric=metric),
               one, kind == "grid", "single vs plain")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["grid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_gather_one_matches_beam_hop(cuda_device, kind, metric):
    """The distances one fused hop writes into the beam are the single-query
    kernel's for the same (query, row) pairs, bit for bit."""
    q, carry, static = _beam_inputs(kind, metric, b=2, l=32, r=16, dim=40)
    qd = _to(cuda_device, q)[0]
    sd = _to(cuda_device, *static)
    c = _to(cuda_device, *carry)
    start = int(carry[0][0, 0])
    out = tbh.beam_hop_fused_cuda(qd, *(x.clone() for x in c), *sd,
                                  metric=metric, h=1)
    ids, dists = out[0][0], out[1][0]
    keep = (ids >= 0) & (ids != start)
    assert int(keep.sum()) > 0
    bound = tgd.BoundGather(qd[0], sd[1], sd[2], metric=metric)
    got = bound(ids[keep].contiguous())
    _close(dists[keep], got, True, "beam hop vs single-query kernel")


@pytest.mark.requires_cuda
def test_cuda_bound_gather_returns_fresh_tensors(cuda_device):
    """Each call of the bound launcher returns its own output: the first
    result is unchanged by the second call."""
    rng = np.random.default_rng(13)
    vec = _data("grid", N_CAP, 64, 1)
    q = _data("grid", 1, 64, 2)[0]
    ids = _ids(rng, 2, 64, N_CAP)
    ids_d, q_d, vec_d = _to(cuda_device, ids, q, vec)
    norms_d = (vec_d * vec_d).sum(1)
    bound = tgd.BoundGather(q_d, vec_d, norms_d)
    before = dict(tgd.LAUNCHES)
    a = bound(ids_d[0])
    a_copy = a.clone()
    b = bound(ids_d[1])
    torch.cuda.synchronize()
    assert a.data_ptr() != b.data_ptr()
    _close(a_copy, a, True, "first result after the second call")
    _close(tgd.gather_distance_plain(ids_d[1], q_d, vec_d, norms_d), b, True,
           "second result")
    assert tgd.LAUNCHES["gather_distance"] == \
        before["gather_distance"] + 2


@pytest.mark.requires_cuda
def test_cuda_topk_refuses_large_k(cuda_device):
    x = torch.zeros((4, 8), device=cuda_device)
    with pytest.raises(ValueError):
        ttk.topk_score_cuda(x, x, x[:, 0], k=65)


@pytest.mark.requires_cuda
def test_cuda_bitset_pack_matches_plain(cuda_device):
    bits = torch.rand((3, 1000), device=cuda_device) < 0.5
    np.testing.assert_array_equal(n(tbitset.pack_bits(bits)),
                                  n(tbitset.pack_bits(bits.cpu())))


# Shapes around the redesigned fused hop: (B, l, r, dim, extra).  D = 40
# takes TMA bulk copies for f32 rows (160 bytes) and 4-byte cp.async for
# int8 rows (40 bytes); D = 2,048 f32 rows (8 KB) stage four to a round, so
# a hop takes several rounds; r = 128 with l = 256 fills the kernel's limits;
# "dup" gives the start vertex an adjacency row of one id repeated, "nofresh"
# marks every neighbour of the start as seen in lane 2 (a hop with no fresh
# neighbour there).
HOP_CASES = {
    "d40": (9, 32, 16, 40, None),
    "d128": (9, 32, 16, 128, None),
    "d2048_rounds": (5, 32, 16, 2048, None),
    "r128_l256": (5, 256, 128, 40, None),
    "duplicated_row": (9, 32, 16, 40, "dup"),
    "no_fresh_lane": (9, 32, 16, 40, "nofresh"),
    "b1": (1, 32, 16, 40, None),
    "b600": (600, 32, 16, 40, None),
}


def _hop_case(case, kind, metric, quantized):
    """(queries, carry, static) of one ``HOP_CASES`` entry, as numpy; the
    static tables are the int8 tier's when ``quantized``."""
    b, l, r, dim, extra = HOP_CASES[case]
    if quantized and kind == "grid":
        kind = "qgrid"
    # b = 1 takes lane 0 of two: _beam_inputs masks lane b // 2
    q, carry, static = _beam_inputs(kind, metric, b=max(b, 2), l=l, r=r,
                                    dim=dim)
    q, carry = q[:b], tuple(x[:b] for x in carry)
    adj, vec, norms, nav, ret = static
    start = int(carry[0][0, 0])
    if extra == "dup":
        navbits = np.unpackbits(nav.view(np.uint8), bitorder="little")
        x = int(np.nonzero(navbits[:N_CAP])[0][1])
        adj[start, :] = x if x != start else int(
            np.nonzero(navbits[:N_CAP])[0][2])
    if extra == "nofresh":
        for nb in adj[start]:
            if nb >= 0:
                carry[3][2, nb >> 5] |= np.uint32(1 << (int(nb) & 31))
    if quantized:
        static = (adj, *quant_tables(vec), nav, ret)
    return q, carry, static


def _lane_active(c, mv):
    bi, bd, be = c[:3]
    return bool((((bi >= 0) & (be == 0) & torch.isfinite(bd)).any(1)
                 & (c[8] < mv)).any())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["grid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("case", sorted(HOP_CASES))
def test_cuda_beam_hop_shapes(cuda_device, kind, metric, quantized, case):
    """Both fused hop kernels against their plain versions at the edges of
    the redesign (copy paths, staging rounds, the kernel's limits,
    duplicated neighbours, a hop with nothing fresh, B = 1 and B = 600):
    bitwise on grid data, ids and counters exactly on Gaussian data; the
    status word never reports an unsorted beam and reports an active lane
    exactly when ``lane_active`` finds one in what the kernel left."""
    from repro_torch.kernels.beam_hop import STATUS_ACTIVE, STATUS_UNSORTED

    q, carry, static = _hop_case(case, kind, metric, quantized)
    plain = tbh.beam_hop_fused_q_plain if quantized \
        else tbh.beam_hop_fused_plain
    kern = tbh.beam_hop_fused_q_cuda if quantized \
        else tbh.beam_hop_fused_cuda
    qd = _to(cuda_device, q)[0]
    sd = _to(cuda_device, *static)
    c = _to(cuda_device, *carry)
    mv = carry[4].shape[1]
    for step in range(10):
        p = plain(qd, *c, *sd, metric=metric, h=4)
        status = torch.zeros(1, dtype=torch.int32, device=cuda_device)
        k = kern(qd, *(x.clone() for x in c), *sd, metric=metric, h=4,
                 status=status)
        for i, (a, b) in enumerate(zip(p, k)):
            _close(a, b, kind == "grid", f"step {step} field {i}")
        word = int(status[0])
        assert not word & STATUS_UNSORTED
        assert bool(word & STATUS_ACTIVE) == _lane_active(k, mv)
        c = p
    assert int(c[8].sum()) > 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("quantized", [False, True])
def test_cuda_bound_beam_hop_matches_public(cuda_device, metric, quantized):
    """``BoundBeamHop`` leaves the public launcher's carry, bit for bit,
    over 10 super-steps; its ``active()`` is ``lane_active`` on that carry;
    each call counts one launch; a carry it was not bound to is refused."""
    q, carry, static = _hop_case("d40", "gauss", metric, quantized)
    qd = _to(cuda_device, q)[0]
    sd = _to(cuda_device, *static)
    cp = _to(cuda_device, *carry)
    cb = tuple(x.clone() for x in cp)
    if quantized:
        adj, codes, scales, qnorms, nav, ret = sd
        bound = tbh.BoundBeamHop(qd, cb, adj, codes, qnorms, nav, ret,
                                 metric=metric, h=4, scales=scales)
        public, key = tbh.beam_hop_fused_q_cuda, "beam_hop_fused_q"
    else:
        bound = tbh.BoundBeamHop(qd, cb, *sd, metric=metric, h=4)
        public, key = tbh.beam_hop_fused_cuda, "beam_hop_fused"
    mv = carry[4].shape[1]
    for step in range(10):
        status = torch.zeros(1, dtype=torch.int32, device=cuda_device)
        public(qd, *cp, *sd, metric=metric, h=4, status=status)
        before = tbh.LAUNCHES[key]
        assert bound(cb) is cb
        assert tbh.LAUNCHES[key] == before + 1
        for i, (a, b) in enumerate(zip(cp, cb)):
            _close(a, b, True, f"step {step} field {i}")
        assert bound.active() == _lane_active(cb, mv)
    with pytest.raises(ValueError, match="not the carry"):
        bound(cp)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_cuda_bound_search_superstep_count(cuda_device, quantized,
                                           monkeypatch):
    """``batched_greedy_search`` on the cuda engine launches the fused
    kernel once per super-step of the torch engine's loop on the same state
    (no extra launch), and returns its result bit for bit on grid data."""
    import dataclasses

    from torch_parity import assert_search_equal, small_kw

    from repro_torch import convert
    from repro_torch.core import api as tapi
    from repro_torch.core import backend as tbackend
    from repro_torch.core.search_batched import batched_greedy_search
    from repro_torch.core.types import ANNConfig, init_index_state

    cfg = dataclasses.replace(
        ANNConfig(**small_kw("l2", dim=16, n_cap=200), backend="cuda",
                  quantized=quantized), hop_fused=4)
    kind = "qgrid" if quantized else "grid"
    data = _data(kind, 140, 16, 3)
    st = init_index_state(cfg, 140, device=cuda_device)
    st, _ = tapi.apply(st, cfg, tapi.insert_batch(np.arange(20), data[:20],
                                                  device=cuda_device),
                       sequential=True)
    st, _ = tapi.apply(st, cfg, tapi.insert_batch(np.arange(20, 140),
                                                  data[20:],
                                                  device=cuda_device))
    qs = _data(kind, 9, 16, 4)
    key = "beam_hop_fused_q" if quantized else "beam_hop_fused"
    before = tbh.LAUNCHES[key]
    res_c = batched_greedy_search(st.graph, cfg, t(qs).to(cuda_device), k=5,
                                  l=24)
    launches = tbh.LAUNCHES[key] - before

    steps = []
    name = "beam_superstep_q" if quantized else "beam_superstep"
    inner = getattr(tbackend.DistanceBackend, name)

    def counted(self, *a, **kw):
        steps.append(1)
        return inner(self, *a, **kw)

    monkeypatch.setattr(tbackend.TorchBackend, name, counted)
    host = convert.index_state_from_numpy(
        convert.index_state_to_numpy(st), "cpu")
    res_t = batched_greedy_search(host.graph,
                                  dataclasses.replace(cfg, backend="torch"),
                                  t(qs), k=5, l=24)
    assert launches == len(steps) > 1
    assert_search_equal(res_t, res_c)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_cuda_unsorted_beam_is_refused(cuda_device, quantized):
    """A beam that is not sorted by distance sets ``STATUS_UNSORTED`` and
    leaves its lane untouched (the other lanes hop as the plain version
    does); without a status word the public launcher raises, and so does
    ``BoundBeamHop.active()``."""
    from repro_torch.kernels.beam_hop import STATUS_UNSORTED

    q, carry, static = _hop_case("d40", "grid", "l2", quantized)
    plain = tbh.beam_hop_fused_q_plain if quantized \
        else tbh.beam_hop_fused_plain
    kern = tbh.beam_hop_fused_q_cuda if quantized \
        else tbh.beam_hop_fused_cuda
    qd = _to(cuda_device, q)[0]
    sd = _to(cuda_device, *static)
    c = plain(qd, *_to(cuda_device, *carry), *sd, h=2)
    c[1][3, 1] = c[1][3, 0] - 1.0   # lane 3: beam_dists out of order
    status = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    k = kern(qd, *(x.clone() for x in c), *sd, status=status)
    p = plain(qd, *c, *sd)
    assert int(status[0]) & STATUS_UNSORTED
    others = torch.arange(c[0].shape[0], device=cuda_device) != 3
    for i, (a, b, before) in enumerate(zip(k, p, c)):
        _close(before[3], a[3], True, f"lane 3 field {i}")
        _close(b[others], a[others], True, f"other lanes field {i}")
    with pytest.raises(RuntimeError, match="not sorted"):
        kern(qd, *(x.clone() for x in c), *sd)
    cb = tuple(x.clone() for x in c)
    if quantized:
        adj, codes, scales, qnorms, nav, ret = sd
        bound = tbh.BoundBeamHop(qd, cb, adj, codes, qnorms, nav, ret,
                                 scales=scales)
    else:
        bound = tbh.BoundBeamHop(qd, cb, *sd)
    bound(cb)
    with pytest.raises(RuntimeError, match="not sorted"):
        bound.active()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("alpha", [1.0, 1.2])
@pytest.mark.parametrize("m,c", [(1, 192), (64, 65), (7, 512), (3, 5)])
def test_cuda_robust_prune(cuda_device, metric, alpha, m, c):
    """Kernel 7 against its plain version on the same card tensors and on a
    CPU copy: the same rows, bit for bit (ties, dead rows and rows with
    fewer live candidates than r included), in one launch."""
    ids, d_p, pair = _prune_inputs(metric, m, c, cuda_device, c)
    n0 = trp.LAUNCHES["robust_prune"]
    got = trp.robust_prune_select(ids, d_p, pair, alpha, 64)
    torch.cuda.synchronize()
    assert trp.LAUNCHES["robust_prune"] == n0 + 1
    want = trp.robust_prune_select_plain(ids, d_p, pair, alpha, 64)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), trp.robust_prune_select(
        ids.cpu(), d_p.cpu(), pair.cpu(), alpha, 64))
    assert (want >= 0).any()


def _prune_graph(metric, dev):
    """A grid-data graph (160 points, 20 of them equal to others, r = 12)
    built by the port on the CPU, and the same state on ``dev``."""
    from repro_torch.core import types as ttypes
    from repro_torch.core.batched import insert_many_batched
    from repro_torch.core.insert import insert_many
    from torch_parity import small_kw

    cfg = ttypes.ANNConfig(**small_kw(metric, n_cap=250))
    xs = grid_data(160, 24, 3)
    xs[140:] = xs[:20]
    st = ttypes.init_state(cfg, "cpu")
    st, _ = insert_many(st, cfg, t(xs[:24]))
    st, _ = insert_many_batched(st, cfg, t(xs[24:]))
    return cfg, st, type(st)(*(None if x is None else x.to(dev)
                               for x in st))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_append_rows_matches_cpu(cuda_device, metric):
    """One ``append_rows`` step on the card (its overflow prunes through
    kernel 7) leaves the adjacency the same step leaves on the CPU."""
    from repro_torch.core import edges as tedges

    cfg, st, card = _prune_graph(metric, cuda_device)
    vs = torch.nonzero(st.active).squeeze(1).to(torch.int32)
    us = t(np.random.default_rng(5).permutation(vs.numpy())).to(torch.int32)
    full = int(((st.adj[vs.long()] >= 0).sum(1) == cfg.r).sum())
    assert full > 0
    n0 = trp.LAUNCHES["robust_prune"]
    tedges.append_rows(st, cfg, vs, us)
    tedges.append_rows(card, cfg, vs.to(cuda_device), us.to(cuda_device))
    torch.cuda.synchronize()
    assert trp.LAUNCHES["robust_prune"] == n0 + 1
    assert torch.equal(card.adj.cpu(), st.adj)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("c,with_dists", [(192, True), (13, False)])
def test_cuda_prune_rows_one_launch_no_sync(cuda_device, c, with_dists):
    """``robust_prune_rows`` on card tensors (an insert's candidate list,
    and an overflow prune's rows) waits on the device nowhere: it runs
    under the sync debug mode's "error" setting, launches kernel 7 once,
    and returns the CPU's rows."""
    from repro_torch.core import prune as tprune

    cfg, st, card = _prune_graph("l2", cuda_device)
    rng = np.random.default_rng(c)
    m = 1 if c == 192 else 5
    cand = t(rng.integers(-1, 160, size=(m, c)).astype(np.int32))
    p_ids = cand[:, 0].contiguous()
    dists = None
    if with_dists:
        d = rng.integers(0, 400, size=(m, c)).astype(np.float32) / 16
        d[rng.random((m, c)) < 0.3] = np.inf
        dists = t(d)
    args = (st.vectors[p_ids.clamp(min=0).long()], cand, dists)
    want = tprune.robust_prune_rows(st, cfg, *args, p_ids=p_ids)
    args_d = tuple(None if x is None else x.to(cuda_device) for x in args)
    p_ids_d = p_ids.to(cuda_device)
    tprune.robust_prune_rows(card, cfg, *args_d, p_ids=p_ids_d)   # builds
    torch.cuda.synchronize()
    n0 = trp.LAUNCHES["robust_prune"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tprune.robust_prune_rows(card, cfg, *args_d, p_ids=p_ids_d)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert trp.LAUNCHES["robust_prune"] == n0 + 1
    assert torch.equal(got.cpu(), want)
    assert (want >= 0).any()
