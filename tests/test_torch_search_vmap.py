"""``search_batch_vmap`` (Alg 1's lockstep per-query engine) and the front
doors' keywords against the JAX reference.

The same index, built by the reference and carried across with
``repro_torch.convert``, is searched by the reference's
``repro.core.search_batch_vmap`` (``jax.vmap`` of ``greedy_search``) and the
port's: every field bitwise on grid data, the ids, visited lists and
counters exactly and the distances to rtol 2e-5 on Gaussian data; the edge
cases (tombstoned pops, ``k > l``, B = 1, an empty index, planted ties, a
``distance_fn``) likewise.  ``search_batch(distance_fn=, bucket=)``,
``grow``'s ``high_water`` and ``HNSWIndex``'s counter properties against the
reference.  The card cases (``python -m pytest --noconftest -m
requires_cuda tests/test_torch_search_vmap.py``) import JAX nowhere.
"""
import functools
import gc
import sys

import numpy as np
import pytest
import torch

from torch_parity import (assert_field, assert_index_equal,  # noqa: F401
                          assert_port_equal, cuda_device, grid_data, n, t)

from repro_torch import convert
from repro_torch.core import search_batch_vmap as t_vmap
from repro_torch.core.types import ANNConfig as TCfg

DIM, N_CAP = 20, 250
EXACT_FIELDS = ("topk_ids", "visited_ids", "n_visited", "n_comps", "n_hops")
DIST_FIELDS = ("topk_dists", "visited_dists")
KW = dict(dim=DIM, n_cap=N_CAP, r=8, l_build=16, l_search=16, l_delete=16,
          k_delete=8, n_copies=2, alpha=1.2)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """Every XLA executable the reference compiles here holds memory maps
    of its process, and this module compiles enough of them (~9,000 maps)
    to bring a test process that also runs the rest of the suite near its
    limit (``vm.max_map_count``, 65,530), where XLA's compiler aborts: the
    module releases them when it ends."""
    yield
    if "jax" in sys.modules:
        sys.modules["jax"].clear_caches()
        gc.collect()


def _cfgs(metric, jb="jnp", tb="torch"):
    from torch_parity import cfg_pair

    return cfg_pair(metric=metric, jax_backend=jb, torch_backend=tb, **KW)


def _data(kind, metric, n_pts, n_q, seed=3):
    if kind == "grid":
        return grid_data(n_pts, DIM, seed), grid_data(n_q, DIM, seed + 1)
    from repro.core.runbook import make_dataset

    return make_dataset(n_pts, DIM, metric, n_queries=n_q, seed=seed)


@functools.lru_cache(maxsize=None)
def _built(metric, kind, dup=1):
    """A reference-built index (serial bootstrap, batched inserts, in-place
    deletes of every ninth point) as numpy, and 7 queries.  ``dup`` > 1
    inserts each point ``dup`` times, which plants exact distance ties."""
    from repro.core import api as japi
    from repro.core.types import init_index_state as j_init
    from torch_parity import jax_index_numpy

    jcfg, _ = _cfgs(metric)
    data, q = _data(kind, metric, 160 // dup, 7)
    data = np.repeat(data, dup, axis=0)
    st = j_init(jcfg, 400)
    st, _ = japi.apply(st, jcfg, japi.insert_batch(np.arange(32), data[:32]),
                       sequential=True)
    st, _ = japi.apply(st, jcfg, japi.insert_batch(np.arange(32, 160),
                                                   data[32:160]))
    st, _ = japi.apply(st, jcfg, japi.delete_batch(np.arange(0, 160, 9),
                                                   DIM))
    return jax_index_numpy(st), q


def _graphs(d):
    """The numpy layout as a reference and a port ``GraphState``."""
    import jax.numpy as jnp

    from repro.core.types import GraphState

    jg = GraphState(**{k: (None if v is None else jnp.asarray(v))
                       for k, v in d["graph"].items()})
    return jg, convert.index_state_from_numpy(d, device="cpu").graph


def _assert_vmap_equal(jres, tres, exact, where=""):
    for f in EXACT_FIELDS:
        assert_field(getattr(jres, f), getattr(tres, f), f"{where} {f}")
    for f in DIST_FIELDS:
        assert_field(getattr(jres, f), getattr(tres, f), f"{where} {f}",
                     exact)


def _both(jg, tg, metric, q, k=5, l=16, engines=("jnp", "torch"),
          fns=(None, None)):
    import jax.numpy as jnp

    from repro.core import search_batch_vmap as j_vmap

    jcfg, tcfg = _cfgs(metric, *engines)
    jres = j_vmap(jg, jcfg, jnp.asarray(q), k=k, l=l, distance_fn=fns[0])
    tres = t_vmap(tg, tcfg, t(q), k=k, l=l, distance_fn=fns[1])
    return jres, tres


@pytest.mark.parametrize("kind", ["grid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("engines", [("jnp", "torch"), ("ref", "ref")])
def test_vmap_matches_reference(kind, metric, engines):
    d, q = _built(metric, kind)
    jg, tg = _graphs(d)
    jres, tres = _both(jg, tg, metric, q, engines=engines)
    _assert_vmap_equal(jres, tres, kind == "grid")
    assert tres.topk_ids.shape == (7, 5) and tres.n_hops.dtype == torch.int32
    assert (n(tres.n_hops) > 0).all()


@pytest.mark.parametrize("kind", ["grid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_vmap_lanes_are_greedy_search(kind, metric):
    """Lane ``b`` is the port's own ``greedy_search`` of ``queries[b]``:
    the lockstep select changes no lane.  Every field bitwise on grid data;
    on Gaussian data the distances to tolerance (a (B, R) tile reduces in
    another order than one query's (R,) row)."""
    from repro_torch.core import greedy_search

    d, q = _built(metric, kind)
    _, tg = _graphs(d)
    _, tcfg = _cfgs(metric)
    res = t_vmap(tg, tcfg, t(q), k=5, l=16)
    for b in range(q.shape[0]):
        one = greedy_search(tg, tcfg, t(q[b]), k=5, l=16)
        for f, x, y in zip(one._fields, one, res):
            assert_field(x, y[b], f"lane {b} {f}",
                         kind == "grid" or f not in DIST_FIELDS)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_vmap_tombstoned_pops_write_no_visited_slot(metric):
    """After in-place deletes, a fifth of the live slots and the entry
    point tombstoned: navigated, popped, never written to the visited list
    nor returned."""
    d, q = _built(metric, "grid")
    d = {**d, "graph": dict(d["graph"])}
    active = d["graph"]["active"].copy()
    tomb = d["graph"]["tombstone"].copy()
    picked = np.flatnonzero(active)[::5]
    picked = np.union1d(picked, [int(d["graph"]["start"])])
    active[picked], tomb[picked] = False, True
    d["graph"]["active"], d["graph"]["tombstone"] = active, tomb
    jg, tg = _graphs(d)
    jres, tres = _both(jg, tg, metric, q)
    _assert_vmap_equal(jres, tres, True)
    assert (n(tres.n_hops) > n(tres.n_visited)).all()   # tombstoned pops
    assert not np.isin(n(tres.visited_ids), picked).any()
    assert not np.isin(n(tres.topk_ids), picked).any()


@pytest.mark.parametrize("kind", ["grid", "gauss"])
def test_vmap_pads_when_k_exceeds_l(kind):
    d, q = _built("l2", kind)
    jg, tg = _graphs(d)
    jres, tres = _both(jg, tg, "l2", q, k=12, l=8)
    _assert_vmap_equal(jres, tres, kind == "grid")
    assert (n(tres.topk_ids)[:, 8:] == -1).all()
    assert np.isinf(n(tres.topk_dists)[:, 8:]).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_vmap_single_lane(metric):
    d, q = _built(metric, "gauss")
    jg, tg = _graphs(d)
    jres, tres = _both(jg, tg, metric, q[3:4])
    _assert_vmap_equal(jres, tres, False)
    assert tres.topk_ids.shape == (1, 5)


def test_vmap_empty_index():
    from repro.core.types import init_index_state as j_init
    from torch_parity import jax_index_numpy

    jcfg, _ = _cfgs("l2")
    d = jax_index_numpy(j_init(jcfg, 400))
    jg, tg = _graphs(d)
    q = grid_data(4, DIM, 5)
    jres, tres = _both(jg, tg, "l2", q)
    _assert_vmap_equal(jres, tres, True)
    assert (n(tres.n_hops) == 0).all() and (n(tres.n_comps) == 0).all()
    assert (n(tres.topk_ids) == -1).all() and (n(tres.n_visited) == 0).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_vmap_planted_ties_pick_the_first_minimum(metric):
    """Every point inserted four times: the frontier holds exact ties,
    which ``argmin`` must break to the first index as ``jnp.argmin``
    does; the duplicated queries tie lane against lane as well."""
    d, q = _built(metric, "grid", dup=4)
    q = np.concatenate([q, q[:2]])
    jg, tg = _graphs(d)
    jres, tres = _both(jg, tg, metric, q)
    _assert_vmap_equal(jres, tres, True)
    # tied pops: equal distances expanded one after the other
    vd = n(tres.visited_dists)
    tied = (vd[:, 1:] == vd[:, :-1]) & np.isfinite(vd[:, 1:])
    assert tied.any(axis=1).mean() >= 0.5, tied.any(axis=1)
    for f in EXACT_FIELDS + DIST_FIELDS:
        assert_field(getattr(tres, f)[7:], getattr(tres, f)[:2], f)


def test_vmap_with_kernel_distance_fn():
    """Each package's ``kernels.ops.make_kernel_distance_fn()``, lifted
    lane by lane, gives the engine's own answer."""
    from repro.kernels.ops import make_kernel_distance_fn as j_fn
    from repro_torch.kernels.ops import make_kernel_distance_fn as t_fn

    d, q = _built("l2", "grid")
    jg, tg = _graphs(d)
    jres, tres = _both(jg, tg, "l2", q[:4], fns=(j_fn(), t_fn()))
    _assert_vmap_equal(jres, tres, True)
    _, tcfg = _cfgs("l2")
    assert_port_equal(tres, t_vmap(tg, tcfg, t(q[:4]), k=5, l=16))


@pytest.mark.parametrize("kind", ["grid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_search_batch_matches_vmap_baseline(kind, metric):
    """The port's twin of ``tests/test_search_batched.py``'s baseline
    check: the native engine returns what the vmap engine does."""
    from repro_torch.core import search_batch

    d, q = _built(metric, kind)
    _, tg = _graphs(d)
    _, tcfg = _cfgs(metric)
    new = search_batch(tg, tcfg, t(q), k=5, l=16)
    old = t_vmap(tg, tcfg, t(q), k=5, l=16)
    for f in EXACT_FIELDS:
        assert torch.equal(getattr(new, f), getattr(old, f)), f
    for f in DIST_FIELDS:
        assert_field(getattr(new, f), getattr(old, f), f, kind == "grid")


def test_vmap_cuda_engine_refuses_cpu_tensors():
    """No fallback: the ``cuda`` engine on a CPU state raises."""
    d, q = _built("l2", "grid")
    _, tg = _graphs(d)
    with pytest.raises(Exception, match="CUDA|cuda"):
        t_vmap(tg, TCfg(backend="cuda", **KW), t(q), k=5, l=16)


# ---------------------------------------------------------------------------
# the front doors' keywords
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("use_fn", [True, False])
def test_search_batch_distance_fn_and_bucket(bucket, use_fn):
    """``search_batch(distance_fn=, bucket=)`` on a ragged batch of 5
    against the reference's, every field bitwise on grid data."""
    import jax.numpy as jnp

    from repro.core import search_batch as j_search_batch
    from repro.kernels.ops import make_kernel_distance_fn as j_fn
    from repro_torch.core import search_batch
    from repro_torch.kernels.ops import make_kernel_distance_fn as t_fn

    d, q = _built("l2", "grid")
    jg, tg = _graphs(d)
    jcfg, tcfg = _cfgs("l2")
    jres = j_search_batch(jg, jcfg, jnp.asarray(q[:5]), k=5, l=16,
                          distance_fn=j_fn() if use_fn else None,
                          bucket=bucket)
    tres = search_batch(tg, tcfg, t(q[:5]), k=5, l=16,
                        distance_fn=t_fn() if use_fn else None,
                        bucket=bucket)
    _assert_vmap_equal(jres, tres, True)
    assert tres.topk_ids.shape == (5, 5)


@pytest.mark.parametrize("high_water", [0.5, 0.9])
def test_grow_high_water_matches_reference(high_water):
    """``next_capacity`` / ``needs_growth`` / ``ensure_capacity`` at a
    given ``high_water``: the reference's capacities, decisions and grown
    state."""
    from repro.core import grow as jgrow
    from repro.core.types import init_index_state as j_init
    from repro_torch.core import grow as tgrow
    from torch_parity import jax_index_numpy, jax_index_state

    for n_cap in (1, 7, 64, 100, 250, 1000):
        for needed in (0, 1, 40, 63, 64, 90, 129, 700, 4000):
            assert tgrow.next_capacity(needed, n_cap, high_water) == \
                jgrow.next_capacity(needed, n_cap, high_water), \
                (needed, n_cap)
    d = jax_index_numpy(j_init(_cfgs("l2")[0], 400))
    d["graph"]["free_top"] = np.asarray(100, np.int32)   # 150 slots used
    jcfg, tcfg = _cfgs("l2")
    jst, tst = jax_index_state(d), convert.index_state_from_numpy(d, "cpu")
    for incoming in (0, 1, 25, 26, 75, 76, 200):
        jgrew = jgrow.needs_growth(jst, jcfg, incoming, high_water)
        assert tgrow.needs_growth(tst, tcfg, incoming, high_water) == jgrew
        js, jc, jg = jgrow.ensure_capacity(jst, jcfg, incoming, high_water)
        ts, tc, tg = tgrow.ensure_capacity(tst, tcfg, incoming, high_water)
        assert (tg, tc.n_cap) == (jg, jc.n_cap) and tg == jgrew, incoming
        assert_index_equal(js, ts, True, f"incoming {incoming}")
    # 150 of 250 slots used: past a mark of 0.5, under one of 0.9
    assert tgrow.needs_growth(tst, tcfg, 0, high_water) == (high_water < 0.6)


def test_hnsw_counter_properties_match_reference():
    """``HNSWIndex``'s five read-only properties after a short runbook: the
    counts equal the reference's, the seconds are >= 0, and each reads
    ``counters``."""
    from repro.core.driver import run_runbook as j_run
    from repro.core.hnsw import HNSWConfig as JHCfg
    from repro.core.hnsw import HNSWIndex as JHNSW
    from repro.core.runbook import make_runbook as j_runbook
    from repro_torch.core import HNSWConfig, HNSWIndex, make_runbook
    from repro_torch.core import run_runbook

    kw = dict(dim=16, n_cap=200, m=8, ef_construction=32, ef_search=32,
              max_level=2)
    rb_kw = dict(n=120, dim=16, t_max=6, seed=0)
    ji = JHNSW(JHCfg(**kw), max_external_id=300)
    ti = HNSWIndex(HNSWConfig(backend="torch", **kw), max_external_id=300,
                   device="cpu")
    j_run(ji, j_runbook("sliding_window", **rb_kw), eval_every=2,
          baseline="hnsw")
    run_runbook(ti, make_runbook("sliding_window", **rb_kw), eval_every=2,
                baseline="hnsw")
    q = grid_data(8, 16, 7)     # a user's queries, which the counters book
    ji.search(q, k=5)
    ti.search(q, k=5)
    names = ("insert_s", "search_s", "search_comps", "n_inserts",
             "n_queries")
    for name in names:
        got = getattr(ti, name)
        assert got == getattr(ti.counters, name), name
        if name.endswith("_s"):
            assert isinstance(got, float) and got >= 0.0, name
        else:
            assert got == getattr(ji, name) and got > 0, name
        with pytest.raises(AttributeError):
            setattr(ti, name, got)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def _card_index(dev, n_pts=600, d=32, r=12, l=32, seed=0):
    """A port-built grid-valued index on the CPU (its configuration and the
    queries), made without JAX."""
    from repro_torch.core import StreamingIndex

    rng = np.random.default_rng(seed)
    data = (rng.integers(-64, 65, size=(n_pts, d)) / 16).astype(np.float32)
    q = (rng.integers(-64, 65, size=(64, d)) / 16).astype(np.float32)
    cfg = TCfg(dim=d, n_cap=1024, r=r, l_build=l, l_search=l, l_delete=l,
               k_delete=16, backend="auto")
    idx = StreamingIndex(cfg, max_external_id=n_pts, device="cpu")
    idx.insert(np.arange(n_pts), data)
    idx.delete(np.arange(0, n_pts, 7))
    return idx, q


@pytest.mark.requires_cuda
def test_vmap_on_card_equals_cpu_copy(cuda_device):
    """The card's vmap engine (kernel 1 a hop, ``backend="cuda"``) against
    its CPU copy (the plain tile), every field bitwise on grid data; one
    kernel-1 launch a hop plus the start's."""
    import dataclasses

    from repro_torch.kernels import ops

    idx, q = _card_index(cuda_device)
    cfg = dataclasses.replace(idx.cfg, backend="cuda")
    card = convert.index_state_from_numpy(
        convert.index_state_to_numpy(idx.istate), cuda_device).graph
    want = t_vmap(idx.state, dataclasses.replace(cfg, backend="torch"),
                  t(q), k=10, l=32)
    ops.reset_launch_counts()
    got = t_vmap(card, cfg, t(q).to(cuda_device), k=10, l=32)
    counts = ops.launch_counts()
    assert_port_equal(got, want, "vmap")
    assert counts["gather_distance_batched"] == int(want.n_hops.max()) + 1
    assert sum(counts.values()) == counts["gather_distance_batched"]


@pytest.mark.requires_cuda
def test_batched_tile_equals_per_lane_single_query_calls(cuda_device):
    """Kernel 1's (B, R) tile is B calls of kernel 2, bitwise on Gaussian
    data: both reduce each (query, row) pair in the same order."""
    from repro_torch.kernels import gather_distance as gd

    g = torch.Generator().manual_seed(1)
    vec = torch.randn((5000, 128), generator=g).to(cuda_device)
    norms = (vec * vec).sum(1)
    qb = torch.randn((64, 128), generator=g).to(cuda_device)
    ids = torch.randint(0, 5000, (64, 64), generator=g, dtype=torch.int32)
    ids[torch.rand((64, 64), generator=g) < 0.2] = -1
    ids = ids.to(cuda_device)
    for metric in ("l2", "ip"):
        tile = gd.gather_distance_batched_cuda(ids, qb, vec, norms,
                                               metric=metric)
        rows = torch.stack([gd.gather_distance_cuda(ids[b], qb[b], vec,
                                                    norms, metric=metric)
                            for b in range(64)])
        assert torch.equal(tile, rows), metric
