"""The port's update algorithms against the JAX reference.

Fixed-seed insert and delete streams through ``insert_many``,
``insert_many_batched``, ``ip_delete_many``, ``ip_delete_many_batched`` and
``light_consolidate``; after each, the graph fields equal the reference's
exactly (vectors and norms bitwise on grid data, to tolerance on Gaussian
data).  Also RobustPrune, ``append_one`` on a full row (the prune path) and
``remove_target_rows`` on their own.
"""
from importlib import import_module

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_parity import assert_field, assert_graph_equal, cfg_pair, \
    grid_data, small_kw, t

# modules by path: the packages re-export functions under some module names
jbat, jcons, jdel, jedges, jins, jprune, jtypes = (
    import_module(f"repro.core.{m}") for m in
    ("batched", "consolidate", "delete", "edges", "insert", "prune", "types"))
tbat, tcons, tdel, tedges, tins, tprune, ttypes = (
    import_module(f"repro_torch.core.{m}") for m in
    ("batched", "consolidate", "delete", "edges", "insert", "prune", "types"))

GRAPH_FIELDS = ("adj", "active", "quarantine", "free_stack", "free_top",
                "start", "n_active", "n_pending")


def _data(kind, nrow, dim, metric, seed=0):
    if kind == "grid":
        return grid_data(nrow, dim, seed)
    from repro.core.runbook import make_dataset

    return make_dataset(nrow, dim, metric, n_queries=1, seed=seed)[0]


def _check(jg, tg, exact, where):
    assert_graph_equal(jg, tg, GRAPH_FIELDS, True, where)
    assert_graph_equal(jg, tg, ("vectors", "norms"), exact, where)


@pytest.mark.parametrize("metric,kind", [("l2", "grid"), ("ip", "grid"),
                                         ("l2", "gauss"), ("ip", "gauss")])
def test_update_streams_match_reference(metric, kind):
    jcfg, tcfg = cfg_pair(**small_kw(metric))
    xs = _data(kind, 150, 24, metric, seed=5)
    exact = kind == "grid"
    jg, tg = jtypes.init_state(jcfg), ttypes.init_state(tcfg, "cpu")

    jg, js = jins.insert_many(jg, jcfg, jnp.asarray(xs[:40]))
    tg, ts = tins.insert_many(tg, tcfg, t(xs[:40]))
    _check(jg, tg, exact, "insert_many")
    assert_field(js.slot, ts.slot, "insert slots")
    assert_field(js.n_comps, ts.n_comps, "insert comps")
    assert_field(js.n_hops, ts.n_hops, "insert hops")

    valid = np.ones(64, bool)
    valid[[3, 17]] = False                     # masked lanes
    jg, js = jbat.insert_many_batched(jg, jcfg, jnp.asarray(xs[40:104]),
                                      jnp.asarray(valid))
    tg, ts = tbat.insert_many_batched(tg, tcfg, t(xs[40:104]),
                                      torch.from_numpy(valid))
    _check(jg, tg, exact, "insert_many_batched")
    assert_field(js.slot, ts.slot, "batched slots")
    assert_field(js.n_comps, ts.n_comps, "batched comps")

    rng = np.random.default_rng(1)
    live = np.nonzero(np.asarray(jg.active))[0]
    order = rng.permutation(live).astype(np.int32)
    seq = np.concatenate([order[:10], [-1, 699]]).astype(np.int32)
    jg, jd = jdel.ip_delete_many(jg, jcfg, jnp.asarray(seq))
    tg, td = tdel.ip_delete_many(tg, tcfg, t(seq))
    _check(jg, tg, exact, "ip_delete_many")
    for f in ("ok", "n_comps", "n_in"):
        assert_field(getattr(jd, f), getattr(td, f), f"delete {f}")

    bat = order[10:26]
    jg, jd = jbat.ip_delete_many_batched(jg, jcfg, jnp.asarray(bat))
    tg, td = tbat.ip_delete_many_batched(tg, tcfg, t(bat))
    _check(jg, tg, exact, "ip_delete_many_batched")
    for f in ("ok", "n_comps"):
        assert_field(getattr(jd, f), getattr(td, f), f"batched delete {f}")

    assert bool(jcons.consolidation_due(jg, jcfg)) == \
        bool(tcons.consolidation_due(tg, tcfg))
    jg = jcons.light_consolidate(jg, jcfg)
    tg = tcons.light_consolidate(tg, tcfg)
    _check(jg, tg, exact, "light_consolidate")

    # reinserts land in the released slots
    jg, _ = jbat.insert_many_batched(jg, jcfg, jnp.asarray(xs[104:150]))
    tg, _ = tbat.insert_many_batched(tg, tcfg, t(xs[104:150]))
    _check(jg, tg, exact, "reinserts")


def _graph(metric, kind):
    jcfg, tcfg = cfg_pair(**small_kw(metric))
    xs = _data(kind, 120, 24, metric, seed=2)
    jg, _ = jins.insert_many(jtypes.init_state(jcfg), jcfg,
                             jnp.asarray(xs[:24]))
    jg, _ = jbat.insert_many_batched(jg, jcfg, jnp.asarray(xs[24:]))
    from repro_torch import convert
    from torch_parity import jax_index_numpy

    d = jax_index_numpy(jtypes.init_index_state(jcfg, 4)._replace(graph=jg))
    tg = convert.index_state_from_numpy(d, device="cpu").graph
    return jcfg, tcfg, jg, tg, xs


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("with_dists", [False, True])
def test_robust_prune_matches_reference(metric, with_dists):
    jcfg, tcfg, jg, tg, xs = _graph(metric, "grid")
    rng = np.random.default_rng(4)
    cand = rng.integers(-1, 120, size=40).astype(np.int32)
    cand[5] = cand[4]                          # duplicates
    p = grid_data(1, 24, 8)[0]
    dists = None
    if with_dists:
        dists = rng.integers(0, 200, size=40).astype(np.float32)
        dists[rng.random(40) < 0.3] = np.inf   # recomputed where not finite
    jr = jprune.robust_prune(jg, jcfg, jnp.asarray(p), jnp.asarray(cand),
                             None if dists is None else jnp.asarray(dists),
                             p_id=jnp.int32(cand[0]))
    tr = tprune.robust_prune(tg, tcfg, t(p), t(cand),
                             None if dists is None else t(dists),
                             p_id=int(cand[0]))
    assert_field(jr, tr, "pruned row")


def test_append_one_and_remove_target_rows_match_reference():
    jcfg, tcfg, jg, tg, xs = _graph("l2", "grid")
    full = np.nonzero((np.asarray(jg.adj) >= 0).sum(1) == jcfg.r)[0]
    part = np.nonzero(((np.asarray(jg.adj) >= 0).sum(1) < jcfg.r)
                      & np.asarray(jg.active))[0]
    assert len(full) and len(part)
    for v, u in ((full[0], part[0]), (part[0], full[-1]), (full[1], full[1]),
                 (-1, 3)):
        jg = jedges.append_one(jg, jcfg, jnp.int32(v), jnp.int32(u))
        tg = tedges.append_one(tg, tcfg, int(v), int(u))
        assert_field(jg.adj, tg.adj, f"append {v}->{u}")
    target = int(np.asarray(jg.adj)[full[0], 0])
    rows = np.array([full[0], -1, full[1], part[0]], np.int32)
    ja = jedges.remove_target_rows(jg, jcfg, jnp.asarray(rows), target)
    ta = tedges.remove_target_rows(tg, tcfg, t(rows), target)
    assert_field(ja, ta, "remove_target_rows")
