"""The ``local`` policy through ``apply`` and ``StreamingIndex``, and the
``fresh`` / ``local`` rows of the runbook tests, against the JAX reference on
the CPU: the counterparts of ``test_policy_local.py`` (all but the segment
case, which waits for compiled segments) and of ``test_runbooks.py``'s
sliding-window rows at a smaller size.

Every stream runs in both packages and the whole ``IndexState`` must agree:
ints exactly, floats to the reference's bar on Gaussian data (the engines'
distances are never stored, so the graphs agree id for id); the reference's
invariant oracle runs on the JAX state.
"""
import dataclasses

import numpy as np
import pytest

from invariants import assert_graph_invariants
from torch_parity import assert_field, assert_index_equal, cfg_pair

from repro.core import StreamingIndex as JIndex
from repro.core import api as japi
from repro.core import make_dataset, make_runbook, run_runbook
from repro.core.types import init_index_state as j_init
from repro_torch.core import StreamingIndex as TIndex
from repro_torch.core import api as tapi
from repro_torch.core import make_runbook as t_runbook
from repro_torch.core import run_runbook as t_run
from repro_torch.core.types import init_index_state as t_init


def _kw(metric="l2", quantized=False, n_cap=192, **extra):
    return dict(dim=20, n_cap=n_cap, r=8, l_build=20, l_search=20,
                l_delete=20, k_delete=10, n_copies=2, alpha=1.2,
                metric=metric, quantized=quantized, **extra)


def _pair(kw, **idx_kw):
    jcfg, tcfg = cfg_pair(**kw)
    return JIndex(jcfg, mode="local", **idx_kw), \
        TIndex(tcfg, mode="local", device="cpu", **idx_kw)


def _stream_states(kw, data, torch_backend, n0=80, dels=(0, 30)):
    """Bootstrap n0 points, then a delete-heavy stream under local, raw
    ``apply`` in both packages."""
    jcfg, tcfg = cfg_pair(torch_backend=torch_backend, **kw)
    js, ts = j_init(jcfg, 1000), t_init(tcfg, 1000, device="cpu")
    ins = np.arange(n0)
    js, _ = japi.apply(js, jcfg, japi.insert_batch(ins, data[:n0]),
                       policy="local", sequential=True)
    ts, _ = tapi.apply(ts, tcfg, tapi.insert_batch(ins, data[:n0],
                                                   device="cpu"),
                       policy="local", sequential=True)
    d = np.arange(*dels)
    js, jr = japi.apply(js, jcfg, japi.delete_batch(d, kw["dim"]),
                        policy="local", sequential=True)
    ts, tr = tapi.apply(ts, tcfg, tapi.delete_batch(d, kw["dim"],
                                                    device="cpu"),
                        policy="local", sequential=True)
    for f in ("slot", "ok", "n_comps"):
        assert_field(getattr(jr, f), getattr(tr, f), f"result {f}")
    assert np.asarray(tr.ok)[:len(d)].all()
    return jcfg, js, ts


@pytest.mark.parametrize("metric,backend", [("l2", "torch"), ("l2", "ref"),
                                            ("ip", "torch")])
def test_backend_parity_repair(metric, backend):
    data, _ = make_dataset(120, 20, metric, n_queries=4, seed=31)
    jcfg, js, ts = _stream_states(_kw(metric), data, backend)
    assert_index_equal(js, ts, exact=False, where=f"{metric}/{backend}")
    assert_graph_invariants(js, jcfg, policy="local")


def test_delete_reinsert_slot_reuse():
    """A local delete pushes the slot onto the free stack; the next insert
    pops it (LIFO)."""
    data, _ = make_dataset(90, 20, n_queries=4, seed=33)
    ji, ti = _pair(_kw())
    for idx in (ji, ti):
        idx.insert(np.arange(80), data[:80])
    victim = int(ti.istate.ext2slot[17])
    top = int(ti.istate.graph.free_top)
    for idx in (ji, ti):
        idx.delete(np.array([17]))
    g = ti.istate.graph
    assert int(g.free_top) == top + 1 and int(g.free_stack[top]) == victim
    assert int(g.n_pending) == 0
    assert_index_equal(ji.istate, ti.istate, exact=False, where="delete")
    for idx in (ji, ti):
        idx.insert(np.array([555]), data[88:89])
    assert int(ti.istate.ext2slot[555]) == victim
    assert int(ti.istate.slot2ext[victim]) == 555
    assert_index_equal(ji.istate, ti.istate, exact=False, where="reinsert")
    assert_graph_invariants(ji.istate, ji.cfg, policy="local")


def test_local_with_quantized_tier():
    data, queries = make_dataset(120, 20, "l2", n_queries=16, seed=34)
    ji, ti = _pair(_kw(quantized=True))
    for idx in (ji, ti):
        idx.insert(np.arange(100), data[:100])
        idx.delete(np.arange(0, 40))
    assert ti.n_active == 60 and ti.state.quant is not None
    assert_index_equal(ji.istate, ti.istate, exact=False, where="int8")
    rec = ti.recall(queries, k=10)
    assert rec == ji.recall(queries, k=10) and rec >= 0.80


def test_local_across_capacity_growth():
    data, queries = make_dataset(300, 20, "l2", n_queries=16, seed=35)
    ji, ti = _pair(_kw(n_cap=128), auto_grow=True)
    for idx in (ji, ti):
        idx.insert(np.arange(100), data[:100])
        idx.delete(np.arange(0, 20))
        idx.insert(np.arange(100, 260), data[100:260])
    assert ti.cfg.n_cap == ji.cfg.n_cap > 128
    assert_index_equal(ji.istate, ti.istate, exact=False, where="grown")
    for idx in (ji, ti):
        idx.delete(np.arange(20, 60))
    assert ti.n_active == 200
    assert_index_equal(ji.istate, ti.istate, exact=False, where="deleted")
    assert_graph_invariants(ji.istate, ji.cfg, policy="local")
    rec = ti.recall(queries, k=10)
    assert rec == ji.recall(queries, k=10) and rec >= 0.80


def test_local_runbook_invariants_every_window():
    rb = make_runbook("sliding_window", n=240, dim=16, t_max=8, seed=37)
    kw = dict(dim=16, n_cap=360, r=8, l_build=20, l_search=20, l_delete=20,
              k_delete=10, alpha=1.2)
    ji, ti = _pair(kw, max_external_id=300)
    for t, step in enumerate(rb.steps):
        for idx in (ji, ti):
            if len(step.insert_ids):
                idx.insert(step.insert_ids, rb.data[step.insert_ids])
            if len(step.delete_ids):
                idx.delete(step.delete_ids)
        assert_index_equal(ji.istate, ti.istate, exact=False,
                           where=f"window {t}")
        assert_graph_invariants(ji.istate, ji.cfg, policy="local",
                                context=f"window {t}")
    assert int(ti.istate.graph.n_pending) == 0


@pytest.mark.parametrize("cap", [1, 4])
def test_local_in_cap_bounds_repair(cap):
    data, _ = make_dataset(100, 20, "l2", n_queries=4, seed=36)
    jcfg, js, ts = _stream_states(_kw(local_in_cap=cap), data, "torch",
                                  dels=(0, 25))
    assert_index_equal(js, ts, exact=False, where=f"cap {cap}")
    assert_graph_invariants(js, jcfg, policy="local")
    adj = ts.graph.adj.numpy()
    dead = ts.graph.free_stack[:int(ts.graph.free_top)].numpy()
    live_rows = adj[ts.graph.active.numpy()]
    assert not np.isin(live_rows[live_rows >= 0], dead).any()


@pytest.mark.parametrize("mode", ["fresh", "local"])
def test_sliding_window_recall_stable(mode):
    """``test_runbooks.py``'s sliding-window row for the two policies, at
    600 points: the per-eval recall, counters and final state equal the
    reference's, and the reference's bars hold."""
    rb_j = make_runbook("sliding_window", n=600, dim=24, t_max=12, seed=0)
    rb_t = t_runbook("sliding_window", n=600, dim=24, t_max=12, seed=0)
    kw = dict(dim=24, n_cap=700, r=16, l_build=32, l_search=32,
              l_delete=32, k_delete=16, n_copies=3)
    jcfg, tcfg = cfg_pair(**kw)
    ji = JIndex(jcfg, mode=mode, max_external_id=650)
    ti = TIndex(tcfg, mode=mode, max_external_id=650, device="cpu")
    jr = run_runbook(ji, rb_j, k=10, eval_every=2)
    tr = t_run(ti, rb_t, k=10, eval_every=2)
    assert [m.recall for m in jr.steps] == [m.recall for m in tr.steps]
    assert [m.comps_per_query for m in jr.steps] == \
        [m.comps_per_query for m in tr.steps]
    for f in ("n_inserts", "n_deletes", "insert_comps", "delete_comps",
              "n_consolidations"):
        assert getattr(jr.counters, f) == getattr(tr.counters, f), f
    if mode == "fresh":
        assert tr.counters.n_consolidations >= 1
    assert_index_equal(ji.istate, ti.istate, exact=False, where=mode)
    assert tr.avg_recall >= 0.88, tr.summary()
    steady = [m.recall for m in tr.steps if m.step >= rb_t.eval_from]
    assert min(steady) >= tr.avg_recall - 0.12
