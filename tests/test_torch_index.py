"""``StreamingIndex`` and ``run_runbook`` of the port against the JAX
reference, on the CPU: the ROADMAP's exit bar for the runbook driver.

``run_runbook`` on a sliding-window runbook at ``test_scale`` under the
``ip`` policy, through ``StreamingIndex(batch_updates=True)`` in both
packages, with and without the int8 tier: the per-eval recall equals the
reference's and the final ``IndexState`` is leaf-identical on the ``torch``
engine (ints exactly, floats to the reference's bar on this Gaussian
data).  The capacity starts below the stream's demand, so both runs grow.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import assert_field, assert_index_equal, jax_index_numpy, \
    qgrid_data

from repro.configs.ann import test_scale as j_test_scale
from repro.core import StreamingIndex as JIndex
from repro.core import make_runbook as j_runbook
from repro.core import run_runbook as j_run
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import test_scale as t_test_scale
from repro_torch.core import StreamingIndex as TIndex
from repro_torch.core import make_runbook as t_runbook
from repro_torch.core import run_runbook as t_run

DIM = 24


def _pair(quantized, n_cap=128, **kw):
    jcfg = dataclasses.replace(j_test_scale(DIM, n_cap, backend="jnp"),
                               quantized=quantized)
    tcfg = dataclasses.replace(t_test_scale(DIM, n_cap, backend="torch"),
                               quantized=quantized)
    return (JIndex(jcfg, **kw), TIndex(tcfg, device="cpu", **kw))


@pytest.mark.parametrize("quantized", [False, True])
def test_run_runbook_matches_reference(quantized):
    rb_j = j_runbook("sliding_window", n=600, dim=DIM, t_max=12, seed=0)
    rb_t = t_runbook("sliding_window", n=600, dim=DIM, t_max=12, seed=0)
    np.testing.assert_array_equal(rb_j.data, rb_t.data)
    ji, ti = _pair(quantized, max_external_id=600, batch_updates=True)
    jr = j_run(ji, rb_j, k=10, eval_every=3)
    tr = t_run(ti, rb_t, k=10, eval_every=3)
    assert [m.step for m in jr.steps] == [m.step for m in tr.steps]
    assert [m.recall for m in jr.steps] == [m.recall for m in tr.steps]
    assert [m.n_active for m in jr.steps] == [m.n_active for m in tr.steps]
    assert [m.comps_per_query for m in jr.steps] == \
        [m.comps_per_query for m in tr.steps]
    assert jr.avg_recall == tr.avg_recall and tr.avg_recall >= 0.9
    for f in ("n_inserts", "n_deletes", "insert_comps", "delete_comps",
              "n_consolidations"):
        assert getattr(jr.counters, f) == getattr(tr.counters, f), f
    assert ji.cfg.n_cap == ti.cfg.n_cap > 128      # both grew
    assert (ti.state.quant is not None) == quantized
    assert_index_equal(ji.istate, ti.istate, exact=False, where="final")
    assert tr.summary()["runbook"] == "SlidingWindow"


def test_jax_built_quantized_state_continues_in_port():
    """A quantized handle built by the reference, carried over with
    ``convert``, continues in the port exactly as in JAX (grid data with
    power-of-two scales: bitwise)."""
    data = qgrid_data(300, DIM, 3)
    queries = qgrid_data(16, DIM, 4)
    ji, ti = _pair(True, max_external_id=400, batch_updates=True)
    ji.insert(np.arange(150), data[:150])
    ti.istate = convert.index_state_from_numpy(jax_index_numpy(ji.istate),
                                               "cpu")
    ti.cfg = dataclasses.replace(ti.cfg, n_cap=ji.cfg.n_cap)
    for idx in (ji, ti):
        idx.insert(np.arange(150, 300), data[150:])
        idx.delete(np.arange(0, 300, 4))
        idx.maybe_consolidate(force=True)
    assert ji.cfg.n_cap == ti.cfg.n_cap
    assert_index_equal(ji.istate, ti.istate, where="continued")
    je, jd, js = ji.search(queries, k=10)
    te, td, ts = ti.search(queries, k=10)
    assert_field(je, te, "ext ids")
    assert_field(jd, td, "dists")
    assert not np.isin(te, np.arange(0, 300, 4)).any()
    assert ji.recall(queries) == ti.recall(queries)


def test_capacity_exhausted_without_auto_grow():
    data = qgrid_data(70, DIM, 5)
    for idx in _pair(True, n_cap=64, max_external_id=100, auto_grow=False):
        with pytest.raises(RuntimeError, match="capacity exhausted"):
            idx.insert(np.arange(70), data)
        assert idx.cfg.n_cap == 64 and idx.n_active == 64
    ji, ti = _pair(True, n_cap=64, max_external_id=100)
    ji.insert(np.arange(70), data)
    ti.insert(np.arange(70), data)
    assert ji.cfg.n_cap == ti.cfg.n_cap == 128
    assert_index_equal(ji.istate, ti.istate, where="grown")


def test_exception_contracts(tmp_path):
    data = qgrid_data(40, DIM, 6)
    _, ti = _pair(True, max_external_id=50)
    with pytest.raises(ValueError):
        ti.insert(np.array([3, 50]), data[:2])
    assert ti.n_active == 0
    ti.insert(np.arange(40), data)
    with pytest.raises(KeyError):
        ti.delete(np.array([1, 2, 2, 45]))
    assert ti.n_active == 38 and ti.counters.n_deletes == 2
    q0 = ti.counters.n_queries
    ti.recall(data[:4])
    assert ti.counters.n_queries == q0 and ti.eval_counters.n_queries == 4
    with pytest.raises(ValueError):
        TIndex(ti.cfg, mode="nope", device="cpu")
    with pytest.raises(ValueError):
        TIndex(ti.cfg, max_external_id=0, device="cpu")
    assert ti.apply_segments([]) == []
    with pytest.raises(FileNotFoundError):
        TIndex.restore(CheckpointManager(tmp_path), ti.cfg, device="cpu")
    rb = t_runbook("sliding_window", n=40, dim=DIM, t_max=4, seed=0)
    with pytest.raises(ValueError, match="batch_updates=False"):
        t_run(TIndex(ti.cfg, batch_updates=True, device="cpu"), rb,
              segmented=True)
    with pytest.raises(TypeError):
        t_run(ti, rb, baseline="hnsw")
    with pytest.raises(ValueError):
        t_run(ti, rb, baseline="nope")


def test_default_device_is_the_card():
    """Without ``device=`` the handle is allocated on the card: here, where
    torch has no CUDA, that raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        TIndex(t_test_scale(DIM, 64))
