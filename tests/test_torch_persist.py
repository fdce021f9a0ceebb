"""Durability of the port (``repro_torch.checkpoint``, ``repro_torch.ft``,
``repro_torch.core.persist``) on the CPU.

  * ``CheckpointManager`` and ``Supervisor`` on trees of tensors: the
    cases of ``tests/test_checkpoint_ft.py`` (atomic commit, torn and
    missing leaves, kills before and after the rename, bit-exact restarts
    and the restart budgets);
  * the on-disk format is the reference's: the same leaf keys, order,
    shapes and dtypes as JAX's ``_flatten`` (f32 and int8 tiers), and a
    checkpoint written by either package restores in the other to
    identical leaves;
  * ``restore_index``'s validation (config, policy, schema, capacity)
    raises ``CheckpointMismatchError``; a smaller bucket restores grown,
    bitwise; a stacked (sharded) checkpoint restores as the stacked state,
    bitwise the reference's, and ``StreamingIndex.restore`` refuses it;
    ``grow_index`` on a stacked state equals the reference's;
  * ``run_segments_supervised`` after injected failures, including kills
    inside a save, ends bitwise equal to an uninterrupted ``run_segments``;
  * ``StreamingIndex.save`` / ``restore``, on the CPU and, on the card,
    through ``python -m pytest --noconftest -m requires_cuda
    tests/test_torch_persist.py`` (JAX is imported inside the CPU tests
    only).
"""
import dataclasses
import json
from typing import NamedTuple

import numpy as np
import pytest
import torch

from torch_parity import assert_index_equal, assert_port_equal, cfg_pair, \
    cuda_device, grid_data, jax_index_state, qgrid_data, \
    small_kw  # noqa: F401

from repro_torch import convert
from repro_torch.checkpoint import (CheckpointManager,
                                    CheckpointMismatchError, restore_onto)
from repro_torch.checkpoint.manager import _flatten
from repro_torch.configs import test_scale as scaled_cfg
from repro_torch.core import StreamingIndex as TIndex
from repro_torch.core import api as tapi
from repro_torch.core.grow import grow_index
from repro_torch.core.persist import (restore_index, run_segments_supervised,
                                      save_index)
from repro_torch.core.runbook import make_runbook, runbook_segment_plan
from repro_torch.core.types import KIND_INSERT, init_index_state, \
    unstack_state
from repro_torch.ft import SimulatedFailure, Supervisor

DIM = 24
CFG = scaled_cfg(dim=16, n_cap=256)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 4), generator=g),
            "b": {"c": torch.arange(10, dtype=torch.int32)}}


def _leaves_equal(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)


# -- CheckpointManager -------------------------------------------------------


def test_save_load_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(5, t, extra={"note": "x"})
    step, got, extra = mgr.load(like=t)
    assert step == 5 and extra["note"] == "x"
    assert isinstance(got["a"], np.ndarray)
    _leaves_equal(t, got)
    _leaves_equal(t, restore_onto(got, device="cpu"))


def test_keep_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.latest() == 4
    assert sorted(mgr._complete_steps()) == [3, 4]


def test_incomplete_checkpoint_is_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    broken = tmp_path / "step_00000002.tmp"
    broken.mkdir()
    (broken / "leaf_00000.npy").write_bytes(b"garbage")
    assert mgr.latest() == 1


def test_structure_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    with pytest.raises(CheckpointMismatchError, match="structure mismatch"):
        mgr.load(like={"different": torch.zeros(3)})


def test_leaf_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    wrong = _tree()
    wrong["a"] = torch.zeros((8, 5))
    with pytest.raises(CheckpointMismatchError, match="leaf 'a'"):
        mgr.load(like=wrong)
    wrong["a"] = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(CheckpointMismatchError, match="leaf 'a'"):
        mgr.load(like=wrong)


def test_torn_leaf_detected(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(1, t)
    d = tmp_path / "step_00000001"
    np.save(d / "leaf_00000.npy", np.zeros((2, 2), np.float32))
    with pytest.raises(CheckpointMismatchError, match="torn leaf"):
        mgr.load(like=t)
    (d / "leaf_00000.npy").write_bytes(b"garbage")
    with pytest.raises(CheckpointMismatchError, match="unreadable leaf"):
        mgr.load(like=t)


@pytest.mark.parametrize("event", ["leaf:1", "manifest"])
def test_kill_before_rename_keeps_previous_step(tmp_path, event):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(1, t)

    def boom(e):
        if e == event:
            raise SimulatedFailure(f"killed at {e}")

    with pytest.raises(SimulatedFailure):
        mgr.save(2, _tree(seed=1), on_event=boom)
    assert mgr.latest() == 1
    step, got, _ = mgr.load(like=t)
    assert step == 1
    _leaves_equal(t, got)
    mgr.save(2, _tree(seed=1))
    assert mgr.latest() == 2


def test_kill_after_rename_commits_new_step(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())

    def boom(e):
        if e == "rename":
            raise SimulatedFailure("killed after rename")

    t2 = _tree(seed=1)
    with pytest.raises(SimulatedFailure):
        mgr.save(2, t2, on_event=boom)
    assert mgr.latest() == 2
    step, got, _ = mgr.load(like=t2)
    assert step == 2
    _leaves_equal(t2, got)


class _Pair(NamedTuple):
    x: object
    y: object


def test_flatten_keys_match_reference():
    """NamedTuple fields, sorted dict keys, sequence indices and ``None``
    are named and ordered as the reference's ``_flatten`` names them."""
    import jax.numpy as jnp

    from repro.checkpoint.manager import _flatten as j_flatten

    def tree(arr):
        return {"z": _Pair(arr(3), None), "a": [arr(1), {"q": arr(2)}],
                "m": _Pair(_Pair(arr(4), arr(5)), [arr(6)])}

    jkeys, _ = j_flatten(tree(lambda i: jnp.full((i,), i)))
    tkeys = _flatten(tree(lambda i: torch.full((i,), i)))
    assert list(jkeys) == list(tkeys)
    assert [np.asarray(v).tolist() for v in jkeys.values()] == \
        [v.tolist() for v in tkeys.values()]


# -- Supervisor --------------------------------------------------------------


def _make_train():
    """A tiny deterministic training problem: the batch of step t is a
    function of t alone."""
    w0 = torch.zeros((64, 64))

    def step_fn(w, t):
        rng = np.random.default_rng(t)
        x = torch.nn.functional.one_hot(
            torch.from_numpy(rng.integers(0, 64, 32)), 64).float()
        y = torch.nn.functional.one_hot(
            torch.from_numpy(rng.integers(0, 64, 32)), 64).float()
        grad = 2 * x.T @ (x @ w - y) / y.numel()
        return w - 0.1 * grad

    return w0, step_fn


def test_supervisor_restart_is_bit_exact(tmp_path):
    w0, step_fn = _make_train()
    w_ref = w0
    for t in range(25):
        w_ref = step_fn(w_ref, t)
    sup = Supervisor(CheckpointManager(tmp_path / "ckpt"),
                     checkpoint_every=5)
    w_got, info = sup.run(w0, step_fn, 25, device="cpu",
                          fail_at={7: 1, 13: 2, 24: 1})
    assert info["restarts"] == 4
    assert torch.equal(w_ref, w_got)


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    w0, step_fn = _make_train()
    sup = Supervisor(CheckpointManager(tmp_path / "ckpt"),
                     checkpoint_every=5, max_restarts=2)
    with pytest.raises(SimulatedFailure):
        sup.run(w0, step_fn, 10, device="cpu", fail_at={3: 99})


def test_supervisor_per_step_budget(tmp_path):
    w0, step_fn = _make_train()
    sup = Supervisor(CheckpointManager(tmp_path / "ckpt"),
                     checkpoint_every=5, max_restarts=50,
                     max_restarts_per_step=3)
    logs = []
    with pytest.raises(SimulatedFailure):
        sup.run(w0, step_fn, 10, device="cpu", fail_at={3: 99},
                log=logs.append)
    assert any("giving up" in s for s in logs)
    assert sum("failure at step 3" in s for s in logs) == 3

    sup2 = Supervisor(CheckpointManager(tmp_path / "ckpt2"),
                      checkpoint_every=5, max_restarts=50,
                      max_restarts_per_step=3)
    _, info = sup2.run(w0, step_fn, 10, device="cpu",
                       fail_at={2: 2, 6: 2})
    assert info["restarts"] == 4 and info["final_step"] == 10


# -- the shared format: leaf keys, dtypes, cross-restore ---------------------


def _built_state(quantized):
    """A port handle with content: 120 serial grid inserts (qgrid on the
    int8 tier), 30 in-place deletes; and its config pair."""
    kw = dict(small_kw(), quantized=quantized)
    jcfg, tcfg = cfg_pair(**kw)
    data = (qgrid_data if quantized else grid_data)(120, DIM, 31)
    st = init_index_state(tcfg, 400, device="cpu")
    st, _ = tapi.apply(st, tcfg, tapi.insert_batch(np.arange(120), data,
                                                   device="cpu"),
                       sequential=True)
    st, _ = tapi.apply(st, tcfg, tapi.delete_batch(np.arange(30), DIM,
                                                   device="cpu"))
    return jcfg, tcfg, st


@pytest.mark.parametrize("quantized", [False, True])
def test_leaf_keys_and_dtypes_match_reference(tmp_path, quantized):
    from repro.checkpoint import CheckpointManager as JManager
    from repro.checkpoint.manager import _flatten as j_flatten
    from repro.core.persist import save_index as j_save

    jcfg, tcfg, ts = _built_state(quantized)
    js = jax_index_state(convert.index_state_to_numpy(ts))
    jflat, _ = j_flatten(js)
    tflat = _flatten(ts)
    assert list(jflat) == list(tflat)
    assert (".graph/.quant/.codes" in tflat) == quantized
    for k in jflat:
        assert tuple(jflat[k].shape) == tuple(tflat[k].shape), k
        assert np.asarray(jflat[k]).dtype == tflat[k].numpy().dtype, k
    j_save(JManager(tmp_path / "j"), 1, js, jcfg)
    save_index(CheckpointManager(tmp_path / "t"), 1, ts, tcfg)
    jm = json.loads((tmp_path / "j/step_00000001/MANIFEST.json").read_text())
    tm = json.loads((tmp_path / "t/step_00000001/MANIFEST.json").read_text())
    assert jm["leaves"] == tm["leaves"]
    for f in ("kind", "schema", "policy", "max_external_id", "n_logical"):
        assert jm["extra"]["index"][f] == tm["extra"]["index"][f], f


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_restore(tmp_path, writer, quantized):
    from repro.checkpoint import CheckpointManager as JManager
    from repro.core.persist import restore_index as j_restore
    from repro.core.persist import save_index as j_save

    jcfg, tcfg, ts = _built_state(quantized)
    js = jax_index_state(convert.index_state_to_numpy(ts))
    if writer == "jax":
        j_save(JManager(tmp_path), 4, js, jcfg, policy="ip",
               extra={"tag": "j"})
        step, got, extra = restore_index(CheckpointManager(tmp_path), tcfg,
                                         policy="ip", device="cpu")
        assert_index_equal(js, got, True, "jax -> port")
    else:
        save_index(CheckpointManager(tmp_path), 4, ts, tcfg, policy="ip",
                   extra={"tag": "j"})
        step, got, extra = j_restore(JManager(tmp_path), jcfg, policy="ip")
        assert_index_equal(got, ts, True, "port -> jax")
    assert step == 4 and extra["user"]["tag"] == "j"


def test_streaming_index_cross_restore(tmp_path):
    """A reference ``StreamingIndex`` checkpoint resumes as a port
    ``StreamingIndex``: leaves, host counters and answers."""
    from repro.checkpoint import CheckpointManager as JManager
    from repro.core import StreamingIndex as JIndex

    jcfg, tcfg, ts = _built_state(False)
    ji = JIndex(jcfg, mode="ip", max_external_id=400)
    ji.istate = jax_index_state(convert.index_state_to_numpy(ts))
    ji.counters.n_inserts, ji.counters.insert_s = 120, 1.5
    ji.save(JManager(tmp_path), 2)
    ti, step = TIndex.restore(CheckpointManager(tmp_path), tcfg,
                              device="cpu")
    assert step == 2 and ti.mode == "ip" and ti.max_external_id == 400
    assert (ti.counters.n_inserts, ti.counters.insert_s) == (120, 1.5)
    assert_index_equal(ji.istate, ti.istate, True, "index")
    q = grid_data(8, DIM, 32)
    je, jd, _ = ji.search(q, k=5)
    te, td, _ = ti.search(q, k=5)
    np.testing.assert_array_equal(je, te)
    np.testing.assert_array_equal(jd, td)


# -- validation ---------------------------------------------------------------


def test_restore_validates_config(tmp_path):
    mgr = CheckpointManager(tmp_path)
    save_index(mgr, 1, init_index_state(CFG, 1024, device="cpu"), CFG)
    with pytest.raises(CheckpointMismatchError, match="config mismatch"):
        restore_index(mgr, dataclasses.replace(CFG, dim=CFG.dim * 2),
                      device="cpu")
    with pytest.raises(CheckpointMismatchError, match="config mismatch"):
        restore_index(mgr, dataclasses.replace(CFG, metric="ip"),
                      device="cpu")
    # serving knobs may drift freely
    restore_index(mgr, dataclasses.replace(CFG, l_search=CFG.l_search * 2,
                                           backend="auto"), device="cpu")


def test_restore_validates_policy_and_schema(tmp_path):
    mgr = CheckpointManager(tmp_path)
    save_index(mgr, 1, init_index_state(CFG, 1024, device="cpu"), CFG,
               policy="fresh")
    with pytest.raises(CheckpointMismatchError, match="policy"):
        restore_index(mgr, CFG, policy="ip", device="cpu")
    _, _, extra = restore_index(mgr, CFG, device="cpu")
    assert extra["index"]["policy"] == "fresh"
    mpath = tmp_path / "step_00000001" / "MANIFEST.json"
    man = json.loads(mpath.read_text())
    man["extra"]["index"]["schema"] = 2
    mpath.write_text(json.dumps(man))
    with pytest.raises(CheckpointMismatchError, match="schema"):
        restore_index(mgr, CFG, device="cpu")
    mgr2 = CheckpointManager(tmp_path / "raw")
    mgr2.save(1, {"w": np.zeros(3)})
    with pytest.raises(CheckpointMismatchError, match="index metadata"):
        restore_index(mgr2, CFG, device="cpu")


def test_restore_no_checkpoints(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_index(CheckpointManager(tmp_path), CFG, device="cpu")


def _stacked_state(n_cap=256, n=120):
    """A two-row ``ShardedIndex`` on grid data and its stacked state."""
    from repro_torch.core import ShardedIndex

    idx = ShardedIndex(scaled_cfg(dim=16, n_cap=n_cap, backend="torch"),
                       ["cpu"], n_logical=2, max_external_id=512)
    idx.insert(np.arange(n), grid_data(n, 16, 29))
    idx.delete(np.arange(0, n, 9))
    return idx, idx.states


def test_stacked_checkpoint_is_typed_mismatch(tmp_path):
    """A stacked (sharded) checkpoint (``n_logical`` >= 1): ``restore_index``
    returns the stacked state, bitwise the reference's ``restore_index``
    (also into a larger bucket, grown row by row);
    ``StreamingIndex.restore`` refuses it as the reference does, and so
    does ``ShardedIndex.restore`` onto a layout that does not divide L."""
    from repro.checkpoint import CheckpointManager as JManager
    from repro.configs.ann import test_scale as j_test_scale
    from repro.core.persist import restore_index as j_restore
    from repro_torch.core import ShardedIndex

    idx, stacked = _stacked_state()
    mgr = CheckpointManager(tmp_path)
    save_index(mgr, 1, stacked, idx.cfg)
    assert mgr.manifest()["extra"]["index"]["n_logical"] == 2
    for n_cap in (256, 512):
        tcfg = dataclasses.replace(idx.cfg, n_cap=n_cap)
        _, got, extra = restore_index(mgr, tcfg, device="cpu")
        assert extra["index"]["n_logical"] == 2
        assert got.graph.vectors.shape == (2, n_cap, 16)
        _, want, _ = j_restore(JManager(tmp_path), j_test_scale(16, n_cap))
        assert_index_equal(want, got, where=f"n_cap {n_cap}")
    _, as_numpy, _ = restore_index(mgr, idx.cfg, device=False)
    np.testing.assert_array_equal(as_numpy.graph.adj,
                                  stacked.graph.adj.numpy())
    with pytest.raises(CheckpointMismatchError, match="stacked"):
        TIndex.restore(mgr, idx.cfg, device="cpu")
    with pytest.raises(CheckpointMismatchError, match="reshard"):
        ShardedIndex.restore(mgr, idx.cfg, ["cpu"] * 3)


def test_grow_stacked_matches_reference():
    """``grow_index`` on a stacked state grows every row in lockstep, as
    the reference's vmapped grow does; the input handle stays valid."""
    from repro.configs.ann import test_scale as j_test_scale
    from repro.core.grow import grow_index as j_grow

    idx, stacked = _stacked_state(n_cap=128, n=100)
    held = convert.index_state_to_numpy(stacked)
    jstate = jax_index_state(held)
    want, jcfg = j_grow(jstate, j_test_scale(16, 128), 512)
    got, tcfg = grow_index(stacked, idx.cfg, 512)
    assert tcfg.n_cap == jcfg.n_cap == 512
    assert got.graph.free_stack.shape == (2, 512)
    assert_index_equal(want, got, where="grown stack")
    for r, (row, grown) in enumerate(zip(idx.rows, unstack_state(got))):
        assert_port_equal(grow_index(row, idx.cfg, 512)[0], grown,
                          f"row {r}")
    after = convert.index_state_to_numpy(stacked)
    np.testing.assert_array_equal(after["graph"]["adj"], held["graph"]["adj"])


# -- growth ---------------------------------------------------------------------


def _grid_index(n_cap, n, auto_grow=False, seed=19):
    cfg = scaled_cfg(dim=DIM, n_cap=n_cap)
    idx = TIndex(cfg, max_external_id=1024, auto_grow=auto_grow,
                 device="cpu")
    data = grid_data(max(n, 300), DIM, seed)
    idx.insert(np.arange(n), data[:n])
    return idx, data


def test_restore_into_larger_bucket_bitwise(tmp_path):
    idx, _ = _grid_index(256, 150)
    mgr = CheckpointManager(tmp_path)
    save_index(mgr, 0, idx.istate, idx.cfg)
    big = dataclasses.replace(idx.cfg, n_cap=1024)
    _, restored, _ = restore_index(mgr, big, device="cpu")
    grown, _ = grow_index(idx.istate, idx.cfg, 1024)
    assert_port_equal(grown, restored, "grown")
    _, as_numpy, _ = restore_index(mgr, big, device=False)
    assert isinstance(as_numpy.graph.adj, np.ndarray)
    np.testing.assert_array_equal(as_numpy.graph.adj, grown.graph.adj)


def test_replay_bit_identical_across_growth(tmp_path):
    """Checkpoint before a growth, then replay one stream on the live
    handle (grows online) and on a handle restored straight into the final
    bucket: bitwise equal."""
    idx, data = _grid_index(128, 100, auto_grow=True, seed=23)
    mgr = CheckpointManager(tmp_path)
    save_index(mgr, 0, idx.istate, idx.cfg)

    def steps():
        return [tapi.make_update_batch(
            np.full(50, KIND_INSERT), np.arange(100 + t * 50, 150 + t * 50),
            data[100 + t * 50:150 + t * 50], device="cpu")
            for t in range(4)]

    idx.apply_segments(steps())
    assert idx.cfg.n_cap > 128
    big = dataclasses.replace(idx.cfg, n_cap=idx.cfg.n_cap)
    _, restored, _ = restore_index(mgr, big, device="cpu")
    idx2 = TIndex(big, max_external_id=1024, device="cpu")
    idx2.istate = restored
    idx2.apply_segments(steps())
    assert_port_equal(idx.istate, idx2.istate, "replay")


def test_restore_shrink_is_typed_mismatch(tmp_path):
    idx, _ = _grid_index(256, 20)
    mgr = CheckpointManager(tmp_path)
    save_index(mgr, 0, idx.istate, idx.cfg)
    with pytest.raises(CheckpointMismatchError, match="exceeds"):
        restore_index(mgr, dataclasses.replace(idx.cfg, n_cap=128),
                      device="cpu")
    with pytest.raises(CheckpointMismatchError, match="quantized"):
        restore_index(mgr, dataclasses.replace(idx.cfg, quantized=True),
                      device="cpu")


# -- supervised replay ---------------------------------------------------------


def _plan(n=300, t_max=12, max_t=4, seed=0):
    rb = make_runbook("sliding_window", n=n, dim=CFG.dim, t_max=t_max,
                      seed=seed)
    return runbook_segment_plan(rb, max_t=max_t, device="cpu")


def _state0():
    return init_index_state(CFG, 2048, device="cpu")


@pytest.mark.parametrize("policy", ["ip", "fresh"])
def test_crash_recovery_bit_identical(tmp_path, policy):
    """Injected failures, one of them killing a save after its manifest
    and before the rename, recover to the uninterrupted run's state."""
    plan = _plan(n=400, t_max=16, max_t=2)
    ref, ref_results = tapi.run_segments(_state0(), CFG, plan,
                                         policy=policy)
    got, results, info = run_segments_supervised(
        CheckpointManager(tmp_path), _state0(), CFG, plan, policy=policy,
        checkpoint_every=3, fail_at={2: 1, 5: 2},
        crash_in_save={3: "manifest"})
    assert info["restarts"] == 4
    assert info["final_segment"] == len(plan.segments)
    assert_port_equal(ref, got, policy)
    for a, b in zip(ref_results, results):
        assert_port_equal(a, b, "results")


def test_crash_recovery_kill_between_leaves(tmp_path):
    plan = _plan(t_max=8, max_t=2)
    ref, _ = tapi.run_segments(_state0(), CFG, plan, policy="ip")
    got, _, info = run_segments_supervised(
        CheckpointManager(tmp_path), _state0(), CFG, plan, policy="ip",
        checkpoint_every=2, crash_in_save={2: "leaf:3"})
    assert info["restarts"] == 1
    assert_port_equal(ref, got, "leaf kill")


def test_supervised_no_failures_matches_plain_run(tmp_path):
    plan = _plan(t_max=8, max_t=2)
    ref, _ = tapi.run_segments(_state0(), CFG, plan, policy="ip")
    mgr = CheckpointManager(tmp_path)
    got, _, info = run_segments_supervised(mgr, _state0(), CFG, plan,
                                           policy="ip", checkpoint_every=4)
    assert info["restarts"] == 0
    assert_port_equal(ref, got, "no failures")
    step, st, _ = restore_index(mgr, CFG, device="cpu")
    assert step == len(plan.segments)
    assert_port_equal(ref, st, "cold restore")


def test_supervised_per_segment_budget(tmp_path):
    logs = []
    with pytest.raises(SimulatedFailure):
        run_segments_supervised(
            CheckpointManager(tmp_path), _state0(), CFG,
            _plan(t_max=8, max_t=2), policy="ip", checkpoint_every=2,
            max_restarts=50, max_restarts_per_step=2, fail_at={1: 99},
            log=logs.append)
    assert any("giving up" in s for s in logs)


# -- StreamingIndex.save / restore ----------------------------------------------


def _save_restore_round_trip(tmp_path, device):
    rng = np.random.default_rng(0)
    idx = TIndex(CFG, mode="ip", max_external_id=2048, device=device)
    ids = np.arange(120)
    idx.insert(ids, rng.normal(size=(120, CFG.dim)).astype(np.float32))
    idx.delete(ids[:30])
    q = rng.normal(size=(8, CFG.dim)).astype(np.float32)
    ref = idx.search(q, k=5)

    mgr = CheckpointManager(tmp_path)
    idx.save(mgr, 3)
    idx2, step = TIndex.restore(mgr, CFG, device=device)
    assert step == 3 and idx2.mode == "ip"
    assert idx2.device == idx.device
    assert idx2.max_external_id == idx.max_external_id
    assert idx2.counters == idx.counters
    assert_port_equal(idx.istate, idx2.istate, "restored")
    got = idx2.search(q, k=5)
    np.testing.assert_array_equal(ref[0], got[0])
    np.testing.assert_array_equal(ref[1], got[1])

    more = np.arange(200, 240)
    vecs = rng.normal(size=(40, CFG.dim)).astype(np.float32)
    idx.insert(more, vecs)
    idx2.insert(more, vecs)
    assert_port_equal(idx.istate, idx2.istate, "continued")
    with pytest.raises(CheckpointMismatchError, match="policy"):
        TIndex.restore(mgr, CFG, mode="fresh", device=device)


def test_streaming_index_save_restore(tmp_path):
    _save_restore_round_trip(tmp_path, "cpu")


@pytest.mark.requires_cuda
def test_streaming_index_save_restore_on_card(tmp_path, cuda_device):
    _save_restore_round_trip(tmp_path, None)
