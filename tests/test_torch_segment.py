"""Whole-segment update streams of the port (``repro_torch.core.api``:
``plan_segments``, ``apply_segment``, ``run_segments``) against the JAX
reference and against the port's own per-op loop, on the CPU.

  * ``plan_segments`` and ``runbook_segment_plan`` cut the same segments as
    the reference (counts, ``n_ops``, splits, padded T and stacked lanes),
    breaking on lane width, split, key and ``max_t``; ``auto_unroll`` has
    the reference's table;
  * ``run_segments`` from one start state, carried over with
    ``convert``, equals the reference's bitwise on grid data for ip, fresh
    and local, serial and batched, pad rows and mid-segment triggers
    included, and equals ``apply`` plus the policy's trigger op by op;
  * ``StreamingIndex.apply_segments`` books the reference's counters, and
    ``run_runbook(segmented=True)`` gives the reference's report and final
    state and refuses what the reference refuses;
  * on the card, the cuda engine's segments equal its per-op loop and the
    CPU's run (``python -m pytest --noconftest -m requires_cuda
    tests/test_torch_segment.py``: JAX is imported inside the CPU tests
    only, so the card-only test collects without it).

The reference runs with ``unroll=1``: a scheduling knob of its scan that
changes no result, and keeps its compiles short.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import assert_field, assert_index_equal, \
    assert_port_equal, cfg_pair, cuda_device, grid_data, \
    jax_index_state, small_kw  # noqa: F401

from repro_torch import convert
from repro_torch.core import StreamingIndex as TIndex
from repro_torch.core import api as tapi
from repro_torch.core import make_runbook as t_runbook
from repro_torch.core import run_runbook as t_run
from repro_torch.core import runbook as trunbook
from repro_torch.core.hnsw import HNSWConfig, HNSWIndex
from repro_torch.core.types import ANNConfig as TCfg
from repro_torch.core.types import init_index_state as t_init

DIM = 24
DATA = grid_data(420, DIM, 21)
SEG_FIELDS = ("slot", "ok", "n_comps", "consolidated", "needs_consolidation")
COUNTERS = ("n_inserts", "n_deletes", "insert_comps", "delete_comps",
            "n_consolidations")


def _tcfg(backend="torch"):
    """The port's config alone (``cfg_pair`` imports the reference)."""
    return TCfg(backend=backend, **small_kw())


def _stream(mod, policy, **kw):
    """Five ops whose deletes cross the consolidation threshold at the
    third op (ip, fresh, over 50 live points); local's mirrors its
    reference test (60 live).  B = 16: one segment of T = 8, three pad
    rows."""
    ins = lambda lo: mod.insert_batch(np.arange(lo, lo + 10),  # noqa: E731
                                      DATA[lo:lo + 10], **kw)
    dele = lambda lo: mod.delete_batch(np.arange(lo, lo + 10),  # noqa: E731
                                       DIM, **kw)
    if policy == "local":
        return [dele(0), ins(60), dele(10), dele(20), ins(70)]
    return [ins(50), dele(0), dele(10), dele(20), ins(60)]


@pytest.fixture(scope="module")
def start_state():
    """50 (ip, fresh) or 60 (local) serially inserted grid points, built
    by the port, in the ``convert`` numpy layout."""
    tcfg = _tcfg()
    out = {}
    for n0 in (50, 60):
        st = t_init(tcfg, 500, device="cpu")
        st, res = tapi.apply(st, tcfg, tapi.insert_batch(
            np.arange(n0), DATA[:n0], device="cpu"), sequential=True)
        assert res.ok[:n0].all()
        out[n0] = convert.index_state_to_numpy(st)
    return out


def _start(start_state, policy, device="cpu"):
    return convert.index_state_from_numpy(
        start_state[60 if policy == "local" else 50], device=device)


def _per_op_loop(state, cfg, steps, policy, sequential, splits=None):
    """``apply`` then the policy's trigger, op by op: device policies sweep
    at once, fresh records the flag and consolidates once at the end (where
    ``run_segments`` consolidates a one-segment plan)."""
    pol = tapi.get_policy(policy)
    results, flags = [], []
    for step, split in zip(steps, splits or [None] * len(steps)):
        state, res = tapi.apply(state, cfg, step, policy=policy,
                                sequential=sequential, split=split)
        results.append(res)
        if pol.device_consolidation:
            state, _ = tapi.consolidate_if_needed(state, cfg, policy=policy)
        else:
            flags.append(bool(pol.should_consolidate_device(cfg,
                                                            state.graph)))
    if any(flags):
        state = state._replace(graph=pol.consolidate(state.graph, cfg))
    return state, results


def _assert_rows_match(res, loop_results):
    for t, r in enumerate(loop_results):
        for f in ("slot", "ok", "n_comps"):
            assert torch.equal(getattr(res, f)[t], getattr(r, f)), (t, f)


def _assert_plans_equal(jplan, tplan):
    assert len(jplan.segments) == len(tplan.segments)
    assert jplan.n_ops == tplan.n_ops
    for js, ts in zip(jplan.segments, tplan.segments):
        assert (js.split, js.n_ops) == (ts.split, ts.n_ops)
        for f in js.ops._fields:
            assert_field(getattr(js.ops, f), getattr(ts.ops, f), f"ops.{f}")


# -- planning ----------------------------------------------------------------


def _steps(mod, widths, **kw):
    out, lo = [], 0
    for kind, w in widths:
        ids = np.arange(lo, lo + w)
        out.append(mod.insert_batch(ids, DATA[ids], **kw) if kind == "i"
                   else mod.delete_batch(ids, DIM, **kw))
        lo += w
    return out


PLAN_CASES = {
    # B = 4, 4, 16, 4: width changes break the segment
    "shapes": (dict(widths=[("i", 4), ("i", 4), ("i", 16), ("d", 4)]),
               [2, 1, 1]),
    "splits": (dict(widths=[("i", 4)] * 5, splits=[2, 2, None, 3, 3]),
               [2, 1, 2]),
    "keys": (dict(widths=[("i", 4)] * 5, keys=[0, 0, 1, 1, 0]), [2, 2, 1]),
    # 11 equal steps under max_t = 8: T = 8, then 3 real ops padded to 4
    "max_t": (dict(widths=[("d", 8)] * 11), [8, 3]),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_segments_matches_reference(case):
    from repro.core import api as japi

    kw, n_ops = PLAN_CASES[case]
    kw = dict(kw)
    widths = kw.pop("widths")
    jplan = japi.plan_segments(_steps(japi, widths), max_t=8, **kw)
    tplan = tapi.plan_segments(_steps(tapi, widths, device="cpu"), max_t=8,
                               **kw)
    _assert_plans_equal(jplan, tplan)
    assert [s.n_ops for s in tplan.segments] == n_ops
    for seg in tplan.segments:
        t = seg.ops.kind.shape[0]
        assert t & (t - 1) == 0 and not seg.ops.valid[seg.n_ops:].any()
    with pytest.raises(ValueError, match="one split per step"):
        tapi.plan_segments(_steps(tapi, widths, device="cpu"), splits=[1])


def test_runbook_segment_plan_matches_reference():
    from repro.core import make_runbook as j_runbook
    from repro.core import runbook as jrunbook

    jrb = j_runbook("sliding_window", n=240, dim=DIM, t_max=10, seed=4)
    trb = t_runbook("sliding_window", n=240, dim=DIM, t_max=10, seed=4)
    _assert_plans_equal(jrunbook.runbook_segment_plan(jrb, max_t=4),
                        trunbook.runbook_segment_plan(trb, max_t=4,
                                                      device="cpu"))


def test_auto_unroll_table():
    from repro.core import api as japi

    for t in (1, 2, 3, 4, 8, 16, 64):
        for b in (1, 4, 8, 16, 17, 64, 65, 256, 257, 512):
            assert tapi.auto_unroll(t, b) == japi.auto_unroll(t, b), (t, b)


# -- run_segments ------------------------------------------------------------


@pytest.mark.parametrize("sequential", [True, False])
@pytest.mark.parametrize("policy", ["ip", "fresh", "local"])
def test_run_segments_matches_reference(start_state, policy, sequential):
    from repro.core import api as japi

    jcfg, tcfg = cfg_pair(**small_kw())
    ts = _start(start_state, policy)
    js = jax_index_state(convert.index_state_to_numpy(ts))

    jplan = japi.plan_segments(_stream(japi, policy), max_t=8)
    tplan = tapi.plan_segments(_stream(tapi, policy, device="cpu"), max_t=8)
    _assert_plans_equal(jplan, tplan)
    assert len(tplan.segments) == 1 and tplan.n_ops == 5
    js, jres = japi.run_segments(js, jcfg, jplan, policy=policy,
                                 sequential=sequential, unroll=1)
    loop, loop_res = _per_op_loop(tapi.clone_state(ts), tcfg,
                                  _stream(tapi, policy, device="cpu"),
                                  policy, sequential)
    ts, tres = tapi.run_segments(ts, tcfg, tplan, policy=policy,
                                 sequential=sequential)

    assert_index_equal(js, ts, True, f"{policy} segments")
    assert_port_equal(loop, ts, f"{policy} per-op loop")
    res = tres[0]
    for f in SEG_FIELDS:
        assert_field(getattr(jres[0], f), getattr(res, f), f"result {f}")
    _assert_rows_match(res, loop_res)
    assert not res.ok[tplan.n_ops:].any(), "a pad row applied an op"
    if policy == "local":
        assert not res.consolidated.any()
        assert not res.needs_consolidation.any()
        assert int(ts.graph.n_pending) == 0
        return
    fired, other = ((res.consolidated, res.needs_consolidation)
                    if policy == "ip" else
                    (res.needs_consolidation, res.consolidated))
    fired = torch.nonzero(fired).flatten().tolist()
    assert not other.any()
    assert fired and fired[0] < tplan.n_ops - 1, (
        f"expected a mid-segment trigger, fired at {fired}")


@pytest.mark.parametrize("policy", ["ip", "fresh"])
def test_apply_segment_without_trigger(start_state, policy):
    """``consolidate=False`` drops the trigger: both flags stay False and
    the state is the plain ``apply`` loop's, nothing swept."""
    tcfg = _tcfg()
    st = _start(start_state, policy)
    steps = _stream(tapi, policy, device="cpu")
    ref = tapi.clone_state(st)
    for step in steps:
        ref, _ = tapi.apply(ref, tcfg, step, policy=policy)
    seg = tapi.plan_segments(steps, max_t=8).segments[0]
    st, res = tapi.apply_segment(st, tcfg, seg.ops, policy=policy,
                                 consolidate=False, unroll=4)
    assert_port_equal(ref, st, "no trigger")
    assert not res.consolidated.any() and not res.needs_consolidation.any()
    assert int(st.graph.n_pending) == 30


@pytest.mark.parametrize("sequential", [True, False])
def test_local_segment_matches_per_op_loop(start_state, sequential):
    """The twin of ``test_policy_local.py::test_segment_matches_per_op_loop``
    (port against port): the segment body is ``apply``'s, so the replay is
    bitwise, and local never owes consolidation."""
    from invariants import assert_graph_invariants

    jcfg, tcfg = cfg_pair(**small_kw())
    st = _start(start_state, "local")
    steps = _stream(tapi, "local", device="cpu")
    ref, ref_results = _per_op_loop(tapi.clone_state(st), tcfg, steps,
                                    "local", sequential)
    seg_st, seg_results = tapi.run_segments(
        st, tcfg, tapi.plan_segments(steps, max_t=8), policy="local",
        sequential=sequential)
    assert_port_equal(ref, seg_st, "local")
    res = seg_results[0]
    _assert_rows_match(res, ref_results)
    assert not res.consolidated.any() and not res.needs_consolidation.any()
    assert_graph_invariants(
        jax_index_state(convert.index_state_to_numpy(seg_st)), jcfg,
        policy="local", context="post-segment")


def test_mixed_kind_major_segment(start_state):
    """Kind-major mixed batches with one static split share a segment and
    replay bitwise against the per-op loop."""
    _, tcfg = cfg_pair(**small_kw())
    st = _start(start_state, "local")
    steps, splits = [], []
    for t in range(4):
        ins = np.arange(60 + 8 * t, 68 + 8 * t)
        dele = np.arange(12 * t, 12 * t + 10)
        b, split = tapi.mixed_update_batch(ins, DATA[ins], dele, DIM,
                                           device="cpu")
        steps.append(b)
        splits.append(split)
    ref, ref_results = _per_op_loop(tapi.clone_state(st), tcfg, steps, "ip",
                                    False, splits)
    plan = tapi.plan_segments(steps, splits=splits, max_t=8)
    assert len(plan.segments) == 1
    seg_st, res = tapi.run_segments(st, tcfg, plan, policy="ip")
    assert_port_equal(ref, seg_st, "mixed")
    _assert_rows_match(res[0], ref_results)


# -- StreamingIndex.apply_segments and run_runbook(segmented=True) ------------


@pytest.mark.parametrize("policy", ["ip", "fresh"])
def test_apply_segments_counters_match_reference(start_state, policy):
    from repro.core import StreamingIndex as JIndex
    from repro.core import api as japi

    jcfg, tcfg = cfg_pair(**small_kw())
    ji = JIndex(jcfg, mode=policy, max_external_id=500)
    ti = TIndex(tcfg, mode=policy, max_external_id=500, device="cpu")
    ti.istate = _start(start_state, policy)
    ji.istate = jax_index_state(convert.index_state_to_numpy(ti.istate))
    jres = ji.apply_segments(_stream(japi, policy), max_t=4, unroll=1)
    tres = ti.apply_segments(_stream(tapi, policy, device="cpu"), max_t=4)
    assert len(jres) == len(tres) == 2
    for f in COUNTERS:
        assert getattr(ji.counters, f) == getattr(ti.counters, f), f
    assert ti.counters.n_consolidations >= 1
    assert ti.counters.segment_s > 0.0
    assert_index_equal(ji.istate, ti.istate, True, "apply_segments")


def test_apply_segments_matches_per_op_shell():
    """ip: the segment shell equals the per-op insert / delete shell, whose
    trigger is the same predicate after every op."""
    _, tcfg = cfg_pair(**small_kw())
    per_op = TIndex(tcfg, mode="ip", max_external_id=640, device="cpu")
    seg = TIndex(tcfg, mode="ip", max_external_id=640, device="cpu")
    per_op.insert(np.arange(50), DATA[:50])
    seg.insert(np.arange(50), DATA[:50])
    for s in _stream(tapi, "ip", device="cpu"):
        ext = s.ext_id[s.valid].numpy()
        if (s.kind[s.valid] == 0).all():
            per_op.insert(ext, DATA[ext])
        else:
            per_op.delete(ext)
    seg.apply_segments(_stream(tapi, "ip", device="cpu"), max_t=8,
                       sequential=True)
    assert_port_equal(per_op.istate, seg.istate, "shells")
    for f in COUNTERS:
        assert getattr(seg.counters, f) == getattr(per_op.counters, f), f
    assert seg.counters.n_inserts == 70 and seg.counters.n_deletes == 30


def _grid_runbook(mk, n=160, t_max=8):
    """A sliding-window runbook (of either package's ``make_runbook``) on
    grid data."""
    rb = mk("sliding_window", n=n, dim=DIM, t_max=t_max, seed=5)
    return dataclasses.replace(rb, data=grid_data(n, DIM, 51),
                               queries=grid_data(16, DIM, 52))


def test_segmented_runbook_matches_reference():
    from repro.core import StreamingIndex as JIndex
    from repro.core import make_runbook as j_runbook
    from repro.core import run_runbook as j_run

    jcfg, tcfg = cfg_pair(**small_kw(n_cap=256))
    ji = JIndex(jcfg, mode="ip", max_external_id=160)
    ti = TIndex(tcfg, mode="ip", max_external_id=160, device="cpu")
    trb = _grid_runbook(t_runbook)
    jr = j_run(ji, _grid_runbook(j_runbook), eval_every=3, segmented=True,
               segment_t=4)
    tr = t_run(ti, trb, eval_every=3, segmented=True, segment_t=4)
    key = lambda m: (m.step, m.n_active, m.recall,  # noqa: E731
                     m.comps_per_query)
    assert [key(m) for m in jr.steps] == [key(m) for m in tr.steps]
    assert jr.avg_recall == tr.avg_recall >= 0.9
    for f in COUNTERS:
        assert getattr(jr.counters, f) == getattr(tr.counters, f), f
    assert tr.summary()["segment_s"] > 0.0
    assert_index_equal(ji.istate, ti.istate, True, "segmented runbook")

    # the port's per-op replay reaches the same evals, counters (seconds
    # aside) and final state
    oi = TIndex(tcfg, mode="ip", max_external_id=160, device="cpu")
    orep = t_run(oi, trb, eval_every=3)
    assert [key(m)[:3] for m in orep.steps] == [key(m)[:3] for m in tr.steps]
    for f in COUNTERS:
        assert getattr(orep.counters, f) == getattr(tr.counters, f), f
    assert_port_equal(oi.istate, ti.istate, "per-op runbook")


@pytest.mark.parametrize("guard", ["batch_updates", "hnsw"])
def test_segmented_runbook_guards(guard):
    _, tcfg = cfg_pair(**small_kw())
    trb = _grid_runbook(t_runbook, n=64, t_max=4)
    if guard == "hnsw":
        idx = HNSWIndex(HNSWConfig(dim=DIM, n_cap=128, m=4), device="cpu")
        with pytest.raises(ValueError, match="hnsw"):
            t_run(idx, trb, segmented=True, baseline="hnsw")
    else:
        idx = TIndex(tcfg, batch_updates=True, device="cpu")
        with pytest.raises(ValueError, match="batch_updates=False"):
            t_run(idx, trb, segmented=True)
    assert idx.n_active == 0


# -- on the card ---------------------------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("policy", ["ip", "fresh", "local"])
def test_segments_match_per_op_loop_on_card(cuda_device, start_state,
                                            policy):
    """The cuda engine's batched segments equal its own per-op loop and
    the CPU's plain run, bitwise (states and result rows)."""
    runs = {}
    for dev, backend in ((cuda_device, "cuda"), ("cpu", "torch")):
        cfg = _tcfg(backend)
        st = _start(start_state, policy, dev)
        steps = _stream(tapi, policy, device=dev)
        loop, loop_res = _per_op_loop(tapi.clone_state(st), cfg, steps,
                                      policy, False)
        st, res = tapi.run_segments(st, cfg,
                                    tapi.plan_segments(steps, max_t=8),
                                    policy=policy)
        assert_port_equal(loop, st, f"{dev} per-op loop")
        _assert_rows_match(res[0], loop_res)
        runs[backend] = (st, res[0])
    assert_port_equal(runs["cuda"][0], runs["torch"][0], "card vs cpu")
    assert_port_equal(runs["cuda"][1], runs["torch"][1], "rows")
