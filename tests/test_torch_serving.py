"""The port's serving front door (``repro_torch.serving``) against the
reference (``repro.serving``), on the CPU.

  * the batcher, the snapshot store, ``percentile`` and ``ServingMetrics``
    hold the reference's unit contracts (``tests/test_serving.py``), and a
    fixed arrival trace gives the reference's dispatch groups, buckets,
    reasons and ``formed_t``; the same records give the reference's
    ``stats()``;
  * ``take_snapshot`` isolates at the leaf level: after a snapshot, an
    ``apply`` (and a consolidation) on the live state leaves every leaf of
    the snapshot bitwise unchanged and shares no storage with it, f32 and
    int8;
  * one trace through the reference's ``ServingFront(StreamingEngine(...))``
    and the port's, from one JAX-built state, for ``ip``, ``fresh`` and
    ``local``: identical dispatch groups, completion times, snapshot seqs,
    answers (distances bitwise on grid data) and ``stats()``;
  * snapshot isolation and read-your-writes for the three policies, the
    port's answers equal to the reference's at each step; the
    ``serialize_updates`` lane contrast;
  * ``ShardedEngine`` over two logical rows: the same isolation checks,
    every answer and the writer's rows equal to the reference's sharded
    engine on a 1-device mesh, and a clone that shares no storage.
"""
import numpy as np
import pytest
import torch

from torch_parity import assert_index_equal, grid_data, jax_index_numpy, \
    jax_index_state, qgrid_data, small_kw

import repro_torch.serving as tserving
from repro_torch import convert
from repro_torch.configs import test_scale as t_test_scale
from repro_torch.core import StreamingIndex as TIndex
from repro_torch.core import apply, init_index_state, maybe_consolidate
from repro_torch.core import delete_batch as t_delete_batch
from repro_torch.core import insert_batch as t_insert_batch
from repro_torch.core import take_snapshot
from repro_torch.core.types import ANNConfig
from repro_torch.serving import (DynamicBatcher, ServingFront, ServingMetrics,
                                 SnapshotStore, StreamingEngine,
                                 group_vectors, percentile)

DIM = 8
N0 = 96
MAX_EXT = 2048
POLICIES = ("ip", "fresh", "local")


# ---------------------------------------------------------------------------
# DynamicBatcher
# ---------------------------------------------------------------------------


def test_batcher_dispatches_full_bucket_immediately():
    b = DynamicBatcher(deadline_s=10.0, max_bucket=4)
    for i in range(4):
        b.submit(np.zeros(8), now=float(i))
        if i < 3:
            assert b.take(float(i)) is None     # deadline far, not full
    d = b.take(3.0)
    assert d is not None and d.reason == "full"
    assert d.bucket == 4 and len(d.requests) == 4
    assert [r.req_id for r in d.requests] == [0, 1, 2, 3]
    assert len(b) == 0


def test_batcher_deadline_flushes_partial_padded_to_bucket():
    b = DynamicBatcher(deadline_s=0.005, max_bucket=8)
    b.submit(np.zeros(4), now=0.0)
    b.submit(np.ones(4), now=0.001)
    assert not b.ready(0.004)
    assert b.take(0.004) is None                # oldest deadline is 0.005
    assert b.next_deadline() == pytest.approx(0.005)
    assert b.ready(0.005)
    d = b.take(0.006)
    assert d.reason == "deadline"
    assert len(d.requests) == 2 and d.bucket == 2   # next_bucket(2), not 8
    assert d.fill == pytest.approx(1.0)
    q = group_vectors(d, 4)
    assert q.shape == (2, 4) and q.dtype == np.float32
    np.testing.assert_array_equal(q[1], np.ones(4, np.float32))


@pytest.mark.parametrize("kw", [dict(max_bucket=6), dict(max_bucket=0),
                                dict(deadline_s=-1.0)])
def test_batcher_rejects_bad_knobs(kw):
    with pytest.raises(ValueError):
        DynamicBatcher(**kw)


def test_batcher_never_exceeds_max_bucket():
    b = DynamicBatcher(deadline_s=0.0, max_bucket=2)
    for _ in range(5):
        b.submit(np.zeros(2), now=0.0)
    groups = b.drain(1.0)
    assert [len(g.requests) for g in groups] == [2, 2, 1]
    assert all(g.bucket <= 2 for g in groups)
    assert [g.reason for g in groups] == ["full", "full", "drain"]


def _batcher_trace(pkg, arrivals):
    b = pkg.DynamicBatcher(deadline_s=0.005, max_bucket=8)
    out = []
    for t in arrivals:
        while b.next_deadline() is not None and b.next_deadline() <= t:
            d = b.take(b.next_deadline())
            if d is None:
                break
            out.append(d)
        b.submit(np.zeros(4), now=float(t))
        d = b.take(float(t))
        if d is not None:
            out.append(d)
    out.extend(b.drain(float(arrivals[-1]) + 1.0))
    return [([r.req_id for r in d.requests], d.bucket, d.reason, d.formed_t)
            for d in out]


def test_batcher_fixed_trace_matches_reference():
    import repro.serving as jserving

    arrivals = np.cumsum(np.random.default_rng(7).exponential(0.0008, 64))
    port = _batcher_trace(tserving, arrivals)
    assert port == _batcher_trace(tserving, arrivals)     # replays
    assert port == _batcher_trace(jserving, arrivals)     # the reference's
    assert sum(len(g[0]) for g in port) == 64
    assert {g[2] for g in port} >= {"full", "deadline"}


# ---------------------------------------------------------------------------
# SnapshotStore, percentile, ServingMetrics
# ---------------------------------------------------------------------------


class _Handle:
    def __init__(self, seq, state):
        self.seq, self.state = seq, state


def _counting_store():
    return SnapshotStore({"v": np.arange(4)},
                         clone=lambda st, seq: _Handle(seq, dict(st)))


def test_snapshot_store_seq_and_slot_alternation():
    st = _counting_store()
    assert st.seq == 0 and st.active_slot == 0
    st.publish({"v": np.arange(4) + 1})
    assert st.seq == 1 and st.active_slot == 1
    st.publish({"v": np.arange(4) + 2})
    assert st.seq == 2 and st.active_slot == 0      # strict double buffer
    assert st.n_publishes == 2
    assert st.acquire().state["v"][0] == 2


def test_snapshot_store_held_reader_survives_one_publish_only():
    st = _counting_store()
    h = st.acquire()
    assert h.seq == 0
    st.publish({"v": np.zeros(4)})                  # writes the OTHER slot
    assert h.state["v"][1] == 1                     # reader untouched
    with pytest.raises(RuntimeError, match="in flight"):
        st.publish({"v": np.zeros(4)})              # would overwrite h
    assert st.seq == 1                              # the refusal changed nothing
    st.release(h)
    st.publish({"v": np.zeros(4)})
    assert st.seq == 2


@pytest.mark.parametrize("seq,match", [(0, "no reader"),
                                       (99, "no longer buffered")])
def test_snapshot_store_release_validation(seq, match):
    st = _counting_store()
    with pytest.raises(RuntimeError, match=match):
        st.release(_Handle(seq, {}))


@pytest.mark.parametrize("xs,q", [([], 99), ([1.0, 2.0, 3.0], 50),
                                  ([3.0, 1.0, 2.0, 10.0], 99),
                                  ([0.5], 95)])
def test_percentile_matches_reference(xs, q):
    from repro.serving import percentile as j_percentile

    got, want = percentile(xs, q), j_percentile(xs, q)
    assert (np.isnan(got) and np.isnan(want)) or got == want


def test_percentile_contract():
    assert np.isnan(percentile([], 99))
    assert percentile([1.0, 2.0, 3.0], 50) == pytest.approx(2.0)


def test_metrics_stats_match_reference():
    """The same records booked into both packages' ``ServingMetrics`` give
    equal ``stats()`` dicts (and log lines), empty and full."""
    from repro.serving import DynamicBatcher as JBatcher
    from repro.serving import ServingMetrics as JMetrics

    tm, jm = ServingMetrics(), JMetrics()
    assert tm.stats().keys() == jm.stats().keys()
    for b_cls, m in ((DynamicBatcher, tm), (JBatcher, jm)):
        b = b_cls(deadline_s=0.0, max_bucket=4)
        r = np.random.default_rng(5)
        for i in range(10):
            for _ in range(int(r.integers(1, 5))):
                b.submit(np.zeros(2), now=float(i))
            d = b.take(float(i) + 0.001)
            for req in d.requests:
                req.dispatch_t = d.formed_t
                req.complete_t = d.formed_t + float(r.exponential(0.003))
            m.record_dispatch(d, float(r.exponential(0.002)), len(b))
            m.record_update(int(r.integers(0, 9)), float(r.exponential(0.01)))
            m.record_publish(float(r.exponential(0.001)))
    for horizon in (None, 2.5):
        assert tm.stats(horizon) == jm.stats(horizon)
        assert tm.log_line(horizon) == jm.log_line(horizon)


# ---------------------------------------------------------------------------
# take_snapshot: isolation at the leaf level
# ---------------------------------------------------------------------------


def _leaves(tree, path="state"):
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if tree is None:
        return []
    out = []
    for f, x in zip(tree._fields, tree):
        out += _leaves(x, f"{path}.{f}")
    return out


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("quantized", [False, True])
def test_take_snapshot_isolates_every_leaf(quantized, policy):
    cfg = ANNConfig(**small_kw(dim=16, n_cap=128), quantized=quantized,
                    backend="torch")
    data = (qgrid_data if quantized else grid_data)(120, 16, 4)
    st = init_index_state(cfg, 256, device="cpu")
    st, res = apply(st, cfg, t_insert_batch(np.arange(80), data[:80],
                                            device="cpu"), sequential=True)
    assert bool(res.ok[:80].all())
    snap = take_snapshot(st, 7)
    assert snap.seq == 7
    before = {p: x.clone() for p, x in _leaves(snap.state)}
    live = {p: x for p, x in _leaves(st)}
    assert before.keys() == live.keys()
    assert quantized == any(".quant." in p for p in before)
    for p, x in _leaves(snap.state):
        assert x.untyped_storage().data_ptr() != \
            live[p].untyped_storage().data_ptr(), f"{p} shares storage"
        assert torch.equal(x, live[p]), p

    # the writer moves on: inserts, deletes past the trigger, consolidation
    st, res = apply(st, cfg, t_insert_batch(np.arange(80, 120), data[80:120],
                                            device="cpu"), policy=policy)
    st, _ = apply(st, cfg, t_delete_batch(np.arange(40), 16, device="cpu"),
                  policy=policy)
    st, did = maybe_consolidate(st, cfg, policy=policy, force=True)
    changed = [p for p, x in _leaves(st) if not torch.equal(x, before[p])]
    assert {"state.ext2slot", "state.slot2ext", "state.n_inserts",
            "state.n_deletes", "state.graph.adj"} <= set(changed)
    if quantized:
        assert "state.graph.quant.codes" in changed
    for p, x in _leaves(snap.state):
        assert torch.equal(x, before[p]), f"snapshot leaf {p} changed"


# ---------------------------------------------------------------------------
# ServingFront against the reference, one JAX-built start state
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def start_state():
    """96 grid points inserted serially by the reference, in the
    ``repro_torch.convert`` numpy layout, and the data."""
    from repro.configs.ann import test_scale as j_test_scale
    from repro.core import StreamingIndex as JIndex

    data = grid_data(N0, DIM, 0)
    idx = JIndex(j_test_scale(DIM, 256, backend="jnp"),
                 max_external_id=MAX_EXT)
    idx.insert(np.arange(N0), data)
    return jax_index_numpy(idx.istate), data


def _pair(start_state, mode):
    """The reference's and the port's ``StreamingIndex`` on one state."""
    from repro.configs.ann import test_scale as j_test_scale
    from repro.core import StreamingIndex as JIndex

    d, _ = start_state
    ji = JIndex(j_test_scale(DIM, 256, backend="jnp"), mode=mode,
                max_external_id=MAX_EXT)
    ji.istate = jax_index_state(d)
    ti = TIndex(t_test_scale(DIM, 256, backend="torch"), mode=mode,
                max_external_id=MAX_EXT, device="cpu")
    ti.istate = convert.index_state_from_numpy(d, device="cpu")
    return ji, ti


def _batches(pkg):
    """``(insert_batch, delete_batch)`` of a package, on the CPU."""
    if pkg == "jax":
        from repro.core import delete_batch, insert_batch

        return insert_batch, delete_batch
    return (lambda ids, v: t_insert_batch(ids, v, device="cpu"),
            lambda ids, dim: t_delete_batch(ids, dim, device="cpu"))


def _replay(front, batches, vectors):
    """The reference test's fixed trace (``tests/test_serving.py``,
    ``test_front_fixed_trace_with_service_model_is_deterministic``), plus a
    delete of a quarter of the live set that fires each policy's
    consolidation trigger inside ``apply_update``."""
    ins, dele = batches
    arrivals = np.cumsum(np.random.default_rng(3).exponential(0.001, 24))
    for i, t in enumerate(arrivals):
        nd = front.next_event_time()
        while nd is not None and nd <= t:
            front.pump(nd)
            nd = front.next_event_time()
        front.submit_query(vectors[i], float(t))
        if i == 10:
            front.submit_update(ins([700], vectors[:1]), float(t))
        if i == 16:
            front.submit_update(dele(np.arange(24), DIM), float(t))
        front.pump(float(t))
    front.drain(float(arrivals[-1]) + 1.0)
    groups = [([r.req_id for r in d.requests], d.bucket, d.reason, d.formed_t,
               tuple(r.dispatch_t for r in d.requests),
               tuple(r.complete_t for r in d.requests),
               tuple(r.snapshot_seq for r in d.requests))
              for d in front.completed]
    answers = [(r.ext_ids, r.dists) for d in front.completed
               for r in d.requests]
    return groups, answers, front.metrics.stats(horizon_s=1.0)


@pytest.mark.parametrize("mode", POLICIES)
def test_front_trace_matches_reference(start_state, mode):
    import repro.serving as jserving

    model = {"search": 0.002, "update": 0.004, "publish": 0.001}
    vectors = grid_data(24, DIM, 3)
    ji, ti = _pair(start_state, mode)
    out = {}
    for pkg, mod, idx in (("jax", jserving, ji), ("torch", tserving, ti)):
        front = mod.ServingFront(
            mod.StreamingEngine(idx), deadline_s=0.003, max_bucket=8, k=3,
            service_model=lambda kind, bucket: model[kind])
        out[pkg] = _replay(front, _batches(pkg), vectors)
        assert front.metrics.n_updates == 2
    (jg, ja, js), (tg, ta, ts) = out["jax"], out["torch"]
    assert tg == jg
    assert {g[2] for g in tg} >= {"full", "deadline", "drain"}
    assert max(max(g[6]) for g in tg) == 2       # both publishes served
    assert len(ta) == len(ja) == 24
    for i, ((te, td), (je, jd)) in enumerate(zip(ta, ja)):
        assert te.dtype == np.int32 and td.dtype == np.float32
        np.testing.assert_array_equal(te, np.asarray(je), err_msg=f"req {i}")
        np.testing.assert_array_equal(td, np.asarray(jd), err_msg=f"req {i}")
    assert ts == js
    # the writers end equal, and the policy's trigger fired in both
    assert_index_equal(ji.istate, ti.istate, where=mode)
    assert ti.counters.n_consolidations == ji.counters.n_consolidations
    assert ti.counters.n_consolidations == (0 if mode == "local" else 1)


@pytest.mark.parametrize("mode", POLICIES)
def test_snapshot_isolation_and_read_your_writes(start_state, mode):
    """The reference's contract (``tests/test_serving.py``) on the port,
    with each served answer equal to the reference's.  Queries sit 1/64
    from live points (a grid offset, so every distance stays exact)."""
    import repro.serving as jserving

    _, data = start_state
    queries = data[:8] + np.float32(1 / 64)
    ji, ti = _pair(start_state, mode)
    fronts = {pkg: mod.ServingFront(mod.StreamingEngine(idx), deadline_s=0.0,
                                    max_bucket=8, k=5, publish_every=10**9)
              for pkg, mod, idx in (("jax", jserving, ji),
                                    ("torch", tserving, ti))}

    def serve(now):
        out = {}
        for pkg, front in fronts.items():
            reqs = [front.submit_query(q, now) for q in queries]
            front.pump(now + 1.0)   # deadline 0: everything flushes
            out[pkg] = reqs
        for rj, rt in zip(out["jax"], out["torch"]):
            assert rt.snapshot_seq == rj.snapshot_seq
            np.testing.assert_array_equal(rt.ext_ids, np.asarray(rj.ext_ids))
            np.testing.assert_array_equal(rt.dists, np.asarray(rj.dists))
        return out["torch"]

    before = serve(0.0)
    assert all(r.snapshot_seq == 0 for r in before)
    top1 = np.unique([r.ext_ids[0] for r in before])
    new_ids = 1000 + np.arange(8)
    for pkg, front in fronts.items():
        ins, dele = _batches(pkg)
        front.submit_update(ins(new_ids, queries), 1.0)
        front.submit_update(dele(top1, DIM), 1.0)
        front.pump(2.0)             # applied to the LIVE handle
        assert front.metrics.n_updates == 2
        front.engine.idx.maybe_consolidate(force=True)
    assert ti.n_active == ji.n_active

    # isolation: snapshot 0's answers, bit for bit
    after = serve(3.0)
    for r0, r1 in zip(before, after):
        assert r1.snapshot_seq == 0
        np.testing.assert_array_equal(r0.ext_ids, r1.ext_ids)
        np.testing.assert_array_equal(r0.dists, r1.dists)

    # read-your-writes: one publish, and a fresh acquire sees all of it
    for front in fronts.values():
        front.publish(4.0)
    final = serve(5.0)
    for i, r in enumerate(final):
        assert r.snapshot_seq == 1
        assert r.ext_ids[0] == new_ids[i] and r.dists[0] == 0.0
        assert not set(top1.tolist()) & set(r.ext_ids.tolist())
    assert_index_equal(ji.istate, ti.istate, where=mode)


@pytest.mark.parametrize("serialize,want", [(False, 0.001), (True, 0.050)])
def test_serialize_updates_queues_reads_behind_writes(start_state, serialize,
                                                      want):
    """With one shared lane a search arriving while an update occupies the
    engine waits; with snapshot isolation it does not."""
    _, data = start_state
    _, ti = _pair(start_state, "ip")
    model = {"search": 0.001, "update": 0.050, "publish": 0.0}
    front = ServingFront(StreamingEngine(ti), deadline_s=0.0, max_bucket=4,
                         k=3, serialize_updates=serialize,
                         service_model=lambda kind, bucket: model[kind])
    front.submit_update(t_insert_batch([600], data[:1], device="cpu"), 0.0)
    req = front.submit_query(data[0], 0.001)
    front.pump(0.001)
    assert req.latency_s == pytest.approx(want, abs=0.002)
    assert ti.n_active == N0 + 1


def test_front_warmup_stays_on_the_index_device(start_state):
    """``warmup`` runs every search bucket and a no-op update batch on the
    engine's device (a CPU index never touches the card) and books
    nothing."""
    _, ti = _pair(start_state, "ip")
    d0 = convert.index_state_to_numpy(ti.istate)
    front = ServingFront(StreamingEngine(ti), max_bucket=8)
    front.warmup(update_buckets=[3])
    assert front.metrics.stats()["n_dispatches"] == 0
    assert front.metrics.n_updates == 0 and front.store.seq == 0
    assert front.engine.device == torch.device("cpu")
    d1 = convert.index_state_to_numpy(ti.istate)
    for f in ("ext2slot", "slot2ext", "n_inserts", "n_deletes"):
        np.testing.assert_array_equal(d0[f], d1[f])
    assert ti.counters.n_inserts == 0


# ---------------------------------------------------------------------------
# The sharded engine behind the same front door
# ---------------------------------------------------------------------------


def _sharded_isolation(front, idx, insert, queries, new_ids):
    """``tests/test_serving.py``'s sharded case: snapshot 0 answers stay
    put under the writer, the publish brings the new ids to top-1."""
    def serve(now):
        reqs = [front.submit_query(q, now) for q in queries]
        front.pump(now + 1.0)
        return reqs

    before = serve(0.0)
    front.submit_update(insert(new_ids, queries), 1.0)
    front.pump(2.0)
    after = serve(3.0)
    for r0, r1 in zip(before, after):
        assert r0.snapshot_seq == r1.snapshot_seq == 0
        np.testing.assert_array_equal(r0.ext_ids, r1.ext_ids)
        np.testing.assert_array_equal(r0.dists, r1.dists)
    front.publish(4.0)
    final = serve(5.0)
    for i, r in enumerate(final):
        assert r.snapshot_seq == 1
        assert r.ext_ids[0] == new_ids[i]
    return [(r.ext_ids, r.dists) for r in before + after + final]


def test_sharded_engine_matches_reference():
    """``ServingFront(ShardedEngine(...))`` over L = 2 rows: snapshot
    isolation and read-your-writes, every answer equal to the reference's
    engine on a 1-device mesh with ``n_logical=2`` (grid data, bitwise),
    the live rows equal after the writer, and ``search_state`` over a
    snapshot equal to the live search."""
    import jax

    from repro.configs.ann import test_scale as j_test_scale
    from repro.core import insert_batch as j_insert_batch
    from repro.core.distributed import ShardedIndex as JShard
    from repro.serving import ServingFront as JFront
    from repro.serving import ShardedEngine as JEngine
    from repro_torch.core import ShardedIndex as TShard

    data = grid_data(N0, DIM, 1)
    queries = data[:4] + np.float32(0.0625)
    new_ids = 1000 + np.arange(4)
    jidx = JShard(j_test_scale(DIM, 256), jax.make_mesh((1,), ("shard",)),
                  n_logical=2, max_external_id=MAX_EXT)
    tidx = TShard(t_test_scale(DIM, 256, backend="torch"), ["cpu"],
                  n_logical=2, max_external_id=MAX_EXT)
    answers = []
    for idx, front_cls, engine_cls, insert in (
            (jidx, JFront, JEngine, j_insert_batch),
            (tidx, ServingFront, tserving.ShardedEngine,
             lambda ids, v: t_insert_batch(ids, v, device="cpu"))):
        idx.insert(np.arange(N0), data)
        front = front_cls(engine_cls(idx), deadline_s=0.0, max_bucket=4,
                          k=3, publish_every=10**9)
        answers.append(_sharded_isolation(front, idx, insert, queries,
                                          new_ids))
    for (je, jd), (te, td) in zip(*answers):
        np.testing.assert_array_equal(je, te)
        np.testing.assert_array_equal(jd, td)
    assert_index_equal(jidx.states, tidx.states, where="sharded writer")
    snap = tidx.snapshot_states()
    live = tidx.search(queries, k=3)
    held = tidx.search_state(snap, queries, k=3)
    np.testing.assert_array_equal(live[0], held[0])
    np.testing.assert_array_equal(live[2], held[2])


def test_sharded_engine_clone_and_warmup_stay_on_the_rows():
    """The engine's snapshot deep-copies every row (no shared storage),
    ``warmup`` books nothing, and the engine reports the layout's first
    device."""
    from repro_torch.core import ShardedIndex as TShard

    data = grid_data(64, DIM, 2)
    idx = TShard(t_test_scale(DIM, 256, backend="torch"), ["cpu"] * 2,
                 n_logical=4, max_external_id=MAX_EXT)
    idx.insert(np.arange(64), data)
    eng = tserving.ShardedEngine(idx)
    snap = eng.clone(eng.live_state(), 3)
    assert snap.seq == 3 and len(snap.state) == 4
    for live, held in zip(idx.rows, snap.state):
        assert live.graph.vectors.data_ptr() != held.graph.vectors.data_ptr()
        assert live.ext2slot.data_ptr() != held.ext2slot.data_ptr()
    front = ServingFront(eng, max_bucket=4)
    front.warmup(update_buckets=[3])
    assert front.metrics.n_updates == 0 and front.store.seq == 0
    assert eng.device == torch.device("cpu") and idx.n_active == 64
