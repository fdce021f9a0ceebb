"""The port's sharded index (``repro_torch.core.distributed``) against the
reference's (``repro.core.distributed``), on the CPU.

The reference guarantees bit-identical states and answers for any layout
S that divides the logical row count L, so the port at S in {1, 2, 4}
(``devices=["cpu"] * S``, L = 4) is held against the reference
``ShardedIndex`` on a 1-device JAX mesh with ``n_logical=4`` (G = 4): no
subprocess, no ``XLA_FLAGS``.  Grid-valued data makes every comparison
bitwise:

  * ``route``, ``as_int_payload``, ``compact_owner_batch`` /
    ``compact_owner_segment`` (the cases of ``tests/test_distributed.py``)
    and ``merge_topk`` with planted ties;
  * ``insert`` / ``delete`` / the unknown-id ``KeyError`` / capacity
    growth in lockstep: every stacked leaf and per-lane slot equal;
  * both search partitions: ids, owner rows, distances and comps equal;
  * ``update_stream``: stacked leaves and per-lane ``ok`` / ``slot`` in
    caller order equal for ip (serial and batched) and local, replicate
    routing equal to compact, and the ``segment_pack`` counts of the
    owner-aware planning;
  * checkpoints cross-restore both ways, with an elastic reshard 4 -> 2 ->
    1, and the typed errors;
  * the int8 tier's sharded search;
  * sharded ``fresh``: each row equal to the single-device reference's
    ``apply_segment`` + ``fresh_consolidate`` over that row's owned lanes
    (the reference's own sharded fresh path fails on this JAX version),
    and the boundary consolidation checks of ``tests/test_segment.py``.

The card case (``python -m pytest --noconftest -m requires_cuda
tests/test_torch_distributed.py``) holds a two-entry layout of the card
against the CPU; JAX is imported inside the CPU tests only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import assert_index_equal, assert_port_equal, \
    cuda_device, grid_data, qgrid_data  # noqa: F401

from repro_torch.checkpoint import CheckpointManager, CheckpointMismatchError
from repro_torch.configs import test_scale as t_test_scale
from repro_torch.core import ShardedIndex as TShard
from repro_torch.core import StreamingIndex as TIndex
from repro_torch.core import as_int_payload, clone_state, \
    compact_owner_batch, compact_owner_segment, consolidate_stacked, \
    delete_batch, fresh_consolidate, insert_batch, make_update_batch, \
    stack_update_batches, unstack_state
from repro_torch.core import distributed as tdist
from repro_torch.core.search_batched import merge_topk, next_bucket

L = 4
LAYOUTS = (1, 2, 4)
DIM = 16
MAX_EXT = 1024


def _cfgs(n_cap, dim=DIM, **kw):
    """The reference's and the port's ``test_scale`` config (the port on
    its plain engine)."""
    from repro.configs.ann import test_scale as j_test_scale

    jc = dataclasses.replace(j_test_scale(dim, n_cap), **kw)
    tc = dataclasses.replace(t_test_scale(dim, n_cap, backend="torch"), **kw)
    return jc, tc


def _mesh():
    import jax

    return jax.make_mesh((1,), ("shard",))


def _ref(jc, **kw):
    """The reference ``ShardedIndex`` on a 1-device mesh with L rows.  Its
    growth runs the reference's own ``ensure_capacity`` on a host copy of
    the stack: on this JAX version growing the mesh-sharded stack fails
    inside ``jnp.concatenate`` (the explicit-sharding check), which is no
    IP-DiskANN semantic."""
    import jax

    from repro.core.distributed import ShardedIndex as JShard
    from repro.core.grow import ensure_capacity

    class RefShard(JShard):
        def _ensure_capacity(self, max_owned):
            if not self.auto_grow:
                return False
            states, cfg, grew = ensure_capacity(
                jax.device_get(self.states), self.cfg, max_owned)
            if grew:
                self.states = jax.device_put(states, self._shard_spec)
                self.cfg = cfg
                self._build_programs()
            return grew

    kw.setdefault("max_external_id", MAX_EXT)
    return RefShard(jc, _mesh(), n_logical=L, **kw)


def _port(tc, s, **kw):
    return TShard(tc, ["cpu"] * s, n_logical=L,
                  max_external_id=kw.pop("max_external_id", MAX_EXT), **kw)


def _assert_search_equal(a, b, where):
    for name, x, y in zip(("ids", "shards", "dists"), a[:3], b[:3]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{where} {name}")
    assert int(a[3]) == int(b[3]), f"{where} comps"


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_logical", [1, 2, 3, 4, 8])
def test_route_matches_reference(n_logical):
    from repro.core.distributed import ShardedIndex as JShard

    class Fake:
        n_shards = n_logical

    ids = np.concatenate([np.arange(5000), [2**24 + 1, 2**24 + 3,
                                            2**30 + 7, 2**31 - 1]])
    idx = TShard.__new__(TShard)
    idx.n_logical = n_logical
    got = idx.route(ids)
    np.testing.assert_array_equal(got, JShard.route(Fake, ids))
    assert got.dtype == np.int32
    counts = np.bincount(got[:5000], minlength=n_logical)
    assert counts.min() > 0.7 * counts.mean()


def test_as_int_payload_is_lossless():
    big = np.asarray([2**24 + 1, 2**24 + 3, 2**30 + 7])
    assert int(np.float32(big[0])) != int(big[0])
    out = as_int_payload(big, "cpu")
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), big)
    with pytest.raises(OverflowError):
        as_int_payload(np.asarray([2**31]), "cpu")


def _fields_equal(j, t, where=""):
    for f, a, b in zip(j._fields, j, t):
        np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy(),
                                      err_msg=f"{where} {f}")


def test_compact_owner_batch_matches_reference():
    import repro.core as jcore

    rng = np.random.default_rng(0)
    b, dim, n_shards = 11, 4, 3
    kind = rng.integers(0, 2, size=b)
    vec = rng.normal(size=(b, dim)).astype(np.float32)
    valid = np.asarray([True] * 9 + [False] * 2)
    owners = np.asarray([0, 1, 2, 0, 1, 2, 0, 0, 1, 2, 2])
    jb = jcore.make_update_batch(kind=kind, ext_ids=np.arange(100, 100 + b),
                                 vectors=vec, valid=valid)
    tb = make_update_batch(kind, np.arange(100, 100 + b), vec, valid=valid,
                           device="cpu")
    js, jpos, jbucket = jcore.compact_owner_batch(jb, owners, n_shards)
    ts, tpos, tbucket = compact_owner_batch(tb, owners, n_shards,
                                            device="cpu")
    assert tbucket == jbucket == 4
    assert ts.kind.shape == (n_shards, 4) and ts.vector.shape == (3, 4, dim)
    _fields_equal(js, ts, "batch")
    np.testing.assert_array_equal(tpos, jpos)
    assert (tpos[~valid] == -1).all()
    for s in range(n_shards):
        idx = np.nonzero((owners == s) & valid)[0]
        np.testing.assert_array_equal(ts.ext_id[s, :len(idx)].numpy(),
                                      100 + idx)
        assert not ts.valid[s, len(idx):].any()
    with pytest.raises(ValueError, match="bucket"):
        compact_owner_batch(tb, owners, n_shards, bucket=2, device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        compact_owner_batch(tb, owners, 2, device="cpu")


def test_compact_owner_segment_matches_reference():
    import repro.core as jcore

    rng = np.random.default_rng(1)
    t_steps, b, dim, n_shards = 3, 8, 4, 2
    vecs = [rng.normal(size=(b, dim)).astype(np.float32)
            for _ in range(t_steps)]
    ids = [np.arange(t * b, t * b + b) for t in range(t_steps)]
    jops = jcore.stack_update_batches(
        [jcore.insert_batch(i, v) for i, v in zip(ids, vecs)])
    tops = stack_update_batches(
        [insert_batch(i, v, device="cpu") for i, v in zip(ids, vecs)])
    owners = rng.integers(0, n_shards, size=(t_steps, b)).astype(np.int32)
    owners[1] = 1     # one op fully on shard 1: the common bucket covers it
    js, jpos, jbucket = jcore.compact_owner_segment(jops, owners, n_shards)
    ts, tpos, tbucket = compact_owner_segment(tops, owners, n_shards,
                                              device="cpu")
    assert tbucket == jbucket == next_bucket(b)
    assert ts.kind.shape == (n_shards, t_steps, tbucket)
    _fields_equal(js, ts, "segment")
    np.testing.assert_array_equal(tpos, jpos)


def test_merge_topk_planted_ties():
    """Duplicate distances across and inside chunks: the port's merges
    (incremental ``merge_topk`` and the flat stable sort of the replicate
    search) pick the reference's ids, ties to the lower position."""
    import jax.numpy as jnp

    from repro.core.search_batched import merge_topk as j_merge
    from repro_torch.kernels.ref import stable_topk_smallest

    rng = np.random.default_rng(2)
    q, k, chunks = 6, 8, 4
    d = rng.integers(0, 6, size=(q, chunks * k)).astype(np.float32)
    d[:, ::5] = np.float32(3.0)                    # planted ties
    ids = np.arange(q * chunks * k, dtype=np.int32).reshape(q, chunks * k)
    jd = jnp.full((q, k), np.inf, jnp.float32)
    ji = jnp.full((q, k), -1, jnp.int32)
    td = torch.full((q, k), float("inf"))
    ti = torch.full((q, k), -1, dtype=torch.int32)
    for c in range(chunks):
        sl = slice(c * k, (c + 1) * k)
        jd, (ji,) = j_merge(jd, jnp.asarray(d[:, sl]), k,
                            (ji, jnp.asarray(ids[:, sl])))
        td, (ti,) = merge_topk(td, torch.from_numpy(d[:, sl]), k,
                               (ti, torch.from_numpy(ids[:, sl])))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # the flat merge: lax.top_k(-d) order, ties to the lower flat index
    from jax import lax

    top, idx = lax.top_k(-jnp.asarray(d), k)
    tv, tidx = stable_topk_smallest(torch.from_numpy(d), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(tv.numpy(), -np.asarray(top))


def test_layout_and_routing_are_validated():
    _, tc = _cfgs(64)
    with pytest.raises(ValueError, match="multiple"):
        TShard(tc, ["cpu"] * 3, n_logical=4)
    with pytest.raises(ValueError, match="routing"):
        TShard(tc, ["cpu"], routing="typo")
    idx = TShard(tc, ["cpu"] * 2, n_logical=4, max_external_id=64)
    assert idx.rows_per_shard == 2 and len(idx.rows) == 4
    with pytest.raises(ValueError, match="outside"):
        idx.insert(np.asarray([64]), np.zeros((1, DIM), np.float32))
    with pytest.raises(ValueError, match="partition"):
        idx.search(np.zeros((1, DIM), np.float32), partition="typo")


# ---------------------------------------------------------------------------
# per-op updates, growth and search at S = 1, 2, 4 against the reference
# ---------------------------------------------------------------------------

OPS_DATA = grid_data(MAX_EXT, DIM, 3)
OPS_Q = grid_data(12, DIM, 4)


def _row_pools():
    """Every external id below ``MAX_EXT``, split by owner row."""
    pool = np.arange(MAX_EXT)
    own = TShard.__new__(TShard)
    own.n_logical = L
    rows = own.route(pool)
    return [pool[rows == r] for r in range(L)]


def _balanced(start, n_per_row):
    """``n_per_row`` ids of every row, from position ``start`` of each
    row's pool: the batch packs to one per-row bucket."""
    return np.concatenate([p[start:start + n_per_row]
                           for p in _row_pools()])


def _feed(idx):
    """30 inserts a row (growing every row 32 -> 64), a delete of 8 a row
    with one unknown id (``KeyError`` after the known ids apply), 16 more
    inserts a row, a ``delete_slots`` of 16 a row; every batch after the
    first packs to one per-row bucket (16).  Returns the bookkeeping."""
    first = _balanced(0, 30)
    out = {"insert": idx.insert(first, OPS_DATA[first])}
    dead = _balanced(0, 8)
    with pytest.raises(KeyError):
        idx.delete(np.append(dead, MAX_EXT - 1))
    more = _balanced(30, 16)
    out["insert2"] = idx.insert(more, OPS_DATA[more])
    slots, owners = out["insert"]
    sel = np.isin(first, _balanced(8, 16))
    idx.delete_slots(slots[sel], owners[sel])
    out["deleted"] = np.concatenate([dead, first[sel]])
    return out


@pytest.fixture(scope="module")
def ref_fed(tmp_path_factory):
    from repro.checkpoint import CheckpointManager as JManager

    jc, _ = _cfgs(32)
    idx = _ref(jc)
    ops = _feed(idx)
    ckpt = tmp_path_factory.mktemp("ref_sharded")
    idx.save(JManager(ckpt), 11)
    return {"idx": idx, "ops": ops, "ckpt": ckpt,
            "search": idx.search(OPS_Q, k=5, l=32),
            "part": idx.search(OPS_Q, k=5, l=32, partition="queries")}


@pytest.fixture(scope="module", params=LAYOUTS, ids=lambda s: f"S{s}")
def port_fed(request):
    _, tc = _cfgs(32)
    idx = _port(tc, request.param)
    return idx, _feed(idx)


def test_ops_match_reference(ref_fed, port_fed):
    idx, ops = port_fed
    ref = ref_fed["idx"]
    assert idx.cfg.n_cap == ref.cfg.n_cap == 64       # grew in lockstep
    assert all(r.graph.vectors.shape[0] == 64 for r in idx.rows)
    for key in ("insert", "insert2"):
        for a, b in zip(ref_fed["ops"][key], ops[key]):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=key)
    assert_index_equal(ref.states, idx.states, where=f"S={idx.n_shards}")
    assert idx.n_active == L * (30 - 8 + 16 - 16)


@pytest.mark.parametrize("partition", [None, "queries"])
def test_search_matches_reference(ref_fed, port_fed, partition):
    idx, ops = port_fed
    got = idx.search(OPS_Q, k=5, l=32, partition=partition)
    _assert_search_equal(ref_fed["search" if partition is None else "part"],
                         got, f"S={idx.n_shards} {partition}")
    # both partitions agree, and no deleted id is served
    _assert_search_equal(ref_fed["search"], got, "vs replicate")
    assert not set(got[0].ravel().tolist()) & set(ops["deleted"].tolist())


# ---------------------------------------------------------------------------
# update streams
# ---------------------------------------------------------------------------


def _stream_ops(data):
    """Three ``update_stream`` calls of four 32-lane steps (8 lanes a row,
    so every segment is one (L, 4, 8) shape): inserts; deletes of the
    first two insert steps and two more insert steps; a reinsert, a
    delete and two insert steps."""
    ins = [_balanced(8 * i, 8) for i in range(8)]
    return [[("i", ins[0]), ("i", ins[1]), ("i", ins[2]), ("i", ins[3])],
            [("d", ins[0]), ("d", ins[1]), ("i", ins[4]), ("i", ins[5])],
            [("i", ins[0]), ("d", ins[2]), ("i", ins[6]), ("i", ins[7])]
            ], data


def _run_stream(idx, mk_ins, mk_del, stream):
    calls, data = stream
    return [idx.update_stream([mk_ins(e, data[e]) if kind == "i"
                               else mk_del(e, DIM) for kind, e in call],
                              max_t=4)
            for call in calls]


@pytest.mark.parametrize("policy,sequential", [("ip", True), ("ip", False),
                                               ("local", True)])
def test_update_stream_matches_reference(policy, sequential):
    import repro.core as jcore

    jc, tc = _cfgs(256)
    data = grid_data(MAX_EXT, DIM, 5)
    ref = _ref(jc, policy=policy, sequential=sequential)
    stream = _stream_ops(data)
    jres = _run_stream(ref, jcore.insert_batch, jcore.delete_batch, stream)

    def mk_ins(e, v):
        return insert_batch(e, v, device="cpu")

    def mk_del(e, d):
        return delete_batch(e, d, device="cpu")

    ports = {}
    for routing in ("compact", "replicate"):
        idx = _port(tc, 2, policy=policy, sequential=sequential,
                    routing=routing)
        ports[routing] = (idx, _run_stream(idx, mk_ins, mk_del, stream))
    idx, tres = ports["compact"]
    assert_index_equal(ref.states, idx.states, where=policy)
    for jr, tr in zip(jres, tres):
        assert len(jr) == len(tr)
        for js, ts in zip(jr, tr):
            for f in ("slot", "ok", "n_comps", "consolidated",
                      "needs_consolidation"):
                np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                              getattr(ts, f), err_msg=f)
    assert len(tres[0]) == 1 and tres[0][0].ok.shape == (4, 32)
    assert tres[0][0].ok.all()
    # replicate routing: the same rows leaf for leaf; per-lane results
    # stay (L, T, B) with off-owner lanes masked
    rep, rres = ports["replicate"]
    for a, b in zip(idx.rows, rep.rows):
        assert_port_equal(a, b, "replicate")
    for cr, rr in zip(tres, rres):
        for cs, rs in zip(cr, rr):
            assert rs.ok.shape[0] == L
            np.testing.assert_array_equal(cs.ok, rs.ok.any(axis=0))
            np.testing.assert_array_equal(cs.slot, rs.slot.max(axis=0))


def test_update_stream_owner_aware_planning():
    """Every step packed exactly once, its bucket in the plan key: eight
    balanced steps under max_t=4 give two T=4 segments of bc = B/L; a
    skewed pair splits the plan into three segments."""
    _, tc = _cfgs(512, dim=8)
    idx = TShard(tc, ["cpu"], n_logical=2, max_external_id=4096)
    rng = np.random.default_rng(0)
    pool = np.arange(4096)
    own = idx.route(pool)
    per = [pool[own == s] for s in range(2)]

    def balanced(i, b=16):
        half = b // 2
        return np.concatenate([p[i * half:(i + 1) * half] for p in per])

    def batch(ids):
        return insert_batch(ids, rng.standard_normal(
            (len(ids), 8)).astype(np.float32), device="cpu")

    p0 = tdist.TRACE_COUNTER["segment_pack"]
    res = idx.update_stream([batch(balanced(i)) for i in range(8)], max_t=4)
    assert len(res) == 2
    assert tdist.TRACE_COUNTER["segment_pack"] - p0 == 8
    assert {s[-1] for s in tdist.TRACE_SHAPES["segment_pack"][-8:]} == {8}
    for r in res:
        assert r.ok.shape == (4, 16) and r.ok.all()
    skew = [per[0][200 + i * 16: 216 + i * 16] for i in range(2)]
    p1 = tdist.TRACE_COUNTER["segment_pack"]
    res2 = idx.update_stream([batch(e) for e in
                              (balanced(9), skew[0], skew[1], balanced(10))],
                             max_t=4)
    assert len(res2) == 3
    assert tdist.TRACE_COUNTER["segment_pack"] - p1 == 4
    assert [s[-1] for s in tdist.TRACE_SHAPES["segment_pack"][-4:]] == \
        [8, 16, 16, 8]
    for r in res2:
        assert r.ok[:, :16].all()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoints_cross_restore_and_reshard(ref_fed, tmp_path):
    from repro.checkpoint import CheckpointManager as JManager
    from repro.core.distributed import ShardedIndex as JShard

    jc, tc = _cfgs(64)
    ref = ref_fed["idx"]
    # the reference's checkpoint onto the port at S = 2 and 1
    for s in (2, 1):
        idx, step = TShard.restore(CheckpointManager(ref_fed["ckpt"]), tc,
                                   ["cpu"] * s)
        assert step == 11 and idx.n_shards == s and idx.n_logical == L
        assert idx.rows_per_shard == L // s and idx.policy == "ip"
        assert_index_equal(ref.states, idx.states, where=f"ref->S{s}")
        _assert_search_equal(ref_fed["search"],
                             idx.search(OPS_Q, k=5, l=32), f"ref->S{s}")
    # the port's S = 4 index -> checkpoint -> S = 2 -> checkpoint -> S = 1,
    # updates continued side by side after the first reshard
    a, _ = TShard.restore(CheckpointManager(ref_fed["ckpt"]), tc,
                          ["cpu"] * 4)
    m1 = CheckpointManager(tmp_path / "s4")
    a.save(m1, 3)
    b, _ = TShard.restore(m1, tc, ["cpu"] * 2)
    more = _balanced(60, 15)
    vecs = OPS_DATA[more]
    for idx in (a, b):
        idx.insert(more, vecs)
        idx.delete(_balanced(24, 6))
    for x, y in zip(a.rows, b.rows):
        assert_port_equal(x, y, "4 -> 2")
    m2 = CheckpointManager(tmp_path / "s2")
    b.save(m2, 4)
    c, step = TShard.restore(m2, b.cfg, ["cpu"])
    assert step == 4 and c.n_shards == 1 and c.rows_per_shard == L
    for x, y in zip(a.rows, c.rows):
        assert_port_equal(x, y, "2 -> 1")
    _assert_search_equal(a.search(OPS_Q, k=5, l=32),
                         c.search(OPS_Q, k=5, l=32, partition="queries"),
                         "2 -> 1")
    # the port's checkpoint onto the reference's 1-device mesh
    jc = dataclasses.replace(jc, n_cap=b.cfg.n_cap)
    jidx, step = JShard.restore(JManager(tmp_path / "s2"), jc, _mesh())
    assert step == 4 and jidx.n_logical == L
    assert_index_equal(jidx.states, c.states, where="port->ref")
    _assert_search_equal(jidx.search(OPS_Q, k=5, l=32),
                         c.search(OPS_Q, k=5, l=32), "port->ref")
    # typed errors: a layout that does not divide L, a single-index restore
    with pytest.raises(CheckpointMismatchError, match="reshard"):
        TShard.restore(m2, b.cfg, ["cpu"] * 3)
    with pytest.raises(CheckpointMismatchError, match="stacked"):
        TIndex.restore(m2, b.cfg, device="cpu")
    single = TIndex(tc, device="cpu")
    single.save(CheckpointManager(tmp_path / "single"), 1)
    with pytest.raises(CheckpointMismatchError, match="single"):
        TShard.restore(CheckpointManager(tmp_path / "single"), tc, ["cpu"])


# ---------------------------------------------------------------------------
# the int8 tier, fresh, snapshots
# ---------------------------------------------------------------------------


def test_quantized_sharded_search_matches_reference():
    jc, tc = _cfgs(256, quantized=True)
    data = qgrid_data(300, DIM, 11)
    q = qgrid_data(8, DIM, 12)
    ref = _ref(jc)
    ref.insert(np.arange(300), data)
    idx = _port(tc, 2)
    idx.insert(np.arange(300), data)
    assert all(r.graph.quant is not None for r in idx.rows)
    assert_index_equal(ref.states, idx.states, where="int8")
    for part in (None, "queries"):
        _assert_search_equal(ref.search(q, k=5, l=32, partition=part),
                             idx.search(q, k=5, l=32, partition=part),
                             f"int8 {part}")


def test_fresh_rows_match_single_device_reference():
    """Sharded fresh against the single-device reference, row by row: each
    row runs the reference's ``apply_segment`` over its owned lanes of
    every segment, then ``fresh_consolidate`` when any op of the segment
    raised ``needs_consolidation``."""
    import jax.numpy as jnp

    import repro.core as jcore
    from repro.core.api import apply_segment
    from repro.core.consolidate import fresh_consolidate as j_fresh
    from repro.core.types import UpdateBatch as JBatch
    from repro.core.types import init_index_state as j_init

    jc, tc = _cfgs(256)
    data = grid_data(MAX_EXT, DIM, 13)
    idx = _port(tc, 2, policy="fresh")
    ins = [_balanced(4 * i, 4) for i in range(6)]
    live = np.concatenate(ins)
    calls = [[insert_batch(e, data[e], device="cpu") for e in ins],
             [delete_batch(live[i:i + 16], DIM, device="cpu")
              for i in range(0, 64, 16)]]
    results = [idx.update_stream(c, max_t=8) for c in calls]
    assert any(r.needs_consolidation.any() for r in results[1])
    rows = [j_init(jc, MAX_EXT) for _ in range(L)]
    for call, res in zip(calls, results):
        steps = list(call) + [jcore.noop_update_batch(16, DIM)] * (
            next_bucket(len(call)) - len(call))
        ops = jcore.stack_update_batches([
            JBatch(*(jnp.asarray(f.numpy()) for f in s))
            if isinstance(s.kind, torch.Tensor) else s for s in steps])
        owners = np.where(np.asarray(ops.valid),
                          idx.route(np.asarray(ops.ext_id)), -1)
        packed, _, _ = jcore.compact_owner_segment(ops, owners, L)
        for r in range(L):
            row_ops = JBatch(*(f[r] for f in packed))
            rows[r], jres = apply_segment(rows[r], jc, row_ops,
                                          policy="fresh", sequential=True)
            np.testing.assert_array_equal(
                np.asarray(jres.needs_consolidation),
                res[0].needs_consolidation[r])
            if bool(np.asarray(jres.needs_consolidation).any()):
                rows[r] = rows[r]._replace(graph=j_fresh(rows[r].graph, jc))
    for r in range(L):
        assert_index_equal(rows[r], idx.rows[r], where=f"fresh row {r}")
    for r in idx.rows:
        g = r.graph
        assert int(g.n_pending) == 0 and not g.tombstone.any()
        ids = g.adj[g.active]
        assert g.active[ids[ids >= 0].long()].all()
    got = idx.search(grid_data(8, DIM, 14), k=5, l=32)
    assert not set(got[0].ravel().tolist()) & set(live[:64].tolist())


def test_fresh_stream_consolidates_at_boundaries():
    """``tests/test_segment.py``'s sharded fresh checks on the port alone:
    the flagged row is consolidated at the segment boundary, nothing is
    left pending, every deleted slot is back on the free stack."""
    from repro_torch.core import make_dataset

    tc = t_test_scale(16, 128, backend="torch")
    data, _ = make_dataset(120, tc.dim, n_queries=2, seed=27)
    idx = TShard(tc, ["cpu"], policy="fresh", max_external_id=640)
    idx.update_stream([insert_batch(np.arange(60), data[:60], device="cpu")])
    res = idx.update_stream([delete_batch(np.arange(0, 15), tc.dim,
                                          device="cpu"),
                             delete_batch(np.arange(15, 30), tc.dim,
                                          device="cpu")])
    assert res[0].needs_consolidation.any()
    g = idx.states.graph
    assert int(g.n_pending[0]) == 0, "tombstones not released"
    assert int(g.free_top[0]) == tc.n_cap - 30
    assert not g.tombstone[0].any()


def test_consolidate_stacked_matches_rows():
    """``consolidate_stacked`` on a stacked state writes the listed rows in
    place and equals the per-row pass; other rows stay untouched."""
    _, tc = _cfgs(256)
    data = grid_data(200, DIM, 15)
    idx = _port(tc, 1, policy="fresh")
    idx.insert(np.arange(200), data)
    idx.delete(np.arange(0, 200, 3))
    stacked = idx.states
    before = clone_state(stacked)
    out = consolidate_stacked(stacked.graph, tc, fresh_consolidate, [1, 3])
    assert out is stacked.graph
    idx.consolidate_sharded([1, 3])
    held, got = unstack_state(before.graph), unstack_state(out)
    for r in range(L):
        want = idx.rows[r].graph if r in (1, 3) else held[r]
        assert_port_equal(want, got[r], f"row {r}")
    assert int(out.n_pending[1]) == 0 and int(out.n_pending[0]) > 0


def test_snapshot_states_isolate_every_row():
    _, tc = _cfgs(256)
    data = grid_data(120, DIM, 16)
    idx = _port(tc, 2)
    idx.insert(np.arange(100), data[:100])
    snap = idx.snapshot_states()
    held = [clone_state(r) for r in snap]
    q = data[:6]
    before = idx.search_state(snap, q, k=5, l=32)
    idx.insert(np.arange(100, 120), data[100:])
    idx.delete(np.arange(0, 30))
    for a, b in zip(held, snap):
        assert_port_equal(a, b, "snapshot row")
    for live, s in zip(idx.rows, snap):
        assert live.graph.adj.data_ptr() != s.graph.adj.data_ptr()
    _assert_search_equal(before, idx.search_state(snap, q, k=5, l=32),
                         "snapshot")
    # a stacked state searches like its rows
    _assert_search_equal(idx.search(q, k=5, l=32),
                         idx.search_state(idx.states, q, k=5, l=32),
                         "stacked")


@pytest.mark.requires_cuda
def test_card_layout_matches_cpu(cuda_device):
    """Two entries of the card hold the same rows and answers as the CPU
    (kernel engine on the card, plain versions on the CPU; grid data)."""
    cfg = t_test_scale(DIM, 256)
    data = grid_data(300, DIM, 17)
    q = grid_data(16, DIM, 18)
    runs = {}
    for devices in ([cuda_device] * 2, ["cpu"] * 2):
        idx = TShard(cfg, devices, n_logical=L, max_external_id=MAX_EXT,
                     sequential=False)
        idx.insert(np.arange(300), data)
        idx.delete(np.arange(0, 300, 5))
        runs[str(idx.devices[0].type)] = (
            idx, idx.search(q, k=5, l=32),
            idx.search(q, k=5, l=32, partition="queries"))
    (a, ra, pa), (b, rb, pb) = runs["cuda"], runs["cpu"]
    assert a.rows[0].graph.vectors.is_cuda
    assert TShard(cfg, n_logical=2).rows[1].graph.vectors.is_cuda
    for x, y in zip(a.rows, b.rows):
        assert_port_equal(x, y, "card vs cpu")
    _assert_search_equal(ra, rb, "card vs cpu")
    _assert_search_equal(pa, pb, "card vs cpu, queries")
