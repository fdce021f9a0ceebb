"""The slice as a whole: the ``apply``/``search`` stream of the port against
the JAX reference.

A serial bootstrap of 2*l_build points, batched insert windows, in-place
deletes of 20% (batched and serial) with the consolidation trigger firing,
and reinserts, all through ``apply(policy="ip")``; the whole ``IndexState``
equals the reference's after every step (bitwise on grid data), and
``search`` / ``graph_recall`` agree.  A batched insert into a new, empty
index returns what the reference returns, and so do the lane-semantics
probes: re-insert of a still-mapped id, duplicate delete lanes and a batch
that deletes its own insert, serial and batched.  The slower probes (a
JAX-built state continued in the port, a batched insert into an index
emptied by deletes and a sweep) are in ``test_torch_api_probes.py``, so
that a run spread over files places them on another worker.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_parity import assert_field, assert_index_equal, cfg_pair, \
    grid_data, small_kw

from repro.core import api as japi
from repro.core import recall as jrecall
from repro.core.types import KIND_DELETE, KIND_INSERT
from repro.core.types import init_index_state as j_init
from repro_torch.core import api as tapi
from repro_torch.core import recall as trecall
from repro_torch.core.types import init_index_state as t_init

DIM = 24
INVALID_ID = -1


def _data(kind, metric):
    if kind == "grid":
        return grid_data(420, DIM, 21), grid_data(24, DIM, 22)
    from repro.core.runbook import make_dataset

    return make_dataset(420, DIM, metric, n_queries=24, seed=21)


class Pair:
    """The same op stream applied to both packages, compared per step."""

    def __init__(self, metric, kind, jstate=None, tstate=None):
        self.jcfg, self.tcfg = cfg_pair(**small_kw(metric))
        self.exact = kind == "grid"
        self.js = jstate if jstate is not None else j_init(self.jcfg, 500)
        self.ts = tstate if tstate is not None else t_init(self.tcfg, 500,
                                                           device="cpu")

    def insert(self, ids, data, **kw):
        jr = self._apply(japi.insert_batch(ids, data[ids]),
                         tapi.insert_batch(ids, data[ids], device="cpu"), kw)
        return jr

    def delete(self, ids, **kw):
        return self._apply(japi.delete_batch(ids, DIM),
                           tapi.delete_batch(ids, DIM, device="cpu"), kw)

    def _apply(self, jb, tb, kw):
        self.js, jr = japi.apply(self.js, self.jcfg, jb, **kw)
        self.ts, tr = tapi.apply(self.ts, self.tcfg, tb, **kw)
        for f in ("slot", "ok", "n_comps"):
            assert_field(getattr(jr, f), getattr(tr, f), f"result {f}")
        self.check("apply")
        return tr

    def consolidate(self, **kw):
        self.js, jd = japi.maybe_consolidate(self.js, self.jcfg, **kw)
        self.ts, td = tapi.maybe_consolidate(self.ts, self.tcfg, **kw)
        assert jd == td
        self.check("consolidate")
        return td

    def check(self, where):
        assert_index_equal(self.js, self.ts, self.exact, where)

    def search(self, q):
        je, jd, _ = japi.search(self.js, self.jcfg, jnp.asarray(q), k=10)
        te, td, _ = tapi.search(self.ts, self.tcfg, torch.from_numpy(q),
                                k=10)
        assert_field(je, te, "search ext ids")
        assert_field(jd, td, "search dists", self.exact)
        jrec = jrecall.graph_recall(self.js.graph, self.jcfg, jnp.asarray(q),
                                    k=10)
        trec = trecall.graph_recall(self.ts.graph, self.tcfg,
                                    torch.from_numpy(q), k=10)
        assert jrec == trec
        return te, trec


@pytest.mark.parametrize("metric,kind", [("l2", "grid"), ("l2", "gauss")])
def test_apply_stream_matches_reference(metric, kind):
    data, q = _data(kind, metric)
    p = Pair(metric, kind)
    boot = 2 * p.jcfg.l_build
    p.insert(np.arange(boot), data, sequential=True)
    for lo in range(boot, 256, 64):
        p.insert(np.arange(lo, lo + 64), data)
    _, r0 = p.search(q)
    rng = np.random.default_rng(3)
    dels = rng.choice(256, size=52, replace=False)
    fired = False
    p.delete(dels[:24])
    fired |= p.consolidate()
    p.delete(dels[24:40], sequential=True)
    fired |= p.consolidate()
    p.delete(dels[40:])
    fired |= p.consolidate()
    assert fired, "the consolidation trigger never fired"
    ext, _ = p.search(q)
    assert not np.isin(ext.numpy(), dels).any()
    # a mixed kind-major batch: reinserts plus fresh deletes
    more = np.setdiff1d(np.arange(256), dels)[:10]
    jb, split = japi.mixed_update_batch(dels[:40], data[dels[:40]], more,
                                        DIM)
    tb, tsplit = tapi.mixed_update_batch(dels[:40], data[dels[:40]], more,
                                         DIM, device="cpu")
    assert split == tsplit
    p._apply(jb, tb, dict(split=split))
    p.insert(np.arange(256, 340), data)
    _, r1 = p.search(q)
    assert r1 > 0.8 and r0 > 0.8


def test_bad_lanes_are_no_ops():
    data, _ = _data("grid", "l2")
    p = Pair("l2", "grid")
    p.insert(np.arange(40), data, sequential=True)
    # unknown and out-of-range external ids, and a masked lane
    jb = japi.make_update_batch([1, 1, 0, 0], [999, 7, 450, 3],
                                np.zeros((4, DIM), np.float32),
                                valid=[True, True, True, False])
    tb = tapi.make_update_batch([1, 1, 0, 0], [999, 7, 450, 3],
                                np.zeros((4, DIM), np.float32),
                                valid=[True, True, True, False],
                                device="cpu")
    res = p._apply(jb, tb, {})
    assert res.ok.tolist() == [False, True, True, False]


@pytest.mark.parametrize("lanes", [5, 68])
def test_batched_insert_into_empty_index(lanes):
    """Padded lanes after the last valid one point the free-stack pop at
    ``free_top == n_cap``; the reference clamps that read."""
    data, _ = _data("grid", "l2")
    p = Pair("l2", "grid")
    res = p.insert(np.arange(lanes), data)
    assert res.ok[:lanes].all() and not res.ok[lanes:].any()


def _probe_batches(probe, data):
    """(jax batch, torch batch) of one lane-semantics probe."""
    if probe == "reinsert_mapped":
        ids = np.array([3, 5, 70])
        return (japi.insert_batch(ids, data[100 + ids]),
                tapi.insert_batch(ids, data[100 + ids], device="cpu"))
    if probe == "duplicate_deletes":
        ids = np.array([7, 7, 9, 9, 11])
        return (japi.delete_batch(ids, DIM),
                tapi.delete_batch(ids, DIM, device="cpu"))
    kind = [KIND_INSERT, KIND_DELETE, KIND_INSERT, KIND_DELETE]
    ext = [90, 90, 91, 4]
    vec = np.stack([data[90], np.zeros(DIM, np.float32), data[91],
                    np.zeros(DIM, np.float32)])
    return (japi.pad_update_batch(japi.make_update_batch(kind, ext, vec)),
            tapi.pad_update_batch(tapi.make_update_batch(kind, ext, vec,
                                                         device="cpu")))


@pytest.mark.parametrize("sequential", [True, False])
@pytest.mark.parametrize("probe", ["reinsert_mapped", "duplicate_deletes",
                                   "delete_own_insert"])
def test_lane_semantics_probes(probe, sequential):
    data, q = _data("grid", "l2")
    p = Pair("l2", "grid")
    p.insert(np.arange(80), data, sequential=True)
    res = p._apply(*_probe_batches(probe, data), dict(sequential=sequential))
    ok = res.ok.tolist()
    if probe == "duplicate_deletes":
        # serial lanes see the earlier delete; the batched phase judges
        # every lane against the pre-batch graph, as the reference does
        assert ok[:5] == ([True, False, True, False, True] if sequential
                          else [True] * 5)
    elif probe == "delete_own_insert":
        assert ok[:4] == [True, True, True, True]
        assert int(p.ts.ext2slot[90]) == INVALID_ID
    else:
        assert ok[:3] == [True, True, True]
    p.search(q)
