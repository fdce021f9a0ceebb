"""The slow probes of the ``apply`` stream against the JAX reference
(``test_torch_api.py`` holds the rest, and the ``Pair`` harness): a state
built by JAX and carried over with ``repro_torch.convert`` continues in the
port exactly as in JAX, and a batched insert into an index emptied by
deletes and an Alg-6 sweep returns what the reference returns (ROADMAP
Queue 3, fault 1).  Kept in a file of their own so that a run spread over
files places them on another worker than ``test_torch_api.py``.
"""
import numpy as np
import pytest

from test_torch_api import DIM, Pair, _data
from torch_parity import assert_index_equal, cfg_pair, jax_index_numpy, \
    small_kw

from repro.core import api as japi
from repro.core.types import init_index_state as j_init
from repro_torch import convert


def test_jax_built_state_continues_in_the_port():
    data, q = _data("grid", "l2")
    jcfg, tcfg = cfg_pair(**small_kw())
    js = j_init(jcfg, 500)
    js, _ = japi.apply(js, jcfg, japi.insert_batch(np.arange(64), data[:64]),
                       sequential=True)
    js, _ = japi.apply(js, jcfg, japi.insert_batch(np.arange(64, 256),
                                                   data[64:256]))
    js, _ = japi.apply(js, jcfg, japi.delete_batch(np.arange(0, 256, 6),
                                                   DIM))
    snap = jax_index_numpy(js)
    ts = convert.index_state_from_numpy(snap, device="cpu")
    assert_index_equal(js, ts, True, "converted")
    back = convert.index_state_to_numpy(ts)
    for f, v in snap["graph"].items():
        if v is not None:
            np.testing.assert_array_equal(v, back["graph"][f])
    p = Pair("l2", "grid", jstate=js, tstate=ts)
    p.consolidate(force=True)
    p.insert(np.arange(256, 380), data)
    p.delete(np.arange(1, 200, 7))
    p.search(q)


@pytest.mark.parametrize("lanes", [5, 68])
def test_batched_insert_after_all_deleted_and_swept(lanes):
    data, _ = _data("grid", "l2")
    p = Pair("l2", "grid")
    p.insert(np.arange(192), data, sequential=True)
    p.delete(np.arange(192), sequential=True)
    assert p.consolidate()
    assert int(p.ts.graph.free_top) == p.tcfg.n_cap
    res = p.insert(np.arange(200, 200 + lanes), data)
    assert res.ok[:lanes].all()
