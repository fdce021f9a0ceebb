"""The port's types, bitset and searches against the JAX reference.

Initial states match leaf for leaf; packed bitmaps carry the reference's
uint32 bits; ``greedy_search`` and ``batched_greedy_search`` over
{torch, ref} x {l2, ip} x hop_fused {0, 3, 4} return the ids, visited lists
and counters of the reference's {jnp, ref} engines, with distances bitwise
on grid data and to tolerance on Gaussian data.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_parity import (assert_field, assert_index_equal,
                          assert_search_equal, cfg_pair, grid_data, n,
                          small_kw, t)

from repro.core import api as japi
from repro.core import bitset as jbitset
from repro.core.batched import insert_many_batched as j_insert_batched
from repro.core.search import greedy_search as j_greedy
from repro.core.search_batched import batched_greedy_search as j_batched
from repro.core.types import init_index_state as j_init
from repro_torch import convert
from repro_torch.core import bitset as tbitset
from repro_torch.core.search import greedy_search as t_greedy
from repro_torch.core.search import search_batch as t_search_batch
from repro_torch.core.search_batched import (batched_greedy_search as
                                             t_batched, merge_topk,
                                             next_bucket, pad_batch)
from repro_torch.core.types import (compact_row, init_index_state,
                                    mask_duplicates)

DIM, N_CAP = 20, 250  # n_cap not a multiple of 32


def test_initial_index_state_matches_leaf_for_leaf():
    jcfg, tcfg = cfg_pair(**small_kw())
    assert_index_equal(j_init(jcfg, 333),
                       init_index_state(tcfg, 333, device="cpu"))


def test_quantized_config_raises():
    """A quantized config builds the reference's state leaf for leaf, and
    raises where the reference does (an empty id range)."""
    jcfg, tcfg = cfg_pair(**small_kw(), quantized=True)
    assert_index_equal(j_init(jcfg, 333),
                       init_index_state(tcfg, 333, device="cpu"))
    with pytest.raises(ValueError):
        init_index_state(tcfg, 0, device="cpu")


@pytest.mark.parametrize("n_bits", [1, 31, 32, 33, 250, 700])
def test_pack_bits_matches_reference_words(n_bits):
    rng = np.random.default_rng(n_bits)
    bits = rng.random((3, n_bits)) < 0.5
    ref = np.asarray(jbitset.pack_bits(jnp.asarray(bits)))
    got = tbitset.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(ref.view(np.int32), n(got))
    np.testing.assert_array_equal(convert.words_to_numpy(got), ref)
    np.testing.assert_array_equal(n(tbitset.unpack_rows(got, n_bits)), bits)


def test_setbits_and_getbit_rows_match_reference():
    rng = np.random.default_rng(0)
    seen = rng.integers(0, 2**32, size=(4, 8), dtype=np.uint64).astype(
        np.uint32)
    ids = rng.integers(0, 250, size=(4, 12)).astype(np.int32)
    ids[:, 3] = ids[:, 2]                      # in-row duplicates
    ids[0, :4] = [31, 63, 31, 255 - 4]         # sign bits
    mask = rng.random((4, 12)) < 0.7
    ref = jbitset.setbits_rows(jnp.asarray(seen), jnp.asarray(ids),
                               jnp.asarray(mask))
    got = tbitset.setbits_rows(t(seen), t(ids), torch.from_numpy(mask))
    np.testing.assert_array_equal(np.asarray(ref).view(np.int32), n(got))
    np.testing.assert_array_equal(
        np.asarray(jbitset.getbit_rows(ref, jnp.asarray(ids))),
        n(tbitset.getbit_rows(got, t(ids))))


def test_row_utilities_match_reference():
    from repro.core import types as jt

    rng = np.random.default_rng(1)
    rows = rng.integers(-1, 6, size=(5, 9)).astype(np.int32)
    got = compact_row(t(rows))
    for i in range(5):
        np.testing.assert_array_equal(
            np.asarray(jt.compact_row(jnp.asarray(rows[i]))), n(got[i]))
        np.testing.assert_array_equal(
            np.asarray(jt.mask_duplicates(jnp.asarray(rows[i]))),
            n(mask_duplicates(t(rows[i]))))


def test_bucketing_helpers():
    assert [next_bucket(b) for b in (1, 2, 3, 5, 64, 65)] == \
        [1, 2, 4, 8, 64, 128]
    assert n(pad_batch(torch.ones((3,), dtype=torch.int32), 3)).tolist() == \
        [1, 1, 1, -1]
    d, (p,) = merge_topk(torch.tensor([[1.0, 3.0]]), torch.tensor([[1.0,
                                                                   2.0]]), 3,
                         (torch.tensor([[10, 30]]), torch.tensor([[11, 21]])))
    assert p.tolist() == [[10, 11, 21]] and d.tolist() == [[1.0, 1.0, 2.0]]


@functools.lru_cache(maxsize=None)
def _built(metric, kind):
    """A JAX-built graph (bootstrap + batched inserts + a few deletes) with
    tombstone-free quarantined slots, as numpy, plus queries."""
    jcfg, _ = cfg_pair(dim=DIM, n_cap=N_CAP, r=8, l_build=16, l_search=16,
                       l_delete=16, k_delete=8, n_copies=2, alpha=1.2,
                       metric=metric)
    if kind == "grid":
        data, q = grid_data(160, DIM, 3), grid_data(7, DIM, 4)
    else:
        from repro.core.runbook import make_dataset

        data, q = make_dataset(160, DIM, metric, n_queries=7, seed=3)
    st = j_init(jcfg, 400)
    st, _ = japi.apply(st, jcfg, japi.insert_batch(np.arange(32), data[:32]),
                       sequential=True)
    st, _ = japi.apply(st, jcfg, japi.insert_batch(np.arange(32, 160),
                                                   data[32:160]))
    st, _ = japi.apply(st, jcfg, japi.delete_batch(np.arange(0, 160, 9),
                                                   DIM))
    from torch_parity import jax_index_numpy

    return jax_index_numpy(st), q


def _pair(metric, kind, jb, tb, h):
    d, q = _built(metric, kind)
    jcfg, tcfg = cfg_pair(dim=DIM, n_cap=N_CAP, r=8, l_build=16,
                          l_search=16, l_delete=16, k_delete=8, n_copies=2,
                          alpha=1.2, metric=metric, jax_backend=jb,
                          torch_backend=tb, hop_fused=h)
    from repro.core.types import GraphState

    jg = GraphState(**{k: (None if v is None else jnp.asarray(v))
                       for k, v in d["graph"].items()})
    tg = convert.index_state_from_numpy(d, device="cpu").graph
    return jcfg, tcfg, jg, tg, q


ENGINES = [("jnp", "torch"), ("ref", "ref")]


@pytest.mark.parametrize("kind", ["grid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("engines", ENGINES)
def test_greedy_search_matches_reference(kind, metric, engines):
    jcfg, tcfg, jg, tg, q = _pair(metric, kind, *engines, -1)
    for i in range(3):
        jr = j_greedy(jg, jcfg, jnp.asarray(q[i]), k=5, l=16)
        tr = t_greedy(tg, tcfg, t(q[i]), k=5, l=16)
        assert_search_equal(jr, tr, kind == "grid", f"query {i}")


@pytest.mark.parametrize("kind", ["grid", "gauss"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("engines", ENGINES)
@pytest.mark.parametrize("h", [0, 3, 4])
def test_batched_search_matches_reference(kind, metric, engines, h):
    jcfg, tcfg, jg, tg, q = _pair(metric, kind, *engines, h)
    valid = np.array([True, True, False, True, True, True, True])
    jr = j_batched(jg, jcfg, jnp.asarray(q), k=5, l=16,
                   valid=jnp.asarray(valid))
    tr = t_batched(tg, tcfg, t(q), k=5, l=16, valid=torch.from_numpy(valid))
    assert_search_equal(jr, tr, kind == "grid")
    assert n(tr.n_hops)[2] == 0 and (n(tr.topk_ids)[2] == -1).all()


def test_tombstoned_entry_point_is_navigated_not_returned():
    jcfg, tcfg, jg, tg, q = _pair("l2", "grid", "jnp", "torch", 0)
    s = int(tg.start)
    jg = jg._replace(active=jg.active.at[s].set(False),
                     tombstone=jg.tombstone.at[s].set(True))
    tg.active[s] = False
    tg.tombstone[s] = True
    jr = j_batched(jg, jcfg, jnp.asarray(q), k=5, l=16)
    tr = t_batched(tg, tcfg, t(q), k=5, l=16)
    assert_search_equal(jr, tr, True)
    assert s not in n(tr.topk_ids)


def test_search_batch_buckets_ragged_batches():
    jcfg, tcfg, jg, tg, q = _pair("l2", "grid", "jnp", "torch", -1)
    res = t_search_batch(tg, tcfg, t(q[:5]), k=4, l=16)
    full = t_batched(tg, tcfg, t(q[:5]), k=4, l=16)
    assert res.topk_ids.shape == (5, 4)
    assert_field(full.topk_ids, res.topk_ids, "bucketed ids")


def test_batched_insert_search_phase_matches_reference():
    """The insert path's search runs against a state whose new slots are
    written but inactive: carried across with ``convert``."""
    d, _ = _built("l2", "grid")
    jcfg, tcfg = cfg_pair(dim=DIM, n_cap=N_CAP, r=8, l_build=16,
                          l_search=16, l_delete=16, k_delete=8, n_copies=2,
                          alpha=1.2, metric="l2")
    from repro.core.types import GraphState
    from repro_torch.core.batched import insert_many_batched

    jg = GraphState(**{k: (None if v is None else jnp.asarray(v))
                       for k, v in d["graph"].items()})
    tg = convert.index_state_from_numpy(d, device="cpu").graph
    xs = grid_data(8, DIM, 9)
    jg2, js = j_insert_batched(jg, jcfg, jnp.asarray(xs))
    tg2, ts = insert_many_batched(tg, tcfg, t(xs))
    for f in ("adj", "active", "free_top", "start", "n_active", "norms"):
        assert_field(getattr(jg2, f), getattr(tg2, f), f)
    assert_field(js.slot, ts.slot, "slots")
    assert_field(js.n_comps, ts.n_comps, "comps")
