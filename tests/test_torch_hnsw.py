"""The HNSW baseline of the port (``repro_torch/core/hnsw.py``) against the JAX
reference on the CPU: the counterparts of ``test_hnsw.py`` (build and recall,
delete and replace, the runbook driver, the flag validation), each stream in
both packages with the whole hierarchy compared after every phase (bitwise
on grid data; on Gaussian data ids exactly, floats to rtol 2e-5); a
hierarchy built by JAX and continued in the port; and, on the card, kernels
3 and 2 at the hierarchy's shapes and the cuda engine's hierarchy against
the plain one (``python -m pytest --noconftest -m requires_cuda
tests/test_torch_hnsw.py``; JAX is imported inside the CPU tests only, so
the card-only tests collect without it).  The port's ``make_dataset`` /
``make_runbook`` are the reference's numpy code, so both packages see the
same data.
"""
import numpy as np
import pytest
import torch

from torch_parity import assert_field, cuda_device, grid_data  # noqa: F401

from repro_torch import convert
from repro_torch.core import HNSWConfig as THCfg
from repro_torch.core import HNSWIndex as THNSW
from repro_torch.core import StreamingIndex as TStreaming
from repro_torch.core import make_dataset
from repro_torch.core import make_runbook as t_runbook
from repro_torch.core import run_runbook as t_run
from repro_torch.core.types import ANNConfig as TCfg


def _pair(max_external_id, **kw):
    from repro.core.hnsw import HNSWConfig as JHCfg
    from repro.core.hnsw import HNSWIndex as JHNSW

    return (JHNSW(JHCfg(**kw), max_external_id=max_external_id),
            THNSW(THCfg(backend="torch", **kw),
                  max_external_id=max_external_id, device="cpu"))


def assert_hnsw_equal(ji, ti, exact=True, where=""):
    for f in ji.state._fields:
        assert_field(getattr(ji.state, f), getattr(ti.state, f),
                     f"{where} {f}", exact)
    np.testing.assert_array_equal(ji._ext2slot, ti._ext2slot)
    np.testing.assert_array_equal(ji._slot2ext, ti._slot2ext)


def _search_equal(ji, ti, q, exact):
    je, jd, js = ji.search(q, k=10)
    te, td, ts = ti.search(q, k=10)
    np.testing.assert_array_equal(je, te)
    np.testing.assert_array_equal(js, ts)
    assert_field(jd, td, "dists", exact)


@pytest.mark.parametrize("kind", ["grid", "gauss"])
def test_hnsw_build_and_recall(kind):
    if kind == "grid":
        data, queries = grid_data(400, 16, 11), grid_data(16, 16, 12)
    else:
        data, queries = make_dataset(400, 16, n_queries=16, seed=0)
    ji, ti = _pair(600, dim=16, n_cap=500, m=8, ef_construction=32,
                   ef_search=32, max_level=3)
    for idx in (ji, ti):
        idx.insert(np.arange(400), data)
    assert ti.n_active == 400
    assert int(ti.state.entry_level) >= 1     # the descent has levels
    assert_hnsw_equal(ji, ti, kind == "grid", "built")
    _search_equal(ji, ti, queries, kind == "grid")
    r = ti.recall(queries, k=10)
    assert r == ji.recall(queries, k=10) and r >= 0.9
    assert ti.counters.n_queries == 16 and ti.eval_counters.n_queries == 16


def test_hnsw_delete_and_replace():
    data, queries = make_dataset(300, 16, n_queries=8, seed=1)
    ji, ti = _pair(600, dim=16, n_cap=280, m=8, ef_construction=32,
                   ef_search=32, max_level=2, consolidation_threshold=0.2)
    for idx in (ji, ti):
        idx.insert(np.arange(200), data[:200])
        idx.delete(np.arange(80))       # 40% deleted: replacement kicks in
    assert_hnsw_equal(ji, ti, False, "deleted")
    for idx in (ji, ti):
        idx.insert(np.arange(200, 280), data[200:280])
    assert ti.n_active == 200
    assert int(ti.state.tombstone.sum()) < 80
    assert_hnsw_equal(ji, ti, False, "replaced")
    _search_equal(ji, ti, queries, False)
    r = ti.recall(queries, k=10)
    assert r == ji.recall(queries, k=10) and r >= 0.85


def test_hnsw_update_stream_via_runbook_driver():
    from repro.core import make_runbook, run_runbook

    rb_j = make_runbook("sliding_window", n=240, dim=16, t_max=12, seed=5)
    rb_t = t_runbook("sliding_window", n=240, dim=16, t_max=12, seed=5)
    kw = dict(dim=16, n_cap=320, m=8, ef_construction=32, ef_search=48,
              max_level=2)
    ji, ti = _pair(300, **kw)
    jr = run_runbook(ji, rb_j, k=10, eval_every=3, baseline="hnsw")
    tr = t_run(ti, rb_t, k=10, eval_every=3, baseline="hnsw")
    assert tr.mode == "hnsw" and len(tr.steps) >= 2
    assert [m.recall for m in jr.steps] == [m.recall for m in tr.steps]
    assert [m.comps_per_query for m in jr.steps] == \
        [m.comps_per_query for m in tr.steps]
    assert tr.avg_recall >= 0.75
    assert ti.counters.n_queries == 0 and ti.eval_counters.n_queries > 0
    assert ti.counters.n_inserts > 0 and ti.counters.n_deletes > 0
    assert ti.eval_counters.search_comps == ji.eval_counters.search_comps
    assert_hnsw_equal(ji, ti, False, "runbook")


def test_hnsw_baseline_flag_validation():
    from repro.core import ANNConfig as JCfg
    from repro.core import StreamingIndex as JStreaming
    from repro.core import make_runbook, run_runbook

    rb = t_runbook("sliding_window", n=60, dim=8, t_max=4, seed=6)
    hidx = THNSW(THCfg(dim=8, n_cap=100, m=4, ef_construction=16,
                       ef_search=16, max_level=1), max_external_id=100,
                 device="cpu")
    with pytest.raises(ValueError):
        t_run(hidx, rb, baseline="hnsw", segmented=True)
    with pytest.raises(ValueError):
        t_run(hidx, rb, baseline="nope")
    sidx = TStreaming(TCfg(dim=8, n_cap=128, r=8, l_build=16, l_search=16),
                      mode="local", device="cpu")
    with pytest.raises(TypeError):
        t_run(sidx, rb, baseline="hnsw")
    # the reference agrees on each refusal
    jrb = make_runbook("sliding_window", n=60, dim=8, t_max=4, seed=6)
    with pytest.raises(TypeError):
        run_runbook(JStreaming(JCfg(dim=8, n_cap=128, r=8, l_build=16,
                                    l_search=16), mode="local"),
                    jrb, baseline="hnsw")


def test_jax_built_hierarchy_continues_in_port():
    data = grid_data(260, 16, 13)
    queries = grid_data(8, 16, 14)
    kw = dict(dim=16, n_cap=240, m=8, ef_construction=32, ef_search=32,
              max_level=2)
    ji, ti = _pair(400, **kw)
    ji.insert(np.arange(180), data[:180])
    ji.delete(np.arange(0, 180, 3))
    ti.state = convert.hnsw_state_from_numpy(
        {f: np.asarray(v) for f, v in ji.state._asdict().items()}, "cpu")
    ti._ext2slot[:] = ji._ext2slot
    ti._slot2ext[:] = ji._slot2ext
    ti.rng.bit_generator.state = ji.rng.bit_generator.state
    back = convert.hnsw_state_to_numpy(ti.state)
    for f, v in ji.state._asdict().items():
        np.testing.assert_array_equal(np.asarray(v), back[f], err_msg=f)
    for idx in (ji, ti):
        idx.insert(np.arange(180, 260), data[180:260])
    assert_hnsw_equal(ji, ti, True, "continued")
    _search_equal(ji, ti, queries, True)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _table(n, d, seed, device):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(-64, 65, (n, d), generator=g).float() / 16).to(
        device)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("r,l,mv", [(96, 128, 192), (48, 1, 64)])
def test_beam_hop_kernel_at_hnsw_shapes(cuda_device, r, l, mv):
    """Kernel 3 at level 0 (r = m0 = 96: a hop with more than 64 fresh
    rows stages them in two rounds) and at an upper level's descent
    (r = m = 48, l = 1) against its plain version, bitwise on grid data."""
    from repro_torch.core import bitset
    from repro_torch.kernels import beam_hop as bh
    from repro_torch.kernels import gather_distance as gd

    n_cap, d, b = 5000, 128, 64
    g = torch.Generator().manual_seed(r)
    vec = _table(n_cap, d, 1, cuda_device)
    norms = (vec * vec).sum(1)
    adj = torch.randint(0, n_cap, (n_cap, r), generator=g,
                        dtype=torch.int32)
    adj[torch.rand((n_cap, r), generator=g) < 0.1] = -1
    adj = adj.to(cuda_device)
    nav = torch.ones(n_cap, dtype=torch.bool, device=cuda_device)
    ret = nav.clone()
    ret[::7] = False
    nav_w, ret_w = bitset.pack_bits(nav), bitset.pack_bits(ret)
    qb = vec[torch.arange(b) * 13].contiguous()
    fresh = (adj >= 0).sum(1)
    start = int(torch.argmax(fresh))
    assert r < 64 or int(fresh[start]) > 64
    starts = torch.full((b,), start, dtype=torch.int32, device=cuda_device)
    bi = torch.full((b, l), -1, dtype=torch.int32, device=cuda_device)
    bi[:, 0] = starts
    bd = torch.full((b, l), float("inf"), device=cuda_device)
    bd[:, 0] = gd.gather_distance_batched_plain(starts[:, None], qb, vec,
                                                norms)[:, 0]
    seen = bitset.setbits_rows(bitset.empty_rows(b, n_cap, cuda_device),
                               starts.long()[:, None],
                               torch.ones((b, 1), dtype=torch.bool,
                                          device=cuda_device))
    z = torch.zeros((b,), dtype=torch.int32, device=cuda_device)
    carry = (bi, bd, torch.zeros_like(bi), seen,
             torch.full((b, mv), -1, dtype=torch.int32, device=cuda_device),
             torch.full((b, mv), float("inf"), device=cuda_device),
             z, z + 1, z)
    static = (adj, vec, norms, nav_w, ret_w)
    for _ in range(4):
        p = bh.beam_hop_fused_plain(qb, *carry, *static, h=4)
        k = bh.beam_hop_fused_cuda(qb, *(t.clone() for t in carry), *static,
                                   h=4)
        for x, y in zip(k, p):
            assert torch.equal(x, y)
        carry = p


@pytest.mark.requires_cuda
@pytest.mark.parametrize("k", [96, 48])
def test_bound_gather_at_hnsw_widths(cuda_device, k):
    """Kernel 2 bound to one query at an insert's widths (K = m0, m)."""
    from repro_torch.kernels import gather_distance as gd

    vec = _table(3000, 128, 2, cuda_device)
    norms = (vec * vec).sum(1)
    g = torch.Generator().manual_seed(k)
    for i in range(4):
        ids = torch.randint(-1, 3000, (k,), generator=g,
                            dtype=torch.int32).to(cuda_device)
        q = vec[i * 7]
        assert torch.equal(gd.BoundGather(q, vec, norms)(ids),
                           gd.gather_distance_plain(ids, q, vec, norms))


@pytest.mark.requires_cuda
def test_hnsw_cuda_engine_matches_plain(cuda_device):
    """The whole hierarchy through a delete-and-replace round, cuda engine
    against the plain engine on the card: identical states and answers."""
    data, queries = grid_data(300, 32, 15), grid_data(16, 32, 16)
    runs = []
    for backend in ("cuda", "torch"):
        idx = THNSW(THCfg(dim=32, n_cap=240, m=8, ef_construction=32,
                          ef_search=32, max_level=2, backend=backend),
                    max_external_id=400, device=cuda_device)
        idx.insert(np.arange(160), data[:160])
        idx.delete(np.arange(0, 160, 2))
        idx.insert(np.arange(160, 240), data[160:240])
        runs.append((idx.state, idx.search(queries, k=10)))
    (sa, ra), (sb, rb) = runs
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)
    for x, y in zip(ra, rb):
        np.testing.assert_array_equal(x, y)
