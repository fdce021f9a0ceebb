"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: the same
numpy inputs go through the JAX reference (``repro``) and the PyTorch port
(``repro_torch``), and the outputs are compared.

Grid-valued data (entries k/16, |k| <= 64) makes every dot product, norm
and ``q2 + x2 - 2*prod`` exact in float32 in any summation order, so the two
packages must agree bitwise there while exact ties (every tie rule) are
common; ``qgrid_data`` does the same for the int8 tier.  Gaussian data
(``make_dataset``) is compared with the reference's own kernel bar: ids and
counters exactly, distances to rtol 2e-5, atol 1e-5.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

# One intra-op thread per process: the port's tests run small eager ops,
# and a run spread over several worker processes (pytest-xdist) with a
# pool of one thread per core in each spends most of its time contending
# for the cores (about 10x slower).  Every comparison below is bitwise on
# grid data or to a tolerance on Gaussian data, so the reduction order a
# thread count picks changes no outcome.
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 1e-5
INDEX_LEAVES = ("ext2slot", "slot2ext", "n_inserts", "n_deletes",
                "insert_comps", "delete_comps")


def grid_data(n: int, dim: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.integers(-64, 65, size=(n, dim)) / 16).astype(np.float32)


def qgrid_data(n: int, dim: int, seed: int) -> np.ndarray:
    """Grid data with one entry of each row at +-127/16: every row's int8
    scale is then exactly 2^-4, its codes are 16 * x, and the dequantized
    rows, their qnorms and every quantized distance are exact in float32."""
    rng = np.random.default_rng(seed)
    x = grid_data(n, dim, seed)
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    x[np.arange(n), rng.integers(0, dim, size=n)] = sign * 127 / 16
    return x.astype(np.float32)


def cfg_pair(**kw):
    """The same ``ANNConfig`` in both packages: (jax_cfg, torch_cfg).
    Backends are named per package (``jnp``/``torch`` by default)."""
    from repro.core.types import ANNConfig as JCfg
    from repro_torch.core.types import ANNConfig as TCfg

    jb = kw.pop("jax_backend", "jnp")
    tb = kw.pop("torch_backend", "torch")
    return JCfg(backend=jb, **kw), TCfg(backend=tb, **kw)


def small_kw(metric="l2", dim=24, n_cap=700):
    """The ``tests/conftest.py`` small_cfg widths."""
    return dict(dim=dim, n_cap=n_cap, r=12, l_build=32, l_search=32,
                l_delete=32, k_delete=16, n_copies=3, alpha=1.2,
                metric=metric)


def t(x, dtype=None):
    """numpy / jax array -> CPU torch tensor (uint32 keeps its bits as
    int32)."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    out = torch.from_numpy(np.array(a, copy=True))
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_index_numpy(state) -> dict:
    """A reference ``IndexState`` in the ``repro_torch.convert`` layout."""
    from repro.core.types import as_numpy_state

    d = {"graph": as_numpy_state(state.graph)}
    for f in INDEX_LEAVES:
        d[f] = np.asarray(getattr(state, f))
    return d


def jax_index_state(d: dict):
    """The ``repro_torch.convert`` numpy layout as a reference
    ``IndexState`` (``d["graph"]["quant"]`` None or ``{codes, scale,
    qnorms}``)."""
    import jax.numpy as jnp

    from repro.core.quant import QuantStore
    from repro.core.types import GraphState, IndexState

    g = dict(d["graph"])
    q = g.pop("quant", None)
    if q is not None:
        q = QuantStore(**{f: jnp.asarray(v) for f, v in q.items()})
    return IndexState(
        graph=GraphState(**{f: jnp.asarray(v) for f, v in g.items()},
                         quant=q),
        **{f: jnp.asarray(d[f]) for f in INDEX_LEAVES})


def assert_field(a, b, name, exact=True):
    a, b = n(a), n(b)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if b.dtype == np.uint32:
        b = b.view(np.int32)
    if exact or not np.issubdtype(a.dtype, np.floating):
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


def assert_index_equal(jstate, tstate, exact=True, where=""):
    """Every leaf of the two ``IndexState``s equal (floats to tolerance when
    ``exact`` is False)."""
    from repro_torch import convert

    a = jax_index_numpy(jstate)
    b = convert.index_state_to_numpy(tstate)
    for f, v in a["graph"].items():
        if v is None:
            assert b["graph"][f] is None, f"{where} graph.{f}"
            continue
        if f == "quant":
            assert b["graph"][f] is not None, f"{where} graph.quant"
            for qf, qv in v._asdict().items():
                assert_field(qv, b["graph"][f][qf],
                             f"{where} graph.quant.{qf}", exact)
            continue
        assert_field(v, b["graph"][f], f"{where} graph.{f}", exact)
    for f in INDEX_LEAVES:
        assert_field(a[f], b[f], f"{where} {f}", exact)


def assert_port_equal(a, b, where=""):
    """Every tensor leaf of two port trees (``IndexState``, results, ...)
    bitwise equal, wherever each lives."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()), where
        return
    if a is None:
        assert b is None, where
        return
    assert type(a) is type(b), where
    for f, x, y in zip(a._fields, a, b):
        assert_port_equal(x, y, f"{where}.{f}")


def assert_graph_equal(jgraph, tgraph, fields, exact=True, where=""):
    for f in fields:
        assert_field(getattr(jgraph, f), getattr(tgraph, f),
                     f"{where} {f}", exact)


def assert_search_equal(jres, tres, exact=True, where=""):
    """Ids, visited ids and counters exactly; distances bitwise on grid data
    or to tolerance."""
    for f in ("topk_ids", "visited_ids", "n_visited", "n_comps", "n_hops"):
        assert_field(getattr(jres, f), getattr(tres, f), f"{where} {f}")
    for f in ("topk_dists", "visited_dists"):
        assert_field(getattr(jres, f), getattr(tres, f), f"{where} {f}",
                     exact)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided inside the fixture, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


# A whole train step against the reference's jitted one (or the card's
# against the CPU's): ``repro_torch.training.tolerance`` states the
# tolerance, which ``chip_smoke.py`` phase 10 holds the card to as well.


def _array(x):
    """(numpy array, dtype name): a bfloat16 tensor or array widened to
    float32, which holds it exactly."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).split(".")[1]
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy(), \
            name
    a = np.asarray(x)
    return a, a.dtype.name


def assert_train_step_close(got_state, got_out, want_state, want_out,
                            where="", tol=None):
    """``got_*`` the port's step (tensors), ``want_*`` the reference's
    (arrays) or another run of the port's: the same tree, dtypes and
    shapes; the loss, moments, parameters and step count within
    ``repro_torch.training.tolerance.train_step_errors`` (``tol``, default
    ``F32_STEP``)."""
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.tolerance import (F32_STEP, flat,
                                                train_step_errors)

    got = {k: _array(x) for k, x in flat(got_state).items()}
    want = {k: _array(x) for k, x in flat(want_state).items()}
    assert list(got) == list(want), where
    for key in want:
        assert got[key][0].shape == want[key][0].shape and \
            got[key][1] == want[key][1], (where, key, got[key][1],
                                          want[key][1])

    def tensor(x):
        a, name = _array(x)
        return torch.from_numpy(
            np.array(a, dtype=np.float32 if name == "bfloat16" else None))

    _, bad = train_step_errors(
        tree_map(tensor, got_state), float(n(got_out["loss"])),
        tree_map(tensor, want_state), float(n(want_out["loss"])),
        tol=tol or F32_STEP)
    assert not bad, (where, bad)


# LM logits (the port's against the reference's, or the card's against the
# CPU's): ``repro_torch.training.tolerance.logits_errors`` states the
# tolerance per compute dtype, which ``chip_smoke.py`` phase 11 holds the
# card to as well.


def assert_logits_close(got, want, dtype=torch.float32, moe=False,
                        where=""):
    """``got`` a tensor, ``want`` an array or tensor of one shape, within
    ``LOGITS[dtype]`` (an MoE arch at bfloat16: on
    ``MOE_BF16_ROW_SHARE`` of the rows)."""
    from repro_torch.training.tolerance import logits_errors

    want = torch.from_numpy(np.asarray(_array(want)[0], dtype=np.float32))
    worst, share, ok = logits_errors(got, want, dtype, moe)
    assert got.shape == want.shape and ok, (where, worst, share)