"""The port's recsys family (``repro_torch.models.recsys``,
``repro_torch.configs``, ``repro_torch.data``) and the twin of
``examples/distributed_serving.py`` against the reference (``repro``), on
the CPU.

The same numpy parameters and inputs go through both packages
(``repro_torch.convert.params_from_numpy`` / ``params_to_numpy``).  On
grid-valued data (entries k/4, |k| <= 2, where every sum and product of
these reduced widths is exact in float32: checked against float64) the
polynomial outputs — DLRM logits, two-tower embeddings, scores and
retrieval top-k — agree bitwise.  An output that passes through an
exponential (DIN's softmax, the serving sigmoid, the losses' log1p / exp /
logsumexp) is held to rtol 2e-5 / atol 1e-5 on grid data too: XLA's and
PyTorch's float32 ``exp`` differ in the last bit on about a tenth of
inputs.  Gaussian data: ids exactly, values to rtol 2e-5 / atol 1e-5.

The parity traps each have a case: ``jnp.take``'s NaN rows and wrapping
(``take_rows``), ``lax.top_k``'s tie order (planted ties, one- and
two-phase), ``segment_sum``'s unsorted ids (``embedding_bag``), the
``triu_indices`` order of DLRM's interaction, DIN's empty history, the
stable ``bce_loss``.  The four archs' shapes, cells, FLOPs and reduced
specs equal the reference's, their ``abstract_state`` /
``abstract_inputs`` at full width (on ``meta``) equal the reference's
``jax.eval_shape``, and each reduced spec's serve and retrieval steps equal
``jax.jit(spec.make_step(shape))``.

Card cases (``python -m pytest --noconftest -m requires_cuda
tests/test_torch_recsys.py``) hold the reduced steps (serve, retrieval and
train) and the twin's path B on the card against the CPU; JAX is imported
inside the CPU tests only.
"""
import contextlib
import dataclasses
import io
import os
import sys

import numpy as np
import pytest
import torch

from torch_parity import (ATOL, RTOL, assert_train_step_close,  # noqa: F401
                          cuda_device)

from repro_torch import convert
from repro_torch.configs import all_archs
from repro_torch.data import ClickStream, TokenStream
from repro_torch.models import recsys as tr

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples"))
import distributed_serving_torch as twin  # noqa: E402

ARCHS = ("din", "dlrm-mlperf", "dlrm-rm2", "two-tower-retrieval")
SERVE_SHAPES = ("serve_p99", "serve_bulk", "retrieval_cand")
DEMO_ITEMS = 256


def _grid(shape, rng, step=4):
    return (rng.integers(-2, 3, size=shape) / step).astype(np.float32)


def _gridify(tree, rng, key=None):
    """Every float leaf of a numpy tree replaced by grid values: entries
    k/4, |k| <= 2; an MLP's weights ``w`` k/2, |k| <= 1 (so that each layer
    adds one bit to the grid's resolution, not two)."""
    if isinstance(tree, dict):
        return {k: _gridify(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_gridify(v, rng, key) for v in tree]
    if tree.dtype == np.float32:
        return (_grid(tree.shape, rng, 4) if key != "w" else
                (rng.integers(-1, 2, size=tree.shape) / 2).astype(
                    np.float32))
    return tree


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _close(a, b, exact, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape,
                                                       b.shape)
    if exact or not np.issubdtype(a.dtype, np.floating):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=what)


def _ref_params(init, cfg, data, seed=0):
    """The reference's seeded init as numpy, or grid values in its tree."""
    import jax

    p = _np(init(jax.random.PRNGKey(seed), cfg))
    return _gridify(p, np.random.default_rng(seed)) if data == "grid" else p


def _jit(fn):
    """A reference function jitted with its config static (one compile,
    not one per primitive)."""
    import jax

    return jax.jit(fn, static_argnums=1)


def _exact_in_f32(fn, params, *args):
    """The port's ``fn`` in float32 equals it in float64: every sum of the
    data is exact (the precondition of a bitwise comparison)."""
    def to64(t):
        return t.double() if t.is_floating_point() else t

    out32 = fn(params, *args)
    out64 = fn(_map(to64, params), *(_map(to64, a) for a in args))
    for x, y in zip(_seq(out32), _seq(out64)):
        np.testing.assert_array_equal(x.double().numpy(), y.numpy())


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _seq(x):
    return x if isinstance(x, tuple) else (x,)


def _t(x):
    return convert.params_from_numpy(x, "cpu")


# ---------------------------------------------------------------------------
# the parity traps
# ---------------------------------------------------------------------------


def test_take_rows_nan_rows_and_wrap():
    import jax.numpy as jnp

    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([[0, -1, 4], [-4, -5, 7]], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    got = tr.take_rows(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want[0, 2]).all() and (want[0, 1] == table[-1]).all()


@pytest.mark.parametrize("model", ["dlrm", "din", "two_tower"])
def test_out_of_range_ids_through_the_forwards(model):
    """An id past the table and ``-1`` through each forward: the port's
    NaN rows and wrapped rows give the reference's outputs (NaN where
    the reference's are)."""
    from repro.models import recsys as jr

    rng = np.random.default_rng(3)
    if model == "dlrm":
        cfg = tr.DLRMConfig(name="t", embed_dim=8, bot_mlp=(13, 16, 8),
                            top_mlp=(16, 8, 1), vocab_sizes=(7, 11, 5))
        p = _ref_params(jr.init_dlrm_params, cfg, "gauss")
        dense = rng.normal(size=(4, 13)).astype(np.float32)
        sparse = np.array([[0, 1, 2], [6, -1, 4], [7, 3, 1], [2, 2, -6]],
                          np.int32)
        want = _jit(jr.dlrm_forward)(p, cfg, dense, sparse)
        got = tr.dlrm_forward(_t(p), cfg, _t(dense), _t(sparse))
    elif model == "din":
        cfg = tr.DINConfig(name="t", embed_dim=4, seq_len=5, attn_mlp=(8, 4),
                           mlp=(8, 4), item_vocab=9)
        p = _ref_params(jr.init_din_params, cfg, "gauss")
        hist = np.array([[1, 2, -1, 3, 0], [9, 1, 1, 1, 1],
                         [2, 3, 4, 5, 6]], np.int32)
        hist_len = np.array([3, 2, 5], np.int32)
        target = np.array([-1, 3, 12], np.int32)
        want = _jit(jr.din_forward)(p, cfg, hist, hist_len, target)
        got = tr.din_forward(_t(p), cfg, _t(hist), _t(hist_len), _t(target))
    else:
        cfg = tr.TwoTowerConfig(name="t", embed_dim=8, tower_mlp=(16, 8),
                                user_vocab=6, item_vocab=9)
        p = _ref_params(jr.init_two_tower_params, cfg, "gauss")
        users = np.array([0, -1, 6, 2], np.int32)
        items = np.array([-9, 8, 3, 9], np.int32)
        want = _jit(jr.two_tower_embed)(p, cfg, users, items)
        got = tr.two_tower_embed(_t(p), cfg, _t(users), _t(items))
    for w, g in zip(_seq(want), _seq(got)):
        w = np.asarray(w)
        assert np.isnan(w).any() and not np.isnan(w).all()
        _close(g.numpy(), w, False, model)


@pytest.mark.parametrize("n_blocks", [1, 2, 4, 8])
def test_score_candidates_planted_ties(n_blocks):
    """Scores tied in every block and across blocks: the ids are
    ``lax.top_k``'s (lower index first), one- and two-phase."""
    from repro.models import recsys as jr

    assert tr._top_k(torch.tensor([[1., 3, 3, 2, 3]]), 3)[1].tolist() == \
        [[1, 2, 4]]
    cfg = tr.TwoTowerConfig(name="t", embed_dim=8, tower_mlp=(8, 4),
                            user_vocab=4, item_vocab=16)
    p = _ref_params(jr.init_two_tower_params, cfg, "grid", seed=n_blocks)
    rng = np.random.default_rng(n_blocks)
    # 1,024 candidates drawn from 6 distinct rows: every score is tied
    cand = _grid((6, 4), rng)[rng.integers(0, 6, size=1024)]
    users = np.array([0, 3], np.int32)
    want = jr.two_tower_score_candidates(p, cfg, users, cand, k=100,
                                         n_blocks=n_blocks)
    got = tr.two_tower_score_candidates(_t(p), cfg, _t(users), _t(cand),
                                        k=100, n_blocks=n_blocks)
    _close(got[0].numpy(), want[0], True, "scores")
    _close(got[1].numpy(), want[1], True, "ids")


@pytest.mark.parametrize("mode", ["sum", "mean", "weighted"])
def test_embedding_bag_unsorted_segments(mode):
    """Unsorted segment ids, an empty bag, segment ids outside the range
    (dropped), an out-of-range id (NaN row, in a dropped segment)."""
    from repro.models import recsys as jr

    rng = np.random.default_rng(5)
    table = rng.normal(size=(10, 6)).astype(np.float32)
    ids = np.array([3, 1, 7, 1, 0, 9, 4, 12, 2], np.int32)
    seg = np.array([2, 0, 2, 4, 0, -1, 2, 6, 4], np.int32)
    w = rng.normal(size=ids.shape).astype(np.float32)
    kw = {"weights": w} if mode == "weighted" else {}
    m = "sum" if mode == "weighted" else mode
    want = np.asarray(jr.embedding_bag(table, ids, seg, 6, mode=m, **kw))
    got = tr.embedding_bag(_t(table), _t(ids), _t(seg), 6, mode=m,
                           **{k: _t(v) for k, v in kw.items()})
    assert (want[[1, 3, 5]] == 0).all() and np.isfinite(want).all()
    _close(got.numpy(), want, False, mode)


@pytest.mark.parametrize("f", [2, 5, 27])
def test_triu_indices_order(f):
    import jax.numpy as jnp

    iu, ju = jnp.triu_indices(f, k=1)
    got = torch.triu_indices(f, f, offset=1)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(iu))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ju))


def test_din_empty_history_is_finite():
    from repro.models import recsys as jr

    cfg = tr.DINConfig(name="t", embed_dim=4, seq_len=6, attn_mlp=(8, 4),
                       mlp=(8, 4), item_vocab=20)
    p = _ref_params(jr.init_din_params, cfg, "gauss")
    rng = np.random.default_rng(2)
    hist = rng.integers(0, 20, size=(3, 6)).astype(np.int32)
    hist_len = np.array([0, 0, 4], np.int32)
    target = np.array([1, 5, 7], np.int32)
    want = np.asarray(_jit(jr.din_forward)(p, cfg, hist, hist_len, target))
    got = tr.din_forward(_t(p), cfg, _t(hist), _t(hist_len), _t(target))
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    _close(got.numpy(), want, False, "din hist_len 0")


def test_bce_loss_stable_form():
    from repro.models import recsys as jr

    logits = np.array([-200.0, -3.5, -1e-3, 0.0, 2.25, 90.0, 150.0],
                      np.float32)
    labels = np.array([0, 1, 1, 0, 1, 0, 1], np.float32)
    want = float(jr.bce_loss(logits, labels))
    got = tr.bce_loss(_t(logits), _t(labels))
    assert np.isfinite(want) and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# forwards and losses at reduced widths
# ---------------------------------------------------------------------------


def _dlrm_case(data, rng):
    from repro.models import recsys as jr

    cfg = tr.DLRMConfig(name="t", embed_dim=16, bot_mlp=(13, 32, 16),
                        top_mlp=(32, 16, 1),
                        vocab_sizes=(50, 7, 300, 20, 3, 99))
    p = _ref_params(jr.init_dlrm_params, cfg, data)
    b = 24
    dense = (_grid((b, 13), rng) if data == "grid"
             else rng.normal(size=(b, 13)).astype(np.float32))
    sparse = np.stack([rng.integers(0, v, size=b) for v in cfg.vocab_sizes],
                      1).astype(np.int32)
    labels = (rng.uniform(size=b) < 0.3).astype(np.float32)
    batch = {"dense": dense, "sparse": sparse, "labels": labels}
    return (cfg, p, batch, (dense, sparse), jr.dlrm_forward, tr.dlrm_forward,
            jr.dlrm_loss, tr.dlrm_loss, True)


def _din_case(data, rng):
    from repro.models import recsys as jr

    cfg = tr.DINConfig(name="t", embed_dim=6, seq_len=9, attn_mlp=(16, 8),
                       mlp=(20, 8), item_vocab=200)
    p = _ref_params(jr.init_din_params, cfg, data)
    b = 16
    hist = rng.integers(0, 200, size=(b, 9)).astype(np.int32)
    hist_len = rng.integers(0, 10, size=b).astype(np.int32)
    target = rng.integers(0, 200, size=b).astype(np.int32)
    labels = (rng.uniform(size=b) < 0.3).astype(np.float32)
    batch = {"hist": hist, "hist_len": hist_len, "target": target,
             "labels": labels}
    return (cfg, p, batch, (hist, hist_len, target), jr.din_forward,
            tr.din_forward, jr.din_loss, tr.din_loss, False)


def _two_tower_case(data, rng):
    from repro.models import recsys as jr

    cfg = tr.TwoTowerConfig(name="t", embed_dim=16, tower_mlp=(32, 16, 8),
                            user_vocab=100, item_vocab=150)
    p = _ref_params(jr.init_two_tower_params, cfg, data)
    b = 32
    users = rng.integers(0, 100, size=b).astype(np.int32)
    items = rng.integers(0, 150, size=b).astype(np.int32)
    batch = {"user_ids": users, "item_ids": items}
    return (cfg, p, batch, (users, items), jr.two_tower_embed,
            tr.two_tower_embed, jr.two_tower_loss, tr.two_tower_loss, True)


CASES = {"dlrm": _dlrm_case, "din": _din_case, "two_tower": _two_tower_case}


@pytest.mark.parametrize("data", ["grid", "gauss"])
@pytest.mark.parametrize("model", sorted(CASES))
def test_forward_and_loss_match_reference(model, data):
    rng = np.random.default_rng(11)
    (cfg, p, batch, args, j_fwd, t_fwd, j_loss, t_loss,
     polynomial) = CASES[model](data, rng)
    tp = _t(p)
    targs = tuple(_t(a) for a in args)
    grid = data == "grid"
    if grid and polynomial:
        _exact_in_f32(lambda q, *a: t_fwd(q, cfg, *a), tp, *targs)
    want = _jit(j_fwd)(p, cfg, *args)
    got = t_fwd(tp, cfg, *targs)
    for w, g in zip(_seq(want), _seq(got)):
        _close(g.numpy(), np.asarray(w), grid and polynomial, model)
    want_l = float(_jit(j_loss)(p, cfg, batch))
    got_l = t_loss(tp, cfg, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got_l), want_l, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("data", ["grid", "gauss"])
def test_score_candidates_matches_reference(data):
    from repro.models import recsys as jr

    rng = np.random.default_rng(13)
    cfg = tr.TwoTowerConfig(name="t", embed_dim=16, tower_mlp=(32, 16, 8),
                            user_vocab=100, item_vocab=150)
    p = _ref_params(jr.init_two_tower_params, cfg, data)
    cand = (_grid((640, 8), rng) if data == "grid"
            else rng.normal(size=(640, 8)).astype(np.float32))
    users = np.array([3, 77, 0], np.int32)
    for n_blocks in (1, 5):
        want = jr.two_tower_score_candidates(p, cfg, users, cand, k=100,
                                             n_blocks=n_blocks)
        got = tr.two_tower_score_candidates(_t(p), cfg, _t(users), _t(cand),
                                            k=100, n_blocks=n_blocks)
        _close(got[0].numpy(), np.asarray(want[0]), data == "grid", "scores")
        _close(got[1].numpy(), np.asarray(want[1]), True, "ids")


@pytest.mark.parametrize("model", sorted(CASES))
def test_modules_run_the_functions(model):
    """``DLRM`` / ``DIN`` / ``TwoTower`` over a tree loaded by
    ``convert.module_from_numpy``: the functions' outputs, parameters named
    by the tree's paths, ``tree()`` and ``params_to_numpy`` giving the
    numpy tree back."""
    rng = np.random.default_rng(17)
    cfg, p, _, args, _, t_fwd, _, _, _ = CASES[model]("gauss", rng)
    cls = {"dlrm": tr.DLRM, "din": tr.DIN, "two_tower": tr.TwoTower}[model]
    mod = convert.module_from_numpy(cls, cfg, p, "cpu")
    targs = tuple(_t(a) for a in args)
    with torch.no_grad():
        for a, b in zip(_seq(mod(*targs)),
                        _seq(t_fwd(mod.tree(), cfg, *targs))):
            assert torch.equal(a, b)
    back = convert.params_to_numpy(mod.tree())
    import jax

    flat_a = jax.tree_util.tree_flatten_with_path(p)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (_, x), (_, y) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(x, y)
    names = {n for n, _ in mod.named_parameters()}
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in flat_a}
    assert names == want


# ---------------------------------------------------------------------------
# the four archs
# ---------------------------------------------------------------------------


def _jspec(arch, reduced=False):
    from repro.configs import all_archs as j_all

    s = j_all()[arch]
    return s.reduced() if reduced else s


def _flat_torch(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_torch(v, f"{prefix}['{k}']"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_torch(v, f"{prefix}[{i}]"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[1],
                     tree.is_meta)}


def _flat_jax(tree):
    import jax

    return {jax.tree_util.keystr(p): (tuple(x.shape), str(np.dtype(x.dtype)),
                                      True)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _cfg_fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_spec_matches_reference(arch, reduced):
    j = _jspec(arch, reduced)
    t = all_archs()[arch]
    t = t.reduced() if reduced else t
    assert t.name == j.name and t.family == j.family
    assert t.scale == j.scale
    assert _cfg_fields(t.cfg) == _cfg_fields(j.cfg)
    assert _cfg_fields(t._padded_cfg()) == _cfg_fields(j._padded_cfg())
    assert t.cfg.n_params() == j.cfg.n_params()
    assert ({k: dataclasses.asdict(v) for k, v in t.shapes().items()}
            == {k: dataclasses.asdict(v) for k, v in j.shapes().items()})
    assert t.cells() == j.cells() and t.skipped_cells() == j.skipped_cells()
    for shape in t.shapes().values():
        assert t.model_flops(shape) == j.model_flops(shape), shape.name
    assert t.reduced().name == j.reduced().name


def test_registry_lists_the_recsys_archs():
    """The recsys archs, and every arch of the reference's registry."""
    from repro.configs import all_archs as j_all
    from repro_torch.configs import get_arch

    assert set(ARCHS) <= set(all_archs())
    assert sorted(all_archs()) == sorted(j_all())
    with pytest.raises(KeyError) as e:
        get_arch("nope")
    assert "unknown arch 'nope'; available: ['din', " in str(e.value)


@pytest.mark.parametrize("shape_name", ["train_batch", *SERVE_SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_at_full_width(arch, shape_name):
    """``abstract_state`` / ``abstract_inputs`` on ``meta`` at full width:
    the reference's ``jax.eval_shape`` tree, shapes and dtypes, nothing
    allocated."""
    j = _jspec(arch)
    t = all_archs()[arch]
    js, ts = j.shapes()[shape_name], t.shapes()[shape_name]
    assert _flat_torch(t.abstract_state(ts)) == _flat_jax(
        j.abstract_state(js))
    assert _flat_torch(t.abstract_inputs(ts)) == _flat_jax(
        j.abstract_inputs(js))


@pytest.mark.parametrize("data", ["grid", "gauss"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, data):
    """The reduced spec's ``train_batch`` step against ``jax.jit`` of the
    reference's (on Gaussian data two steps, the second from the
    reference's state, so the moments are not zero): loss, params, m, v and step to the whole-step
    tolerances of ``torch_parity.assert_train_step_close``."""
    import jax

    t, j = all_archs()[arch].reduced(), _jspec(arch, reduced=True)
    shape = t.shapes()["train_batch"]
    gen = torch.Generator().manual_seed(5)
    state = convert.params_to_numpy(t.init_state(shape, "cpu", gen))
    inputs = convert.params_to_numpy(t.make_inputs(shape, "cpu", gen))
    if data == "grid":
        rng = np.random.default_rng(5)
        state["params"] = _gridify(state["params"], rng)
        inputs = _gridify(inputs, rng)
    j_step = jax.jit(j.make_step(j.shapes()["train_batch"]))
    t_step = t.make_step(shape)
    # grid data: one step (its forward is exact, so a ReLU input of 0 is 0
    # on both sides; after an update such inputs sit within rounding of the
    # kink and the two sides' ReLUs may differ)
    for i in range(1 if data == "grid" else 2):
        jstate, jout = j_step(state, inputs)
        tstate, tout = t_step(_t(state), _t(inputs))
        assert sorted(tout) == ["loss"] and sorted(tstate) == ["opt",
                                                               "params"]
        assert_train_step_close(tstate, tout, jstate, jout,
                                where=f"{arch} {data} step {i}")
        state = _np(jstate)


def test_bce_loss_gradient_at_zero():
    """A logit of exactly 0: ``jnp.maximum``'s gradient there is 0.5 and
    ``jnp.abs``'s 1, so d/dz = 0.5 - y + (-1) * 0.5 = -y; the port's
    gradient equals the reference's at every logit."""
    import jax

    from repro.models import recsys as jr

    logits = np.array([0.0, 0.0, -1.5, 0.0, 2.0, 0.0], np.float32)
    labels = np.array([0, 1, 1, 0, 0, 1], np.float32)
    want = np.asarray(jax.grad(jr.bce_loss)(logits, labels))
    z = _t(logits).requires_grad_()
    tr.bce_loss(z, _t(labels)).backward()
    np.testing.assert_allclose(z.grad.numpy(), want, rtol=RTOL, atol=ATOL)
    at0 = [0, 1, 3, 5]
    np.testing.assert_array_equal(z.grad.numpy()[at0], want[at0])
    np.testing.assert_allclose(want[at0], -labels[at0] / len(logits),
                               atol=1e-7)


def test_take_rows_gradient_drops_nan_rows():
    """The gradient of ``take_rows`` is ``jnp.take``'s: a dense scatter-add
    into the table, wrapped ids on their rows, nothing from the NaN rows of
    out-of-range ids."""
    import jax
    import jax.numpy as jnp

    table = np.arange(15, dtype=np.float32).reshape(5, 3)
    ids = np.array([1, -1, 5, 1, -7, 0], np.int32)
    w = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)

    def f(tab):
        rows = jnp.take(tab, ids, axis=0)
        return jnp.sum(jnp.where(jnp.isnan(rows), 0.0, rows) * w)

    want = np.asarray(jax.grad(f)(table))
    tab = _t(table).requires_grad_()
    rows = tr.take_rows(tab, _t(ids))
    torch.sum(torch.nan_to_num(rows, nan=0.0) * _t(w)).backward()
    np.testing.assert_array_equal(tab.grad.numpy(), want)
    assert tab.grad.layout == torch.strided


def test_two_tower_loss_in_row_blocks(monkeypatch):
    """The in-batch loss recomputed per block of rows under autograd
    (``torch.utils.checkpoint``): the loss equals the unblocked
    computation's bitwise (each row's arithmetic is the same), the
    gradients to rtol 1e-5 / atol 1e-6 of each one's largest value (the
    item side's gradient sums block by block)."""
    from repro.models import recsys as jr

    rng = np.random.default_rng(7)
    cfg = tr.TwoTowerConfig(name="t", embed_dim=8, tower_mlp=(16, 8),
                            user_vocab=40, item_vocab=50)
    p = _ref_params(jr.init_two_tower_params, cfg, "gauss")
    batch = _t({"user_ids": rng.integers(0, 40, 37).astype(np.int32),
                "item_ids": rng.integers(0, 50, 37).astype(np.int32)})
    out = []
    for block in (tr.LOGIT_BLOCK, 37 * 5):           # one block; 8 blocks
        monkeypatch.setattr(tr, "LOGIT_BLOCK", block)
        params = _map(lambda x: x.clone().requires_grad_(), _t(p))
        loss = tr.two_tower_loss(params, cfg, batch)
        leaves = [params["user_emb"], params["item_emb"],
                  *params["user_tower"]["w"], *params["item_tower"]["w"]]
        out.append([loss.detach()] + list(torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1:], out[1][1:]):
        torch.testing.assert_close(b, a, rtol=1e-5,
                                   atol=1e-6 * float(a.abs().max()))


def test_din_empty_history_has_finite_gradients():
    """``hist_len = 0`` masks every score but position 0: the loss and
    every gradient are finite."""
    from repro.models import recsys as jr
    from repro_torch.training import value_and_grad
    from repro_torch.training.optimizer import tree_leaves

    cfg = tr.DINConfig(name="t", embed_dim=4, seq_len=6, attn_mlp=(8, 4),
                       mlp=(8, 4), item_vocab=20)
    p = _t(_ref_params(jr.init_din_params, cfg, "gauss"))
    batch = _t({"hist": np.arange(18, dtype=np.int32).reshape(3, 6),
                "hist_len": np.array([0, 0, 3], np.int32),
                "target": np.array([1, 5, 7], np.int32),
                "labels": np.array([1, 0, 1], np.float32)})
    loss, grads = value_and_grad(
        lambda q, b: tr.din_loss(q, cfg, b))(p, batch)
    assert torch.isfinite(loss)
    for g in tree_leaves(grads):
        assert torch.isfinite(g).all()


def _step_pair(arch, shape_name, data, seed=0, two_phase=None):
    """The reduced spec's state and inputs (the port's seeded init, grid
    values on ``data == "grid"``) through the port's step and the
    reference's jitted one."""
    import jax

    from repro.configs.base import MeshAxes

    from repro_torch.configs.base import MeshAxes as TMeshAxes

    t, j = all_archs()[arch].reduced(), _jspec(arch, reduced=True)
    axes = taxes = None
    if two_phase:
        t = dataclasses.replace(t, two_phase_topk=True)
        j = dataclasses.replace(j, two_phase_topk=True)
        axes = MeshAxes(dp=("data",), fsdp="data", model="model",
                        dp_size=two_phase // 2, model_size=2)
        taxes = TMeshAxes(dp=("data",), fsdp="data", model="model",
                          dp_size=two_phase // 2, model_size=2)
    shape = t.shapes()[shape_name]
    gen = torch.Generator().manual_seed(seed)
    state = convert.params_to_numpy(t.init_state(shape, "cpu", gen))
    inputs = convert.params_to_numpy(t.make_inputs(shape, "cpu", gen))
    if data == "grid":
        rng = np.random.default_rng(seed)
        state, inputs = _gridify(state, rng), _gridify(inputs, rng)
    _, jout = jax.jit(j.make_step(j.shapes()[shape_name], axes))(
        state, inputs)
    tstate, tinputs = _t(state), _t(inputs)
    step = t.make_step(shape, taxes)
    new, tout = step(tstate, tinputs)
    assert new is tstate
    if data == "grid" and arch == "two-tower-retrieval":
        _exact_in_f32(lambda st, inp: tuple(
            v for _, v in sorted(step(st, inp)[1].items())), tstate, tinputs)
    return t, jout, tout


@pytest.mark.parametrize("data", ["grid", "gauss"])
@pytest.mark.parametrize("shape_name", SERVE_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_step_matches_reference(arch, shape_name, data):
    _, jout, tout = _step_pair(arch, shape_name, data)
    assert sorted(jout) == sorted(tout)
    # two-tower's outputs are sums of products; DLRM's and DIN's pass
    # through the sigmoid
    exact = data == "grid" and arch == "two-tower-retrieval"
    for key in jout:
        got = tout[key].numpy()
        assert np.isfinite(got).all()
        _close(got, np.asarray(jout[key]), exact, f"{arch} {key}")


def test_two_phase_retrieval_step_matches_reference():
    _, jout, tout = _step_pair("two-tower-retrieval", "retrieval_cand",
                               "grid", seed=4, two_phase=8)
    for key in jout:
        _close(tout[key].numpy(), np.asarray(jout[key]), True, key)


# ---------------------------------------------------------------------------
# data streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 7])
def test_streams_bitwise(step):
    from repro.data.pipeline import ClickStream as JClick
    from repro.data.pipeline import TokenStream as JToken

    from repro.models.recsys import CRITEO_KAGGLE_VOCABS as JV

    assert tr.CRITEO_KAGGLE_VOCABS == JV
    kw = dict(n_dense=13, vocab_sizes=tr.CRITEO_KAGGLE_VOCABS, batch=64,
              seed=3)
    a, b = ClickStream(**kw).batch_at(step), JClick(**kw).batch_at(step)
    tk = dict(vocab=1000, batch=8, seq=16, seed=5)
    c, d = TokenStream(**tk).batch_at(step), JToken(**tk).batch_at(step)
    e = TokenStream(**tk).host_shard(step, 1, 4)
    f = JToken(**tk).host_shard(step, 1, 4)
    for x, y in ((a, b), (c, d), (e, f)):
        assert sorted(x) == sorted(y)
        for key in x:
            assert x[key].dtype == y[key].dtype
            np.testing.assert_array_equal(x[key], y[key])


def test_criteo_vocabularies_are_the_references():
    from repro.models import recsys as jr

    assert tr.CRITEO_KAGGLE_VOCABS == jr.CRITEO_KAGGLE_VOCABS
    assert tr.CRITEO_TB_VOCABS == jr.CRITEO_TB_VOCABS


# ---------------------------------------------------------------------------
# the twin of examples/distributed_serving.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_twin():
    """The reference example's steps at ``DEMO_ITEMS`` items: its params,
    item embeddings and user vector, and its sharded index's answers on a
    1-device mesh with ``n_logical=8`` (the example's 8-device mesh; the
    reference's answers do not depend on the layout)."""
    import jax

    from repro.configs.ann import test_scale as j_test_scale
    from repro.core.distributed import ShardedIndex as JShard
    from repro.models import recsys as jr

    cfg_tt = jr.TwoTowerConfig(name="demo", embed_dim=64,
                               tower_mlp=(128, 64, 32), user_vocab=1000,
                               item_vocab=DEMO_ITEMS)
    params = jr.init_two_tower_params(jax.random.PRNGKey(0), cfg_tt)
    item_embs = np.asarray(jr._mlp(params["item_tower"], params["item_emb"]))
    user_vec = np.asarray(jr._mlp(params["user_tower"],
                                  params["user_emb"][:1]))
    cfg = j_test_scale(item_embs.shape[1], n_cap=DEMO_ITEMS, metric="ip")
    idx = JShard(cfg, jax.make_mesh((1,), ("shard",)), n_logical=8)
    ext = np.arange(DEMO_ITEMS)
    idx.insert(ext, item_embs)
    before = idx.search(user_vec, k=10, l=32)
    idx.delete(ext[::2])
    after = idx.search(user_vec, k=10, l=32)
    return {"params": _np(params), "item_embs": np.array(item_embs),
            "user_vec": np.array(user_vec), "before": before, "after": after}


def _assert_answers_equal(got, want, where):
    for name, x, y in zip(("ids", "owner rows"), got[:2], want[:2]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{where} {name}")
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(want[2]),
                               rtol=RTOL, atol=ATOL, err_msg=f"{where} dists")
    assert int(got[3]) == int(want[3]), f"{where} comps"


def test_twin_embeds_the_references_catalogue(ref_twin):
    model = tr.TwoTower(twin.demo_config(DEMO_ITEMS),
                        _t(ref_twin["params"]))
    items, user = twin.embed(model)
    _close(items.numpy(), ref_twin["item_embs"], False, "item embeddings")
    _close(user.numpy(), ref_twin["user_vec"], False, "user vector")


@pytest.mark.parametrize("s", [1, 2, 8])
def test_twin_path_b_matches_reference(ref_twin, s):
    """The reference's item embeddings into the port's ``ShardedIndex`` on
    ``["cpu"] * S`` (L = 8): ids, owner rows and comps equal before and
    after the half-catalogue delete, and no deleted id served."""
    idx, res = twin.path_b(ref_twin["item_embs"], ref_twin["user_vec"],
                           ["cpu"] * s, n_logical=8)
    assert idx.n_shards == s and idx.n_logical == 8
    _assert_answers_equal(res["before"], ref_twin["before"], f"S={s} before")
    _assert_answers_equal(res["after"], ref_twin["after"], f"S={s} after")
    assert not np.isin(res["after"][0], res["drop"]).any()
    assert idx.n_active == DEMO_ITEMS - len(res["drop"])


def test_twin_main_on_the_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = twin.main(["--device", "cpu", "--n-items", str(DEMO_ITEMS)])
    lines = buf.getvalue().splitlines()
    assert lines[0] == f"embedded {DEMO_ITEMS} items -> 32-d"
    assert lines[1].startswith("exact top-10 (fused kernel): [")
    assert lines[2] == "sharded index built over 8 shards"
    assert lines[3].startswith("graph fan-out top-10: [") and \
        "recall vs exact = " in lines[3]
    assert lines[4] == (f"after deleting {DEMO_ITEMS // 2} items in place: "
                        f"top-10 contains no deleted items — OK")
    assert not np.isin(res["after"][0], res["drop"]).any()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.requires_cuda
def test_reduced_steps_on_card(cuda_device):
    """Each reduced spec's serve and retrieval steps on the card equal the
    same step on a CPU copy of the state and inputs."""
    for arch in ARCHS:
        t = all_archs()[arch].reduced()
        for name in SERVE_SHAPES:
            shape = t.shapes()[name]
            gen = torch.Generator(device=cuda_device).manual_seed(1)
            state = t.init_state(shape, cuda_device, gen)
            inputs = t.make_inputs(shape, cuda_device, gen)
            step = t.make_step(shape)
            _, out = step(state, inputs)
            _, ref = step(_map(lambda x: x.cpu(), state),
                          _map(lambda x: x.cpu(), inputs))
            for key in ref:
                _close(out[key].cpu().numpy(), ref[key].numpy(), False,
                       f"{arch} {name} {key}")


@pytest.mark.requires_cuda
def test_reduced_train_steps_on_card(cuda_device):
    """Each reduced spec's train step on the card against the same step on
    a CPU copy, two steps, to the whole-step tolerances of
    ``torch_parity.assert_train_step_close`` (the card's scatter-adds and
    reductions run in other orders)."""
    for arch in ARCHS:
        t = all_archs()[arch].reduced()
        shape = t.shapes()["train_batch"]
        gen = torch.Generator(device=cuda_device).manual_seed(2)
        state = t.init_state(shape, cuda_device, gen)
        inputs = t.make_inputs(shape, cuda_device, gen)
        cpu_state = _map(lambda x: x.cpu().clone(), state)
        cpu_in = _map(lambda x: x.cpu(), inputs)
        step = t.make_step(shape)
        for i in range(2):
            state, out = step(state, inputs)
            cpu_state, cpu_out = step(cpu_state, cpu_in)
            assert_train_step_close(state, out,
                                    convert.params_to_numpy(cpu_state),
                                    {"loss": cpu_out["loss"].numpy()},
                                    where=f"{arch} step {i}")


@pytest.mark.requires_cuda
def test_twin_path_b_on_card(cuda_device):
    rng = np.random.default_rng(0)
    items = (rng.integers(-64, 65, size=(DEMO_ITEMS, 32)) / 16).astype(
        np.float32)
    user = items[:2] + np.float32(1 / 16)
    _, a = twin.path_b(items, user, [cuda_device] * 2, n_logical=8)
    _, b = twin.path_b(items, user, ["cpu"], n_logical=8)
    for key in ("before", "after"):
        for x, y in zip(a[key], b[key]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=key)
