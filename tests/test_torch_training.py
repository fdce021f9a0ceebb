"""The port's training package (``repro_torch.training``) against the
reference's (``repro.training``), on the CPU.

``adamw_update`` is fed the reference's own ``jax.grad`` gradients and the
same optimiser state, and held against the reference's ``adamw_update`` run
op by op (its expression as written; compiled, XLA fuses it with
multiply-adds).  Where the clip does not bind (its scale is then
exactly 1) the moments are bitwise the reference's, and so are the new
parameters wherever the bias corrections ``1 - b1 ** step`` and ``1 - b2 **
step`` agree, which over steps 1-5,000 is everywhere (``torch.pow`` and
XLA's ``pow`` differ in the last bit at some steps, ``1 -`` them at none);
at a step where they would differ the new parameters must be within one
ulp.  Where the clip binds, the global norm sums each leaf in
another order than XLA (rtol 1e-6 on the norm), and the outputs follow to
rtol 1e-5 / atol 1e-6 of each leaf's largest value (bfloat16 moments to
one bfloat16 ulp, as a rounding may flip).  The global norm adds
the leaves in ``jax.tree.leaves`` order (a planted case where insertion
order gives another float32 sum).  ``compressed_psum`` over a list of
per-device gradients equals the reference under ``jax.vmap`` with a named
axis, bitwise.  ``make_train_step`` at ``accum_steps`` 1 and 4 is held to
the whole-step tolerances of ``torch_parity.assert_train_step_close``.

Card cases (``python -m pytest --noconftest -m requires_cuda
tests/test_torch_training.py``) hold ``adamw_update`` and
``compressed_psum`` on the card against the CPU; JAX is imported inside
the CPU tests only.
"""
import numpy as np
import pytest
import torch

from torch_parity import assert_train_step_close, cuda_device  # noqa: F401

from repro_torch import convert
from repro_torch.models import recsys as tr
from repro_torch.training import (AdamWConfig, TrainStepConfig, adamw_init,
                                  adamw_update, compressed_psum,
                                  make_train_step)
from repro_torch.training import optimizer as topt

CFG = tr.DLRMConfig(name="t", embed_dim=8, bot_mlp=(13, 16, 8),
                    top_mlp=(16, 8, 1), vocab_sizes=(30, 7, 12, 5))
STEPS = (0, 5, 4999)


def _t(x):
    return convert.params_from_numpy(x, "cpu")


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _case(seed=0, b=32):
    """The reference's DLRM params, a batch, and its ``jax.grad``
    gradients of ``dlrm_loss`` (numpy trees)."""
    import jax

    from repro.models import recsys as jr

    rng = np.random.default_rng(seed)
    params = _np(jr.init_dlrm_params(jax.random.PRNGKey(seed), CFG))
    batch = {
        "dense": rng.normal(size=(b, 13)).astype(np.float32),
        "sparse": np.stack([rng.integers(0, v, size=b)
                            for v in CFG.vocab_sizes], 1).astype(np.int32),
        "labels": (rng.uniform(size=b) < 0.3).astype(np.float32),
    }
    grads = _np(jax.jit(jax.grad(
        lambda p, x: jr.dlrm_loss(p, CFG, x)))(params, batch))
    return params, batch, grads


def _opt_state(params, step, moment_dtype, seed=1):
    """m ~ N(0, 1e-2), v ~ |N(0, 1e-4)| in the reference's tree, at
    ``step``; bfloat16 moments hold bfloat16 values."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    mdt = jnp.dtype(moment_dtype)

    def draw(p, scale, absolute):
        x = rng.normal(scale=scale, size=p.shape).astype(np.float32)
        return np.asarray(jnp.asarray(np.abs(x) if absolute else x, mdt))

    return {"m": jax.tree.map(lambda p: draw(p, 1e-2, False), params),
            "v": jax.tree.map(lambda p: draw(p, 1e-4, True), params),
            "step": np.asarray(step, np.int32)}


def _bias_corrections(step):
    """The reference's and the port's (1 - b1^t, 1 - b2^t) at step + 1."""
    import jax
    import jax.numpy as jnp

    cfg = AdamWConfig()
    s = np.asarray(step + 1, np.int32)
    ref = jax.jit(lambda s: (1.0 - cfg.b1 ** s.astype(jnp.float32),
                             1.0 - cfg.b2 ** s.astype(jnp.float32)))(s)
    port = topt._bias_corrections(torch.tensor(step + 1, dtype=torch.int32),
                                  cfg)
    return [float(x) for x in ref], [float(x) for x in port]


def _run_both(params, grads, opt, cfg):
    """The port's update and the reference's, the reference run op by op
    (not jitted): its expression as written.  Compiled, XLA contracts ``b1 *
    m + (1 - b1) * g`` into a fused multiply-add and rewrites ``(m / b1t) /
    d`` as ``m / (b1t * d)``, a last-bit difference the whole-step tests
    hold to their tolerance."""
    from repro.training.optimizer import adamw_update as j_update

    want = _np(j_update(grads, opt, params, cfg))
    got = adamw_update(_t(grads), _t(opt), _t(params), cfg)
    return got, want


def _flat_pairs(got, want):
    """(path, port leaf, reference leaf, is bfloat16) over ``[params,
    opt]``: paths ``[0]...`` are the parameters; bfloat16 leaves widened to
    float32 on both sides."""
    import jax

    g = jax.tree_util.tree_flatten_with_path(
        [convert.params_to_numpy(got[0]), convert.params_to_numpy(got[1])])[0]
    w = jax.tree_util.tree_flatten_with_path([want[0], want[1]])[0]
    assert [k for k, _ in g] == [k for k, _ in w]
    out = []
    for (k, a), (_, b) in zip(g, w):
        b = np.asarray(b)
        bf16 = b.dtype.name == "bfloat16"
        out.append((jax.tree_util.keystr(k), a,
                    b.astype(np.float32) if bf16 else b, bf16))
    return out


def _clip_for(grads, mode):
    from repro.training.optimizer import _global_norm

    gnorm = float(_global_norm(grads))
    return {"none": None, "not_binding": 10.0 * gnorm,
            "binding": gnorm / 4}[mode]


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("clip", ["none", "not_binding", "binding"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_on_reference_gradients(moment_dtype, clip, step):
    params, _, grads = _case()
    cfg = AdamWConfig(moment_dtype=moment_dtype,
                      grad_clip=_clip_for(grads, clip))
    opt = _opt_state(params, step, moment_dtype)
    got, want = _run_both(params, grads, opt, cfg)
    ref_bt, port_bt = _bias_corrections(step)
    for key, g, w, bf16 in _flat_pairs(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if clip == "binding":
            # a bfloat16 moment may round the other way: one bf16 ulp
            np.testing.assert_allclose(
                g, w, rtol=2.0 ** -7 if bf16 else 1e-5,
                atol=1e-6 * float(np.abs(w).max()), err_msg=key)
        elif key.startswith("[0]"):
            if ref_bt == port_bt:
                np.testing.assert_array_equal(g, w, err_msg=key)
            else:
                assert (np.abs(g - w) <= np.spacing(np.abs(w))).all(), key
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)
    assert int(got[1]["step"]) == step + 1


def test_adamw_over_5000_steps_of_bias_correction():
    """Steps 1-5,000: ``b1 ** t`` and ``b2 ** t`` differ from XLA's in the
    last bit at some t, ``1 -`` them at none so far (checked here, all
    5,000); at any step where they would, the new parameters must be
    within one ulp and the moments bitwise."""
    import jax
    import jax.numpy as jnp

    cfg = AdamWConfig()
    steps = np.arange(1, 5001, dtype=np.int32)
    ref = jax.jit(lambda s: (1.0 - cfg.b1 ** s.astype(jnp.float32),
                             1.0 - cfg.b2 ** s.astype(jnp.float32)))(steps)
    port = np.array([[float(x) for x in topt._bias_corrections(
        torch.tensor(int(t), dtype=torch.int32), cfg)] for t in steps],
        np.float32)
    differ = steps[(np.asarray(ref[0]) != port[:, 0])
                   | (np.asarray(ref[1]) != port[:, 1])]
    params, _, grads = _case()
    cfg = AdamWConfig(grad_clip=None)
    for t in differ:
        opt = _opt_state(params, int(t) - 1, "float32")
        got, want = _run_both(params, grads, opt, cfg)
        for key, g, w, _ in _flat_pairs(got, want):
            if key.startswith("[0]"):
                assert (np.abs(g - w) <= np.spacing(np.abs(w))).all(), key
            else:
                np.testing.assert_array_equal(g, w, err_msg=key)


def test_global_norm_sums_leaves_in_jax_order():
    """Single-value leaves (no reduction inside a leaf) whose float32 sum
    depends on the order: ``t0, t1, t10, t11, t2, ...`` as
    ``jax.tree.leaves`` sorts them, not insertion order."""
    from repro.training.optimizer import _global_norm as j_norm

    vals = {f"t{i}": 1.0 for i in range(12)}
    vals["t10"] = 4096.0                      # 2^24 once squared
    tree = {k: np.array([v], np.float32) for k, v in vals.items()}
    sq = {k: np.float32(v) * np.float32(v) for k, v in vals.items()}
    by_insertion = np.float32(0)
    for k in tree:
        by_insertion = np.float32(by_insertion + sq[k])
    by_jax = np.float32(0)
    for k in sorted(tree):
        by_jax = np.float32(by_jax + sq[k])
    assert by_insertion != by_jax            # the case tells them apart
    got = topt._global_norm(_t(tree))
    assert float(got) == float(j_norm(tree)) == float(np.sqrt(by_jax))
    assert [float(x) for x in topt.tree_leaves(_t(tree))] == \
        [vals[k] for k in sorted(vals)]


def test_global_norm_where_the_clip_binds():
    from repro.training.optimizer import _global_norm as j_norm

    _, _, grads = _case()
    np.testing.assert_allclose(float(topt._global_norm(_t(grads))),
                               float(j_norm(grads)), rtol=1e-6)


def test_adamw_init_matches_reference():
    from repro.training.optimizer import adamw_init as j_init

    import jax

    params, _, _ = _case()
    for mdt in ("float32", "bfloat16"):
        want = j_init(params, AdamWConfig(moment_dtype=mdt))
        got = adamw_init(_t(params), AdamWConfig(moment_dtype=mdt))
        w = jax.tree_util.tree_flatten_with_path(want)[0]
        g = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [k for k, _ in w] == [k for k, _ in g]
        for (_, a), (_, b) in zip(w, g):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype) == str(b.dtype).split(".")[1]
            assert not b.any()


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("s", [1, 2, 4])
def test_compressed_psum_matches_reference(s, residual):
    import jax

    from repro.training.optimizer import compressed_psum as j_psum

    rng = np.random.default_rng(s)
    g = rng.normal(size=(s, 6, 5)).astype(np.float32)
    r = (rng.normal(scale=1e-3, size=(s, 6, 5)).astype(np.float32)
         if residual else None)
    if residual:
        fn = jax.vmap(lambda g, r: j_psum(g, "d", r), axis_name="d")
        total, res = fn(g, r)
    else:
        total, res = jax.vmap(lambda g: j_psum(g, "d"), axis_name="d")(g)
    got_total, got_res = compressed_psum(
        [torch.from_numpy(x) for x in g],
        None if r is None else [torch.from_numpy(x) for x in r])
    for i in range(s):
        np.testing.assert_array_equal(got_total.numpy(), np.asarray(total[i]))
        np.testing.assert_array_equal(got_res[i].numpy(), np.asarray(res[i]))


@pytest.mark.parametrize("accum", [1, 4])
def test_make_train_step_matches_reference(accum):
    import jax

    from repro.models import recsys as jr
    from repro.training import TrainStepConfig as JCfg
    from repro.training import adamw_init as j_init
    from repro.training import make_train_step as j_make

    params, batch, _ = _case(seed=3, b=32)
    opt = _np(j_init(params))
    j_step = jax.jit(j_make(lambda p, b: jr.dlrm_loss(p, CFG, b),
                            JCfg(accum_steps=accum)))
    t_step = make_train_step(lambda p, b: tr.dlrm_loss(p, CFG, b),
                             TrainStepConfig(accum_steps=accum))
    tp, to = _t(params), _t(opt)
    for i in range(3):
        jp, jo, jm = j_step(params, opt, batch)
        params, opt = _np(jp), _np(jo)
        tp, to, tm = t_step(tp, to, _t(batch))
        assert_train_step_close({"params": tp, "opt": to}, tm,
                                {"params": params, "opt": opt}, jm,
                                where=f"accum {accum} step {i}")
        # the next step starts from the reference's state
        tp, to = _t(params), _t(opt)


def test_train_step_updates_in_place():
    """The step returns the same parameter and moment tensors, updated."""
    params, batch, _ = _case(seed=4)
    tp = _t(params)
    to = adamw_init(tp)
    before = tp["tables"]["t0"].clone()
    step = make_train_step(lambda p, b: tr.dlrm_loss(p, CFG, b))
    new_p, new_o, out = step(tp, to, _t(batch))
    assert new_p["tables"]["t0"] is tp["tables"]["t0"]
    assert new_o["m"]["bot"]["w"][0] is to["m"]["bot"]["w"][0]
    assert not torch.equal(before, tp["tables"]["t0"])
    assert int(new_o["step"]) == 1 and out["loss"].requires_grad is False


def test_adamw_leaves_gradients_as_they_are():
    """One gradient tensor at two leaves (as autograd hands ``a + b``'s
    gradient to both) and a bfloat16 gradient (scaled in float32, as the
    reference promotes ``g * scale``): the clip binds, the update equals
    the reference's op by op to the binding tolerance of
    ``test_adamw_on_reference_gradients``, and the gradients are left as
    they were."""
    import jax.numpy as jnp

    from repro.training.optimizer import adamw_init as j_init
    from repro.training.optimizer import adamw_update as j_update

    rng = np.random.default_rng(6)
    params = {k: rng.normal(size=(6, 4)).astype(np.float32) for k in "abc"}
    shared = rng.normal(size=(6, 4)).astype(np.float32)
    low = np.asarray(jnp.asarray(rng.normal(size=(6, 4)), jnp.bfloat16))
    cfg = AdamWConfig(grad_clip=0.5)
    want = _np(j_update({"a": shared, "b": shared, "c": low},
                        _np(j_init(params, cfg)), params, cfg))
    g_shared = torch.from_numpy(shared.copy())
    g_low = convert.params_from_numpy(low, "cpu")
    grads = {"a": g_shared, "b": g_shared, "c": g_low}
    before = [x.clone() for x in (g_shared, g_low)]
    tp = _t(params)
    got = adamw_update(grads, adamw_init(tp, cfg), tp, cfg)
    for key, g, w, _ in _flat_pairs(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=key)
    assert torch.equal(g_shared, before[0]) and torch.equal(g_low, before[1])
    assert g_low.dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["square", "sum"])
def test_train_step_over_a_shared_gradient(kind):
    """A loss over ``p["a"] + p["b"]``: autograd hands both leaves one
    gradient tensor (for ``sum`` an expanded, stride-0 view of one value).
    The clip binds; the step is held to the reference's jitted one by
    ``torch_parity.assert_train_step_close``, three steps."""
    import jax
    import jax.numpy as jnp

    from repro.training import adamw_init as j_init
    from repro.training import make_train_step as j_make

    def loss(xp):
        if kind == "square":
            return lambda p, b: xp.sum(xp.square(p["a"] + p["b"])) * \
                xp.sum(b["x"])
        return lambda p, b: xp.sum(p["a"] + p["b"]) * xp.sum(b["x"])

    rng = np.random.default_rng(7)
    params = {k: rng.normal(size=(6, 4)).astype(np.float32) for k in "ab"}
    batch = {"x": (rng.normal(size=(8,)) + 2.0).astype(np.float32)}
    opt = _np(j_init(params))
    j_step = jax.jit(j_make(loss(jnp)))
    t_step = make_train_step(loss(torch))
    leaves = {k: v.requires_grad_() for k, v in _t(params).items()}
    ga, gb = torch.autograd.grad(loss(torch)(leaves, _t(batch)),
                                 [leaves["a"], leaves["b"]])
    assert ga.data_ptr() == gb.data_ptr()      # the case under test
    for i in range(3):
        # each step starts from the reference's state
        tp, to = _t(params), _t(opt)
        jp, jo, jm = j_step(params, opt, batch)
        params, opt = _np(jp), _np(jo)
        tp, to, tm = t_step(tp, to, _t(batch))
        assert_train_step_close({"params": tp, "opt": to}, tm,
                                {"params": params, "opt": opt}, jm,
                                where=f"{kind} step {i}")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _gauss_tree(gen, device):
    shapes = {"a": (64, 33), "b": [(7,), (128, 4)], "c": (1000,)}

    def draw(s):
        return torch.randn(s, generator=gen).to(device)

    return {"a": draw(shapes["a"]), "b": [draw(s) for s in shapes["b"]],
            "c": draw(shapes["c"])}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_on_card(cuda_device, moment_dtype):
    """The same update on the card and on the CPU, clip binding: rtol 1e-5
    / atol 1e-6 of each leaf's largest value (the global norm's sums
    reduce in another order on the card)."""
    gen = torch.Generator().manual_seed(0)
    params = _gauss_tree(gen, "cpu")
    grads = _gauss_tree(gen, "cpu")
    cfg = AdamWConfig(moment_dtype=moment_dtype, grad_clip=0.5)
    out = {}
    for dev in ("cpu", cuda_device):
        p = topt.tree_map(lambda x: x.to(dev).clone(), params)
        g = topt.tree_map(lambda x: x.to(dev).clone(), grads)
        o = adamw_init(p, cfg)
        for _ in range(3):
            p, o = adamw_update(topt.tree_map(torch.clone, g), o, p, cfg)
        out[str(dev)] = topt.tree_leaves([p, o["m"], o["v"]])
    for a, b in zip(*out.values()):
        b = b.cpu()
        assert a.dtype == b.dtype
        torch.testing.assert_close(
            b.float(), a.float(), rtol=1e-5,
            atol=1e-6 * float(a.float().abs().max()))


@pytest.mark.requires_cuda
def test_compressed_psum_on_card(cuda_device):
    """Four per-device gradients on the card: the sum and residuals equal
    the CPU's bitwise (every step is elementwise, the max exact)."""
    gen = torch.Generator().manual_seed(1)
    g = [torch.randn((256, 33), generator=gen) for _ in range(4)]
    r = [torch.randn((256, 33), generator=gen) * 1e-3 for _ in range(4)]
    a_tot, a_res = compressed_psum(g, r)
    b_tot, b_res = compressed_psum([x.to(cuda_device) for x in g],
                                   [x.to(cuda_device) for x in r])
    assert b_tot.is_cuda
    assert torch.equal(a_tot, b_tot.cpu())
    for x, y in zip(a_res, b_res):
        assert torch.equal(x, y.cpu())
