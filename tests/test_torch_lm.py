"""The port's LM family (``repro_torch.models.{layers,moe,transformer}``,
``LMSpec`` and the five archs) against the reference's, on the CPU.

The same numpy parameters (the reference's ``init_params``, carried across
by ``repro_torch.convert``) and inputs go through both packages, the
reference under ``jax.jit``.  The tolerances are
``repro_torch.training.tolerance``'s, which ``chip_smoke.py`` phase 11
holds the card to as well:

  * float32 compute is held tight (``LOGITS[float32]``, ``F32_STEP``).  It
    is not bitwise: ``torch.rsqrt`` / ``cos`` / ``sin`` / ``pow`` and XLA's
    differ in the last bit on some inputs, and XLA fuses multiply-adds.
  * bfloat16 compute (the LM's default) is held loose
    (``LOGITS[bfloat16]``, ``BF16_STEP``): the two packages round their
    bfloat16 products and sums apart.  In an MoE arch a near-tie among the
    router's bfloat16 logits can route a token to another expert in each
    package; the MoE's own routing is pinned exactly by ``moe_ffn`` on
    identical inputs (planted ties, capacity drops, chunked dispatch).

The parity traps pinned here: the clamped embedding lookup, the dropped
cache write when ``len`` reaches the cache's end, ``lax.top_k``'s ties and
the stable rank within an expert, the chunked attention at small chunks,
``remat`` / nested remat (no value changes), ``accum_steps = 2``,
bfloat16 moments with ``grad_clip=None`` and the zero-size ``final_norm``
of an OLMo-style arch.

Card cases (``python -m pytest --noconftest -m requires_cuda
tests/test_torch_lm.py``) hold every reduced step on the card against the
CPU; JAX is imported inside the CPU tests only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import (assert_logits_close,  # noqa: F401
                          assert_train_step_close, cuda_device)

from repro_torch import convert
from repro_torch.configs import all_archs
from repro_torch.models import layers as tl
from repro_torch.models import moe as tm
from repro_torch.models import transformer as tt
from repro_torch.training.optimizer import tree_map
from repro_torch.training.tolerance import step_tolerance

LM_ARCHS = ("olmo-1b", "qwen2.5-32b", "qwen2-72b", "qwen3-moe-30b-a3b",
            "qwen3-moe-235b-a22b")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _jdt(dtype):
    import jax.numpy as jnp

    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


def _t(x):
    return convert.params_from_numpy(x, "cpu")


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _specs(name, **kw):
    """(the reference's reduced spec, the port's), with ``kw`` replaced in
    both."""
    from repro.configs import all_archs as j_all

    j = dataclasses.replace(j_all()[name].reduced(), **kw)
    return j, dataclasses.replace(all_archs()[name].reduced(), **kw)


def _ref_params(cfg, seed=0):
    import jax

    from repro.models import transformer as jt

    return _np(jt.init_params(jax.random.PRNGKey(seed), cfg))


def _close(got, want, dtype, where=""):
    """Elementwise, at the logits' tolerance (rows: the last axis)."""
    assert_logits_close(got, want, dtype, where=where)


def _as(x, dtype):
    """numpy float32 -> (reference array, port tensor) in ``dtype``."""
    import jax.numpy as jnp

    return jnp.asarray(x).astype(_jdt(dtype)), torch.from_numpy(x).to(dtype)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", DTYPES)
def test_norms_rope_and_swiglu_match_reference(dt):
    import jax

    from repro.models import layers as jl

    dtype = DTYPES[dt]
    rng = np.random.default_rng(0)
    xj, xt = _as(rng.normal(size=(3, 5, 4, 16)).astype(np.float32), dtype)
    wj, wt = _as(rng.normal(size=(16,)).astype(np.float32), dtype)
    _close(tl.rms_norm(xt, wt),
           jax.jit(jl.rms_norm)(xj, wj), dtype, "rms_norm")
    _close(tl.nonparam_layer_norm(xt),
           jax.jit(jl.nonparam_layer_norm)(xj), dtype, "nonparam_ln")
    for theta in (1e4, 1e6):
        _close(tl.rope_freqs(16, theta), jl.rope_freqs(16, theta),
               torch.float32, "rope_freqs")
        pos = rng.integers(0, 32768, size=(3, 5)).astype(np.int32)
        _close(tl.apply_rope(xt, torch.from_numpy(pos), theta),
               jax.jit(lambda x, p: jl.apply_rope(x, p, theta))(xj, pos),
               dtype, f"apply_rope theta {theta}")
    a = rng.normal(size=(6, 16)).astype(np.float32)
    ws = [rng.normal(size=s).astype(np.float32) / 4
          for s in ((16, 24), (16, 24), (24, 16))]
    _close(tl.swiglu(*[_as(v, dtype)[1] for v in [a] + ws]),
           jax.jit(jl.swiglu)(*[_as(v, dtype)[0] for v in [a] + ws]),
           dtype, "swiglu")


def _qkv(rng, b, s, t, n_kv, g, hd, dtype):
    q = rng.normal(size=(b, s, n_kv, g, hd)).astype(np.float32)
    k = rng.normal(size=(b, t, n_kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, t, n_kv, hd)).astype(np.float32)
    return [_as(x, dtype) for x in (q, k, v)]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", ["causal", "offset", "kv_len"])
def test_plain_attention_matches_reference(case, dt):
    import jax
    import jax.numpy as jnp

    from repro.models import layers as jl

    dtype = DTYPES[dt]
    rng = np.random.default_rng(1)
    s, t = {"causal": (12, 12), "offset": (4, 12), "kv_len": (1, 16)}[case]
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, s, t, 2, 3, 8, dtype)
    kw = {"causal": {"causal": True},
          "offset": {"causal": True, "q_offset": 8},
          "kv_len": {"causal": False}}[case]
    lens = np.array([3, 16], np.int32)
    if case == "kv_len":
        want = jax.jit(lambda q, k, v, n: jl._plain_attention(
            q, k, v, kv_len=n, **kw))(qj, kj, vj, jnp.asarray(lens))
        got = tl._plain_attention(qt, kt, vt, kv_len=torch.from_numpy(lens),
                                  **kw)
    else:
        want = jax.jit(lambda q, k, v: jl._plain_attention(q, k, v, **kw))(
            qj, kj, vj)
        got = tl._plain_attention(qt, kt, vt, **kw)
    _close(got, want, dtype, case)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("chunks", [(4, 4, True), (8, 4, True), (4, 8, True),
                                    (4, 4, False), (4, 8, False)])
def test_chunked_attention_matches_reference(chunks, dt):
    """Small chunks against the reference's ``_chunked_attention`` and, in
    float32, against the port's own plain attention (S = T = 16; with
    ``kv_chunk`` 8 and T = 12 the reference reads the first 8 keys only,
    as the port does)."""
    import jax

    from repro.models import layers as jl

    dtype = DTYPES[dt]
    qc, kc, causal = chunks
    rng = np.random.default_rng(2)
    for s in ((16, 12) if kc == 8 and not causal else (16,)):
        (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, s, s, 2, 2, 8, dtype)
        want = jax.jit(lambda q, k, v: jl._chunked_attention(
            q, k, v, causal=causal, q_chunk=qc, kv_chunk=kc))(qj, kj, vj)
        got = tl._chunked_attention(qt, kt, vt, causal=causal, q_chunk=qc,
                                    kv_chunk=kc)
        _close(got, want, dtype, f"S {s}")
        if dtype == torch.float32 and s % kc == 0:
            _close(got, tl._plain_attention(qt, kt, vt, causal=causal),
                   dtype, f"against the plain attention, S {s}")
    with pytest.raises(ValueError):
        tl._chunked_attention(qt[:, :10], kt[:, :10], vt[:, :10],
                              causal=True, q_chunk=4, kv_chunk=4)


def test_gqa_attention_dispatches_like_the_reference():
    """Chunked only when S == T > threshold and no ``kv_len``."""
    rng = np.random.default_rng(3)
    (_, qt), (_, kt), (_, vt) = _qkv(rng, 1, 4096 + 2048, 4096 + 2048, 1, 1,
                                     4, torch.float32)
    got = tl.gqa_attention(qt, kt, vt, causal=True, chunked_threshold=4096)
    assert torch.equal(got, tl._chunked_attention(qt, kt, vt, causal=True))
    q, k, v = qt[:, :8], kt[:, :8], vt[:, :8]
    n = torch.tensor([5], dtype=torch.int32)
    got = tl.gqa_attention(q, k, v, causal=False, kv_len=n,
                           chunked_threshold=4)
    assert torch.equal(got, tl._plain_attention(q, k, v, causal=False,
                                                kv_len=n))
    got = tl.gqa_attention(q[:, :6], k, v, causal=True, q_offset=2,
                           chunked_threshold=4)
    assert torch.equal(got, tl._plain_attention(q[:, :6], k, v, causal=True,
                                                q_offset=2))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_case(case):
    """(t, MoEConfig kwargs, params, x) with the case's trap planted."""
    import jax

    from repro.models import moe as jm

    rng = np.random.default_rng(4)
    kw = {"n_experts": 8, "top_k": 2, "d_ff_expert": 16}
    t = 64
    if case == "capacity":
        kw["capacity_factor"] = 0.5
    if case == "chunk":
        kw["dispatch_chunk"] = 16
    p = {k: np.array(v) for k, v in _np(jm.init_moe_params(
        jax.random.PRNGKey(0), 32, jm.MoEConfig(**kw))).items()}
    x = rng.normal(size=(t, 32)).astype(np.float32)
    if case == "ties":
        # experts 2 and 5 share a router column: every token ties them;
        # zero tokens tie all eight experts
        p["router"][:, 5] = p["router"][:, 2]
        x[::7] = 0.0
    if case == "capacity":
        # expert 3 dominates: far more tokens pick it than it has slots
        p["router"][:, 3] += 0.5 * np.sign(x.sum(0))
    return t, kw, p, x


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", ["random", "ties", "capacity", "chunk"])
def test_moe_ffn_matches_reference(case, dt):
    import jax

    from repro.models import moe as jm

    dtype = DTYPES[dt]
    t, kw, p, x = _moe_case(case)
    xj, xt = _as(x, dtype)
    jcfg, tcfg = jm.MoEConfig(**kw), tm.MoEConfig(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    want, want_aux = jax.jit(lambda p, x: jm.moe_ffn(p, x, jcfg))(p, xj)
    got, got_aux = tm.moe_ffn(_t(p), xt, tcfg)
    _close(got, want, dtype, case)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-4,
                               atol=1e-7)
    probs = torch.softmax(xt.float() @ _t(p)["router"].to(dtype).float(), -1)
    top_i = torch.sort(-probs, dim=-1, stable=True).indices[:, :2]
    counts = torch.bincount(top_i.reshape(-1), minlength=8)
    if case == "capacity":
        assert int(counts.max()) > tcfg.capacity(t), counts  # drops happen
    if case == "ties":
        assert bool((probs[:, 2] == probs[:, 5]).all())


def test_moe_capacity_matches_reference():
    from repro.models import moe as jm

    for n in (1, 7, 64, 1000, 32768, 131072):
        for e, k, f in ((8, 2, 1.25), (128, 8, 1.25), (8, 2, 0.5)):
            assert tm.MoEConfig(e, k, 4, capacity_factor=f).capacity(n) == \
                jm.MoEConfig(e, k, 4, capacity_factor=f).capacity(n)


# ---------------------------------------------------------------------------
# the whole model: forward, loss, prefill, decode
# ---------------------------------------------------------------------------


def _tokens(rng, b, s, vocab):
    toks = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    # the clamped lookup: -1 wraps to the last row, ids past the end (and
    # below -V) clamp to the last (first) row
    toks[0, :4] = [-1, vocab, vocab + 7, -vocab - 2]
    return toks


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_model_matches_reference(arch, dt):
    """forward (logits, aux), the loss, prefill (logits, cache) and a decode
    step after growing the cache by one slot, in ``dt``."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as jl
    from repro.models import transformer as jt

    dtype = DTYPES[dt]
    jd = _jdt(dtype)
    j, t = _specs(arch)
    moe = t.cfg.moe is not None
    params = _ref_params(j.cfg, seed=1)
    tp = _t(params)
    rng = np.random.default_rng(5)
    toks = _tokens(rng, 2, 16, t.cfg.vocab)
    labels = rng.integers(0, t.cfg.vocab, size=(2, 16)).astype(np.int32)

    want, want_aux = jax.jit(lambda p, x: jt.forward(
        p, j.cfg, x, compute_dtype=jd))(params, toks)
    got, got_aux = tt.forward(tp, t.cfg, torch.from_numpy(toks),
                              compute_dtype=dtype)
    assert_logits_close(got, want, dtype, moe, "forward")
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=5e-2,
                               atol=1e-6)
    want_l = float(jax.jit(lambda lg, a: jl.cross_entropy_loss(
        lg, labels) + a)(want, want_aux))
    got_l = float(tl.cross_entropy_loss(got, torch.from_numpy(labels))
                  + got_aux)
    np.testing.assert_allclose(got_l, want_l,
                               rtol=step_tolerance(dtype, moe).loss_rtol)
    if dtype == torch.bfloat16:
        want_l = float(jax.jit(lambda p, b: jt.loss_fn(p, j.cfg, b))(
            params, {"tokens": toks, "labels": labels}))
        got_l = float(tt.loss_fn(tp, t.cfg, {
            "tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels)}))
        np.testing.assert_allclose(got_l, want_l,
                                   rtol=step_tolerance(dtype, moe).loss_rtol)

    want_p, jcache = jax.jit(lambda p, x: jt.prefill(
        p, j.cfg, x, compute_dtype=jd))(params, toks[:, :-1])
    got_p, tcache = tt.prefill(tp, t.cfg, torch.from_numpy(toks[:, :-1]),
                               compute_dtype=dtype)
    assert_logits_close(got_p, want_p, dtype, moe, "prefill")
    for f in ("k", "v"):
        assert tcache[f].dtype == dtype
        assert_logits_close(tcache[f], jcache[f], dtype, moe, f"cache {f}")
    assert np.array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))

    pad = ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))
    jcache = {"k": jnp.pad(jcache["k"], pad), "v": jnp.pad(jcache["v"], pad),
              "len": jcache["len"]}
    tcache = {f: torch.nn.functional.pad(tcache[f], (0, 0, 0, 0, 0, 1))
              for f in ("k", "v")} | {"len": tcache["len"]}
    want_d, jc2 = jax.jit(lambda p, c, x: jt.decode_step(
        p, j.cfg, c, x, compute_dtype=jd))(params, jcache, toks[:, -1])
    got_d, tc2 = tt.decode_step(tp, t.cfg, tcache,
                                torch.from_numpy(toks[:, -1]),
                                compute_dtype=dtype)
    assert_logits_close(got_d, want_d, dtype, moe, "decode")
    for f in ("k", "v"):
        assert_logits_close(tc2[f], jc2[f], dtype, moe, f"decode cache {f}")
    assert np.array_equal(tc2["len"].numpy(), np.asarray(jc2["len"]))


@pytest.mark.parametrize("dt", DTYPES)
def test_decode_drops_the_write_past_the_cache(dt):
    """A lane whose ``len`` is the cache's length writes nothing (the
    reference's out-of-bounds scatter), the other lane writes at ``len``;
    both then attend over ``len + 1`` slots."""
    import jax

    from repro.models import transformer as jt

    dtype = DTYPES[dt]
    jd = _jdt(dtype)
    j, t = _specs("qwen2.5-32b")
    params = _ref_params(j.cfg, seed=2)
    rng = np.random.default_rng(6)
    shape = (j.cfg.n_layers, 2, 8, j.cfg.n_kv_heads, j.cfg.hd)
    cache = {"k": rng.normal(size=shape).astype(np.float32),
             "v": rng.normal(size=shape).astype(np.float32),
             "len": np.array([8, 3], np.int32)}
    toks = np.array([5, 9], np.int32)
    jc = {f: _as(cache[f], dtype)[0] for f in ("k", "v")} | {
        "len": cache["len"]}
    tc = {f: _as(cache[f], dtype)[1] for f in ("k", "v")} | {
        "len": torch.from_numpy(cache["len"])}
    before = {f: tc[f].clone() for f in ("k", "v")}
    want, jc2 = jax.jit(lambda p, c, x: jt.decode_step(
        p, j.cfg, c, x, compute_dtype=jd))(params, jc, toks)
    got, tc2 = tt.decode_step(_t(params), t.cfg, tc, torch.from_numpy(toks),
                              compute_dtype=dtype)
    assert_logits_close(got, want, dtype, where="logits")
    for f in ("k", "v"):
        assert tc2[f] is tc[f]                          # written in place
        assert torch.equal(tc2[f][:, 0], before[f][:, 0])   # dropped
        assert not torch.equal(tc2[f][:, 1, 3], before[f][:, 1, 3])
        rest = [i for i in range(8) if i != 3]
        assert torch.equal(tc2[f][:, 1, rest], before[f][:, 1, rest])
        assert_logits_close(tc2[f], jc2[f], dtype, where=f"cache {f}")
    assert tc2["len"].tolist() == [9, 4]


@pytest.mark.parametrize("dt", DTYPES)
def test_prefill_then_decode_equals_forward(dt):
    """The card's phase-11 check at small size: ``prefill`` of the first p
    tokens, then ``decode_step`` of token p, against ``forward``'s row p
    with the chunked attention (chunks of 8 here, 2,048 on the card) on
    both long passes; within ``LOGITS[dt]``."""
    dtype = DTYPES[dt]
    _, t = _specs("olmo-1b")
    cfg = t.cfg
    params = tt.init_params(torch.Generator().manual_seed(3), cfg,
                            device="cpu")
    if dtype == torch.bfloat16:
        params = tree_map(lambda w: w.to(dtype), params)
    toks = torch.from_numpy(_tokens(np.random.default_rng(7), 2, 32,
                                    cfg.vocab)) % cfg.vocab
    orig = tt.gqa_attention

    def small_chunks(q, k, v, **kw):
        if q.shape[1] == k.shape[1] and q.shape[1] > 8 and \
                kw.get("kv_len") is None:
            return tl._chunked_attention(q, k, v, causal=kw["causal"],
                                         q_chunk=8, kv_chunk=8)
        return orig(q, k, v, **kw)

    tt.gqa_attention = small_chunks
    try:
        full, _ = tt.forward(params, cfg, toks, compute_dtype=dtype)
        p = 24
        _, cache = tt.prefill(params, cfg, toks[:, :p], compute_dtype=dtype)
        grown = tt.init_cache(cfg, 2, 32, dtype=dtype, device="cpu")
        for f in ("k", "v"):
            grown[f][:, :, :p] = cache[f]
        grown["len"] = cache["len"]
        got, _ = tt.decode_step(params, cfg, grown, toks[:, p],
                                compute_dtype=dtype)
    finally:
        tt.gqa_attention = orig
    assert_logits_close(got, full[:, p], dtype, where="decode vs forward")


# ---------------------------------------------------------------------------
# specs: fields, shapes, counts, abstract trees
# ---------------------------------------------------------------------------


def _tree_meta(tree):
    from repro_torch.training.tolerance import flat

    out = {}
    for key, x in flat(tree).items():
        if isinstance(x, torch.Tensor):
            out[key] = (tuple(x.shape), str(x.dtype).split(".")[1])
        else:
            out[key] = (tuple(x.shape), np.dtype(x.dtype).name)
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_spec_matches_reference(arch):
    """Fields (the arch config field for field), shapes, cells, skipped
    cells, parameter counts and FLOPs, full width and reduced; the
    abstract state and inputs of every cell (the port's on ``meta``, the
    reference's ``jax.eval_shape``): the same tree, shapes and dtypes."""
    from repro.configs import all_archs as j_all

    for reduced in (False, True):
        j = j_all()[arch]
        t = all_archs()[arch]
        if reduced:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.cells() == j.cells()
        assert t.skipped_cells() == j.skipped_cells()
        assert t.cfg.n_params() == j.cfg.n_params()
        assert t.cfg.n_active_params() == j.cfg.n_active_params()
        assert (t.cfg.hd, t.cfg.groups) == (j.cfg.hd, j.cfg.groups)
        for name, shape in t.shapes().items():
            js = j.shapes()[name]
            assert (shape.kind, dict(shape.dims), shape.skip) == \
                (js.kind, dict(js.dims), js.skip)
            assert t.model_flops(shape) == j.model_flops(js)
            if shape.skip:
                continue
            assert _tree_meta(t.abstract_state(shape)) == \
                _tree_meta(j.abstract_state(js)), (arch, reduced, name)
            assert _tree_meta(t.abstract_inputs(shape)) == \
                _tree_meta(j.abstract_inputs(js)), (arch, reduced, name)


def test_params_and_init_cache_convert_both_ways():
    """An OLMo-style tree (zero-size ``final_norm``, stacked layers) through
    ``params_from_numpy`` / ``params_to_numpy`` unchanged; ``init_cache``
    equal to the reference's."""
    from repro.models import transformer as jt

    j, t = _specs("olmo-1b")
    params = _ref_params(j.cfg)
    assert params["final_norm"].shape == (0,)
    back = convert.params_to_numpy(_t(params))
    assert _tree_meta(back) == _tree_meta(params)
    from repro_torch.training.tolerance import flat

    for key, leaf in flat(params).items():
        assert np.array_equal(flat(back)[key], leaf), key
    want = _np(jt.init_cache(j.cfg, 3, 5))
    got = convert.params_to_numpy(tt.init_cache(t.cfg, 3, 5, device="cpu"))
    assert _tree_meta(tt.init_cache(t.cfg, 3, 5, device="cpu")) == \
        _tree_meta(jt.init_cache(j.cfg, 3, 5))
    for f in ("k", "v", "len"):
        assert np.array_equal(got[f], want[f])


# ---------------------------------------------------------------------------
# make_step: every reduced arch's three kinds
# ---------------------------------------------------------------------------


def _step_case(t, kind, seed):
    """The port's reduced state and inputs for ``kind`` as numpy trees (a
    decode cache filled with random values and lengths)."""
    shape = {s.kind: s for s in t.shapes().values() if not s.skip}[kind]
    gen = torch.Generator().manual_seed(seed)
    state = convert.params_to_numpy(t.init_state(shape, "cpu", gen))
    inputs = convert.params_to_numpy(t.make_inputs(shape, "cpu", gen))
    if kind == "train" and t.moment_dtype == "bfloat16":
        import ml_dtypes

        for f in ("m", "v"):
            state["opt"][f] = tree_map(
                lambda x: x.astype(ml_dtypes.bfloat16), state["opt"][f])
    if kind == "decode":
        rng = np.random.default_rng(seed)
        c = state["cache"]
        for f in ("k", "v"):
            c[f] = rng.normal(size=c[f].shape).astype(np.float32)
        c["len"] = rng.integers(1, c["k"].shape[2] - 1,
                                size=c["len"].shape).astype(np.int32)
    return shape, state, inputs


def _bf16_state(state):
    """The reference's serving tree: bfloat16 params (and cache)."""
    import jax.numpy as jnp

    return tree_map(lambda x: jnp.asarray(x).astype(jnp.bfloat16)
                    if x.dtype == np.float32 else jnp.asarray(x), state)


def _torch_state(state):
    return tree_map(lambda x: torch.from_numpy(np.array(x)).to(
        torch.bfloat16) if x.dtype == np.float32 else torch.from_numpy(
            np.array(x)), state)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_steps_match_reference(arch, kind):
    """``make_step`` at prefill / decode on bfloat16 params: logits and
    the cache within ``LOGITS[bfloat16]``; decode's ``next_token`` equal
    wherever the top-2 logit gap exceeds that tolerance."""
    import jax

    j, t = _specs(arch)
    moe = t.cfg.moe is not None
    shape, state, inputs = _step_case(t, kind, seed=8)
    jshape = j.shapes()[shape.name]
    jstate, jout = jax.jit(j.make_step(jshape))(_bf16_state(state), inputs)
    tstate, tout = t.make_step(shape)(_torch_state(state), _t(inputs))
    if kind == "prefill":
        assert_logits_close(tout["logits"], jout["logits"], torch.bfloat16,
                            moe, "logits")
        cache, jcache = tout["cache"], jout["cache"]
    else:
        cache, jcache = tstate["cache"], jstate["cache"]
        from repro_torch.training.tolerance import LOGITS

        logits, _ = tt.decode_step(_torch_state(state)["params"], t.cfg,
                                   _torch_state(state)["cache"],
                                   _t(inputs)["tokens"])
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        sure = gap > LOGITS[torch.bfloat16][0] * float(logits.abs().max())
        want = torch.from_numpy(np.asarray(jout["next_token"]))
        assert tout["next_token"].dtype == torch.int32
        assert torch.equal(tout["next_token"][sure], want[sure]), \
            (tout["next_token"], want, gap)
    for f in ("k", "v"):
        assert_logits_close(cache[f], jcache[f], torch.bfloat16, moe,
                            f"cache {f}")
    assert np.array_equal(cache["len"].numpy(), np.asarray(jcache["len"]))


@pytest.mark.parametrize("arch,variant", [(a, "plain") for a in LM_ARCHS] + [
    ("qwen2.5-32b", "accum2"), ("qwen3-moe-30b-a3b", "accum2"),
    ("olmo-1b", "bf16_gather")])
def test_train_step_matches_reference(arch, variant):
    """``make_step`` at train_4k (float32 params, bfloat16 compute) against
    the reference's jitted step, within ``BF16_STEP`` (an MoE arch's
    ``BF16_MOE_STEP``); ``accum2`` splits the batch into two microbatches,
    ``bf16_gather`` casts the weights first.  qwen3-moe-235b-a22b's reduced
    spec keeps its bfloat16 moments and ``grad_clip=None``."""
    import jax

    kw = {"plain": {}, "accum2": {"accum_steps": 2},
          "bf16_gather": {"bf16_weight_gather": True}}[variant]
    j, t = _specs(arch, **kw)
    shape, state, inputs = _step_case(t, "train", seed=9)
    jstate, jout = jax.jit(j.make_step(j.shapes()["train_4k"]))(state, inputs)
    tstate, tout = t.make_step(shape)(_t(state), _t(inputs))
    assert_train_step_close(
        tstate, tout, jstate, jout, where=f"{arch} {variant}",
        tol=step_tolerance(torch.bfloat16, t.cfg.moe is not None,
                           t.moment_dtype))


@pytest.mark.parametrize("arch,variant", [(a, "plain") for a in LM_ARCHS] + [
    (a, v) for a in ("olmo-1b", "qwen3-moe-235b-a22b")
    for v in ("accum2", "remat")])
def test_f32_train_step_matches_reference(arch, variant):
    """The LM loss computed in float32 through each package's
    ``make_train_step`` (the spec's optimiser settings and accumulation):
    within ``F32_STEP``, MoE archs included; ``remat`` checkpoints every
    layer inside blocks of two (nested remat) in both."""
    import jax

    from repro.models import layers as jl
    from repro.models import transformer as jt
    from repro.training import train as jtrain
    from repro_torch.training import TrainStepConfig, make_train_step

    kw = {"plain": {}, "accum2": {"accum_steps": 2}, "remat": {}}[variant]
    j, t = _specs(arch, **kw)
    if variant == "remat":
        j = dataclasses.replace(j, cfg=dataclasses.replace(
            j.cfg, remat=True, remat_block=2))
        t = dataclasses.replace(t, cfg=dataclasses.replace(
            t.cfg, remat=True, remat_block=2))
    shape, state, inputs = _step_case(t, "train", seed=10)

    def j_loss(p, b):
        logits, aux = jt.forward(p, j.cfg, b["tokens"],
                                 compute_dtype=jax.numpy.float32)
        return jl.cross_entropy_loss(logits, b["labels"]) + aux

    def t_loss(p, b):
        logits, aux = tt.forward(p, t.cfg, b["tokens"],
                                 compute_dtype=torch.float32)
        return tl.cross_entropy_loss(logits, b["labels"]) + aux

    jstep = jax.jit(jtrain.make_train_step(j_loss, jtrain.TrainStepConfig(
        optimizer=j._opt_cfg(), accum_steps=j.accum_steps)))
    tstep = make_train_step(t_loss, TrainStepConfig(
        optimizer=t._opt_cfg(), accum_steps=t.accum_steps))
    jp, jo, jout = jstep(state["params"], state["opt"], inputs)
    ts = _t(state)
    tp, to, tout = tstep(ts["params"], ts["opt"], _t(inputs))
    assert_train_step_close({"params": tp, "opt": to}, tout,
                            {"params": jp, "opt": jo}, jout,
                            where=f"{arch} {variant}",
                            tol=step_tolerance(torch.float32,
                                               moment_dtype=t.moment_dtype))


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-moe-30b-a3b"])
def test_remat_changes_no_value(arch):
    """One train step with remat off, on, and nested over blocks of two
    layers: bitwise the same state and loss."""
    _, t = _specs(arch)
    shape, state, inputs = _step_case(t, "train", seed=11)
    runs = []
    for remat, blk in ((False, 1), (True, 1), (True, 2), (False, 2)):
        spec = dataclasses.replace(t, cfg=dataclasses.replace(
            t.cfg, remat=remat, remat_block=blk))
        runs.append(spec.make_step(shape)(_t(state), _t(inputs)))
    from repro_torch.training.tolerance import flat

    for st, out in runs[1:]:
        assert torch.equal(out["loss"], runs[0][1]["loss"])
        for key, leaf in flat(st).items():
            assert torch.equal(leaf, flat(runs[0][0])[key]), key


def test_loss_falls_on_a_repeated_batch():
    for arch in ("olmo-1b", "qwen3-moe-30b-a3b"):
        _, t = _specs(arch)
        shape = t.shapes()["train_4k"]
        gen = torch.Generator().manual_seed(12)
        state = t.init_state(shape, "cpu", gen)
        inputs = t.make_inputs(shape, "cpu", gen)
        step = t.make_step(shape)
        losses = []
        for _ in range(4):
            state, out = step(state, inputs)
            losses.append(float(out["loss"]))
        assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_reduced_steps_on_card_match_cpu(arch, cuda_device):
    """Every reduced step (prefill, decode, train) on the card against the
    same step on a CPU copy: logits and caches within ``LOGITS[bfloat16]``,
    train states within the bfloat16 step tolerance."""
    from repro_torch.training.tolerance import (logits_errors,
                                                train_step_errors)

    t = all_archs()[arch].reduced()
    moe = t.cfg.moe is not None
    for shape in (s for s in t.shapes().values() if not s.skip):
        gen = torch.Generator(device=cuda_device).manual_seed(13)
        state = t.init_state(shape, cuda_device, gen)
        inputs = t.make_inputs(shape, cuda_device, gen)
        cpu_state = tree_map(lambda x: x.cpu().clone(), state)
        cpu_in = tree_map(lambda x: x.cpu().clone(), inputs)
        step = t.make_step(shape)
        got_state, got = step(state, inputs)
        want_state, want = step(cpu_state, cpu_in)
        if shape.kind == "train":
            _, bad = train_step_errors(
                got_state, float(got["loss"]), want_state,
                float(want["loss"]), t._opt_cfg(),
                step_tolerance(torch.bfloat16, moe, t.moment_dtype))
            assert not bad, (arch, bad)
            continue
        if shape.kind == "prefill":
            assert logits_errors(got["logits"], want["logits"],
                                 torch.bfloat16, moe)[2]
        for f in ("k", "v"):
            key = "cache"
            a = (got if shape.kind == "prefill" else got_state)[key][f]
            b = (want if shape.kind == "prefill" else want_state)[key][f]
            assert logits_errors(a, b, torch.bfloat16, moe)[2], (arch, f)
