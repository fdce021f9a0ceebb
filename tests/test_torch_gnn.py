"""The port's GCN family (``repro_torch.models.gnn``, ``GNNSpec``,
``gcn-cora``) against the reference's, on the CPU.

The same numpy parameters and inputs go through both packages.  Nothing
here is bitwise: the symmetric normalisation takes ``rsqrt`` of the
degrees, and ``torch.rsqrt`` and ``lax.rsqrt`` differ in the last bit on
about a third of them, so forwards and losses are held to rtol 2e-5 /
atol 1e-5 on grid data too (grid: features and biases k/4, weights k/2),
and whole train steps to the tolerances of
``torch_parity.assert_train_step_close``.  The minibatch shape's inputs
carry the reference's own ``hop1`` / ``hop2`` (``jax.random`` draws, which
a ``torch.Generator`` cannot reproduce); the port's sampler is held to the
reference's contract instead: every sampled id a CSR neighbour of its seed,
isolated nodes looping to themselves.  ``GNNSpec``'s fields, shapes, cells,
FLOPs and reduced spec equal the reference's, and its ``abstract_state`` /
``abstract_inputs`` at full width (on ``meta``) equal ``jax.eval_shape``'s.

Card cases (``python -m pytest --noconftest -m requires_cuda
tests/test_torch_gnn.py``) hold the reduced train steps and the sampler on
the card against the CPU; JAX is imported inside the CPU tests only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import (ATOL, RTOL, assert_train_step_close,  # noqa: F401
                          cuda_device)

from repro_torch import convert
from repro_torch.configs import all_archs
from repro_torch.models import gnn as tg
from repro_torch.models import layers as tl
from repro_torch.training.optimizer import tree_map

ARCH = "gcn-cora"
SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


def _t(x):
    return convert.params_from_numpy(x, "cpu")


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _gridify(params, rng):
    """Weights k/2 (|k| <= 1), biases k/4 (|k| <= 2)."""
    return [{"w": (rng.integers(-1, 2, size=p["w"].shape) / 2).astype(
                 np.float32),
             "b": (rng.integers(-2, 3, size=p["b"].shape) / 4).astype(
                 np.float32)} for p in params]


def _jspec(reduced=True):
    from repro.configs import all_archs as j_all

    s = j_all()[ARCH]
    return s.reduced() if reduced else s


def _ref_hops(offsets, cols, seeds, f1, f2, seed):
    """The reference's sampler (``jax.random``) over the port's CSR."""
    import jax

    from repro.models.gnn import sample_neighbors

    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    hop1 = np.asarray(sample_neighbors(k1, offsets, cols, seeds,
                                       f1)).reshape(-1)
    hop2 = np.asarray(sample_neighbors(k2, offsets, cols, hop1,
                                       f2)).reshape(-1)
    return hop1, hop2


def _case(shape_name, data, seed=0):
    """The reduced spec, its shape, a numpy state (the port's seeded init;
    grid values on ``data == "grid"``) and numpy inputs (the minibatch's
    hops drawn by the reference's sampler over the port's CSR)."""
    t = all_archs()[ARCH].reduced()
    shape = t.shapes()[shape_name]
    gen = torch.Generator().manual_seed(seed)
    state = convert.params_to_numpy(t.init_state(shape, "cpu", gen))
    inputs = convert.params_to_numpy(t.make_inputs(shape, "cpu", gen))
    rng = np.random.default_rng(seed)
    if data == "grid":
        state["params"] = _gridify(state["params"], rng)
        inputs["feats"] = (rng.integers(-2, 3, size=inputs["feats"].shape)
                           / 4).astype(np.float32)
    if shape.kind == "minibatch":
        offsets, cols = convert.params_to_numpy(
            t.make_csr(shape, "cpu", torch.Generator().manual_seed(seed)))
        d = shape.dims
        inputs["hop1"], inputs["hop2"] = _ref_hops(
            offsets, cols, inputs["seeds"], d["fan1"], d["fan2"], seed)
    return t, shape, state, inputs


def _loss_args(shape, inputs):
    batch = dict(inputs)
    if shape.kind == "graphbatch":
        batch["n_graphs"] = shape.dims["batch"]
    return batch


@pytest.mark.parametrize("data", ["grid", "gauss"])
@pytest.mark.parametrize("shape_name", SHAPES)
def test_forward_and_loss_match_reference(shape_name, data):
    import jax

    from repro.models import gnn as jg

    t, shape, state, inputs = _case(shape_name, data)
    cfg = t._cfg(shape)
    p = state["params"]
    if shape.kind == "minibatch":
        blocks = [inputs["hop2"], inputs["hop1"], inputs["seeds"]]
        want = jax.jit(lambda p, f, b: jg.sampled_gcn_forward(
            p, cfg, f, b))(p, inputs["feats"], blocks)
        got = tg.sampled_gcn_forward(_t(p), cfg, _t(inputs["feats"]),
                                     [_t(b) for b in blocks])
        j_loss, t_loss = jg.sampled_gcn_loss, tg.sampled_gcn_loss
    else:
        n = inputs["feats"].shape[0]
        want = jax.jit(lambda p, f, e: jg.gcn_forward(
            p, cfg, f, e, n_nodes=n))(p, inputs["feats"], inputs["edges"])
        got = tg.gcn_forward(_t(p), cfg, _t(inputs["feats"]),
                             _t(inputs["edges"]), n_nodes=n)
        j_loss, t_loss = jg.gcn_loss, tg.gcn_loss
    assert np.isfinite(np.asarray(want)).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    batch = _loss_args(shape, inputs)
    static = {k: batch.pop(k) for k in ("n_graphs",) if k in batch}
    want_l = jax.jit(lambda p, b: j_loss(p, cfg, {**b, **static}))(p, batch)
    got_l = t_loss(_t(p), cfg, {**_t(batch), **static})
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("data", ["grid", "gauss"])
@pytest.mark.parametrize("shape_name", SHAPES)
def test_train_step_matches_reference(shape_name, data):
    """The reduced spec's train step against ``jax.jit`` of the
    reference's: loss, params, m, v and step (on Gaussian data two steps,
    the second from the reference's state; grid data one, as its ReLU
    inputs of exactly 0 sit at the kink once the weights move)."""
    import jax

    t, shape, state, inputs = _case(shape_name, data, seed=2)
    j = _jspec()
    j_step = jax.jit(j.make_step(j.shapes()[shape_name]))
    t_step = t.make_step(shape)
    for i in range(1 if data == "grid" else 2):
        jstate, jout = j_step(state, inputs)
        tstate, tout = t_step(_t(state), _t(inputs))
        assert_train_step_close(tstate, tout, jstate, jout,
                                where=f"{shape_name} {data} step {i}")
        state = _np(jstate)


def test_loss_falls_on_a_repeated_batch():
    t = all_archs()[ARCH].reduced()
    shape = t.shapes()["full_graph_sm"]
    gen = torch.Generator().manual_seed(3)
    state, inputs = t.init_state(shape, "cpu", gen), t.make_inputs(
        shape, "cpu", gen)
    step = t.make_step(shape)
    losses = []
    for _ in range(5):
        state, out = step(state, inputs)
        losses.append(float(out["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_cross_entropy_ignore_and_out_of_range_labels():
    """``ignore_id`` left out of the mean; a label at or past V reads a NaN
    logit, as ``take_along_axis``'s fill does; a negative label reads
    class 0."""
    import jax

    from repro.models.layers import cross_entropy_loss as j_ce

    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 5)).astype(np.float32)
    for labels in ([0, 4, -1, 2, -1, 1], [0, 4, -3, 2, 3, 1],
                   [0, 5, -1, 2, 3, 1], [-1] * 6):
        labels = np.array(labels, np.int32)
        want = float(jax.jit(j_ce)(logits, labels))
        got = float(tl.cross_entropy_loss(_t(logits), _t(labels)))
        assert np.isnan(want) == np.isnan(got), labels
        if not np.isnan(want):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_message_passing_out_of_range_ids():
    """Edge ids out of range: ``jnp.take``'s NaN rows for the gathered
    sources, ``segment_sum`` dropping destinations, and the normalisation's
    ``x[ids]`` wrapping a negative id once and clamping."""
    import jax

    from repro.models import gnn as jg

    cfg = tg.GCNConfig(name="t", d_feat=3, n_classes=2, d_hidden=4)
    p = _np(jg.init_gcn_params(jax.random.PRNGKey(0), cfg))
    feats = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    for edges in ([[0, 1, 2, 4], [1, 2, 3, 0]], [[0, 1, 2, 4], [1, 7, 3, -1]],
                  [[0, -1, 2, 4], [1, 2, -4, 0]], [[0, 9, 2, 4], [1, 2, 3, 0]]):
        edges = np.array(edges, np.int32)
        want = np.asarray(jax.jit(lambda p, f, e: jg.gcn_forward(
            p, cfg, f, e, n_nodes=5))(p, feats, edges))
        got = tg.gcn_forward(_t(p), cfg, _t(feats), _t(edges),
                             n_nodes=5).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=ATOL)


def _csr(seed, n=50):
    rng = np.random.default_rng(seed)
    adj = [np.unique(rng.integers(0, n, size=rng.integers(0, 10)))
           for _ in range(n)]
    offsets = np.zeros(n + 1, np.int32)
    offsets[1:] = np.cumsum([len(a) for a in adj])
    cols = (np.concatenate(adj) if sum(map(len, adj)) else
            np.zeros(0)).astype(np.int32)
    return adj, offsets, cols


def _assert_real(adj, seeds, nbrs):
    for s, row in zip(np.asarray(seeds), np.asarray(nbrs)):
        allowed = set(adj[int(s)].tolist()) | {int(s)}
        assert set(row.tolist()) <= allowed
        if len(adj[int(s)]) == 0:
            assert (row == s).all()


def test_sampler_draws_real_neighbours():
    """``tests/test_archs_smoke.py::test_neighbor_sampler_is_real`` for the
    port's sampler, with isolated nodes (which self-loop); int32 out,
    (B, fanout), reproducible from the generator's seed."""
    adj, offsets, cols = _csr(0)
    assert any(len(a) == 0 for a in adj)
    seeds = torch.arange(50, dtype=torch.int32)
    draw = [tg.sample_neighbors(torch.Generator().manual_seed(4),
                                _t(offsets), _t(cols), seeds, 7)
            for _ in range(2)]
    assert draw[0].dtype == torch.int32 and draw[0].shape == (50, 7)
    assert torch.equal(*draw)
    _assert_real(adj, seeds, draw[0])
    # every neighbour of a node with a few of them gets drawn
    row = draw[0][int(np.argmax([len(a) for a in adj]))]
    assert len(set(row.tolist())) > 1


def test_make_inputs_samples_its_own_graph():
    """``make_inputs`` for the minibatch shape: ``hop1`` from the seeds'
    neighbourhoods and ``hop2`` from ``hop1``'s, in the graph
    ``make_csr`` draws from a generator seeded alike."""
    t = all_archs()[ARCH].reduced()
    shape = t.shapes()["minibatch_lg"]
    d = shape.dims
    inputs = t.make_inputs(shape, "cpu", torch.Generator().manual_seed(9))
    offsets, cols = t.make_csr(shape, "cpu",
                               torch.Generator().manual_seed(9))
    assert int(offsets[-1]) == d["n_edges"] == cols.shape[0]
    o, c = offsets.numpy(), cols.numpy()
    adj = [c[o[i]:o[i + 1]] for i in range(d["n_nodes"])]
    _assert_real(adj, inputs["seeds"],
                 inputs["hop1"].reshape(d["batch_nodes"], d["fan1"]))
    _assert_real(adj, inputs["hop1"],
                 inputs["hop2"].reshape(-1, d["fan2"]))
    assert all(v.device.type == "cpu" for v in inputs.values())


@pytest.mark.parametrize("reduced", [False, True])
def test_spec_matches_reference(reduced):
    j = _jspec(reduced)
    t = all_archs()[ARCH]
    t = t.reduced() if reduced else t
    assert (t.name, t.family, t.scale, t.n_layers, t.d_hidden) == \
        (j.name, j.family, j.scale, j.n_layers, j.d_hidden)
    assert ({k: dataclasses.asdict(v) for k, v in t.shapes().items()}
            == {k: dataclasses.asdict(v) for k, v in j.shapes().items()})
    assert t.cells() == j.cells() and t.skipped_cells() == j.skipped_cells()
    for name, shape in t.shapes().items():
        assert t.model_flops(shape) == j.model_flops(j.shapes()[name])
        assert dataclasses.asdict(t._cfg(shape)) == dataclasses.asdict(
            j._cfg(j.shapes()[name]))
        assert t._cfg(shape).n_params() == j._cfg(j.shapes()[name]).n_params()
    assert t.reduced().name == j.reduced().name


def _flat_meta(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_meta(v, f"{prefix}['{k}']"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_meta(v, f"{prefix}[{i}]"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[1],
                     tree.is_meta)}


@pytest.mark.parametrize("shape_name", SHAPES)
def test_abstract_trees_at_full_width(shape_name):
    import jax

    j, t = _jspec(reduced=False), all_archs()[ARCH]
    js, ts = j.shapes()[shape_name], t.shapes()[shape_name]

    def flat_jax(tree):
        return {jax.tree_util.keystr(p): (tuple(x.shape),
                                          str(np.dtype(x.dtype)), True)
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}

    assert _flat_meta(t.abstract_state(ts)) == flat_jax(j.abstract_state(js))
    assert _flat_meta(t.abstract_inputs(ts)) == flat_jax(
        j.abstract_inputs(js))


def test_train_state_round_trip_through_convert():
    """A GCN train state (list-of-dicts params, AdamW's m, v and int32
    step) from the reference into the port and back, bfloat16 moments
    included (they come back widened to float32, exactly)."""
    import jax

    from repro.models import gnn as jg
    from repro.training.optimizer import AdamWConfig as JCfg
    from repro.training.optimizer import adamw_init as j_init

    cfg = tg.GCNConfig(name="t", d_feat=6, n_classes=3)
    p = jg.init_gcn_params(jax.random.PRNGKey(1), cfg)
    for mdt in ("float32", "bfloat16"):
        opt = j_init(p, JCfg(moment_dtype=mdt))
        opt["m"] = jax.tree.map(lambda x: x + 0.3, opt["m"])
        state = {"params": p, "opt": dict(opt, step=np.int32(7))}
        port = convert.params_from_numpy(state, "cpu")
        assert port["opt"]["m"][0]["w"].dtype == getattr(torch, mdt)
        assert port["opt"]["step"].dtype == torch.int32 and \
            int(port["opt"]["step"]) == 7
        back = convert.params_to_numpy(port)
        a = jax.tree_util.tree_flatten_with_path(state)[0]
        b = jax.tree_util.tree_flatten_with_path(back)[0]
        assert [k for k, _ in a] == [k for k, _ in b]
        for (_, x), (_, y) in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x).astype(y.dtype), y)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.requires_cuda
def test_reduced_train_steps_on_card(cuda_device):
    """Each reduced shape's train step on the card against the same step on
    a CPU copy (the minibatch's inputs sampled on the card), two steps, to
    the whole-step tolerances of ``torch_parity.assert_train_step_close``
    (atomics order the card's scatter-adds differently)."""
    t = all_archs()[ARCH].reduced()
    for name in SHAPES:
        shape = t.shapes()[name]
        gen = torch.Generator(device=cuda_device).manual_seed(1)
        state = t.init_state(shape, cuda_device, gen)
        inputs = t.make_inputs(shape, cuda_device, gen)
        cpu_state = tree_map(lambda x: x.cpu().clone(), state)
        cpu_in = tree_map(lambda x: x.cpu(), inputs)
        step = t.make_step(shape)
        for i in range(2):
            state, out = step(state, inputs)
            cpu_state, cpu_out = step(cpu_state, cpu_in)
            assert_train_step_close(state, out,
                                    convert.params_to_numpy(cpu_state),
                                    {"loss": cpu_out["loss"].numpy()},
                                    where=f"{name} step {i}")


@pytest.mark.requires_cuda
def test_sampler_on_card(cuda_device):
    adj, offsets, cols = _csr(5)
    seeds = torch.arange(50, dtype=torch.int32, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    nbrs = tg.sample_neighbors(gen, _t(offsets).to(cuda_device),
                               _t(cols).to(cuda_device), seeds, 9)
    assert nbrs.is_cuda and nbrs.dtype == torch.int32
    _assert_real(adj, seeds.cpu(), nbrs.cpu())
