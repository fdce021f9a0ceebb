"""The port's mesh and sharding rules (``repro_torch.launch.mesh``,
``configs.base.{PartitionSpec, MeshAxes, axes_of, map_rules, placements,
shard_shape}``, the families' ``*_shardings`` and ``make_step(shape,
axes)``, ``Supervisor.run(shardings=)``) against the reference's, on the
CPU.

  * (a) Every unskipped cell's ``state_shardings`` / ``input_shardings`` /
    ``out_shardings`` equal the reference's leaf by leaf, path by path, on
    both production meshes (the reference's from a stub mesh: its
    ``axes_of`` reads only the axis names and the devices' shape).
  * (b) ``shard_shape`` equals ``NamedSharding(AbstractMesh(...),
    spec).shard_shape`` for every leaf of those cells, raising where JAX
    raises.
  * (c) ``make_step(shape, axes)`` with DTensor state on a one-rank gloo
    1x1 mesh equals the same step on plain tensors bitwise, and is held to
    the reference's ``make_step(shape, axes)`` (under ``jax.jit``) with the
    tolerances of ``repro_torch.training.tolerance`` and the recsys
    convention (``torch_parity.RTOL`` / ``ATOL``).  On a real (2, 2) mesh
    of four gloo ranks (``torch_mesh_worker``), where leaves are split, a
    few reduced cells are held to the plain step and the reference with
    the same tolerances.
  * (e) ``Supervisor.run(shardings=...)`` restores onto the placements and
    ends bitwise at the uninterrupted run's state.

Process groups are made inside fixtures and tests and torn down there.
The card case (``python -m pytest --noconftest -m requires_cuda
tests/test_torch_mesh.py``) steps reduced cells on a one-rank NCCL 1x1
mesh against their plain steps; JAX is imported inside the CPU tests only.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from torch_parity import (ATOL, RTOL, assert_logits_close,  # noqa: F401
                          assert_train_step_close, cuda_device)

from repro_torch import convert
from repro_torch.configs import all_archs, axes_of
from repro_torch.configs.base import (MeshAxes, P, map_rules, placements,
                                      shard_shape)
from repro_torch.configs.families import (LM_PARAM_RULES, _resolve,
                                          lm_attn_rules)
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.training.optimizer import tree_leaves, tree_map
from repro_torch.training.tolerance import LOGITS, step_tolerance

PROD = {"single": ((16, 16), ("data", "model")),
        "multi": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = sorted(all_archs())
LM_ARCHS = ("olmo-1b", "qwen2.5-32b", "qwen2-72b", "qwen3-moe-30b-a3b",
            "qwen3-moe-235b-a22b")
METHODS = ("state_shardings", "input_shardings", "out_shardings")


@pytest.fixture
def cpu_mesh():
    """A one-rank gloo group and a 1x1 ("data", "model") mesh on it."""
    with tmesh.process_group(1, device="cpu"):
        yield tmesh.make_mesh((1, 1), ("data", "model"))


def _ref_axes(mesh_key):
    from repro.configs.base import axes_of as j_axes_of

    shape, names = PROD[mesh_key]
    return j_axes_of(types.SimpleNamespace(axis_names=names,
                                           devices=np.empty(shape)))


def _jflat(tree):
    """{path: spec entries} of a reference spec tree."""
    import jax
    from jax.sharding import PartitionSpec as JP

    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in path): tuple(leaf) for path, leaf in leaves}


def _tflat(tree, prefix=()):
    """{path: spec entries} of a port spec tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _tflat(sub, prefix + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _tflat(sub, prefix + (str(i),)).items()}
    assert isinstance(tree, P), (prefix, tree)
    return {prefix: tuple(tree)}


def _jshapes(tree):
    import jax

    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in path): (tuple(x.shape), np.dtype(x.dtype))
            for path, x in leaves}


def _tshapes(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _tshapes(sub, prefix + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _tshapes(sub, prefix + (str(i),)).items()}
    return {prefix: tree}


def _cells(spec):
    return [s for s in spec.shapes().values() if not s.skip]


# ---------------------------------------------------------------------------
# (a) spec trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_key", PROD)
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_match_reference(arch, mesh_key):
    from repro.configs import all_archs as j_all

    j, t = j_all()[arch], all_archs()[arch]
    jaxes = _ref_axes(mesh_key)
    taxes = axes_of(dict(zip(PROD[mesh_key][1], PROD[mesh_key][0])))
    assert dataclasses.asdict(taxes) == dataclasses.asdict(jaxes)
    assert taxes.all == jaxes.all and taxes.all_size == jaxes.all_size
    assert [s.name for s in _cells(t)] == [s.name for s in _cells(j)]
    for shape in _cells(t):
        jshape = j.shapes()[shape.name]
        for meth in METHODS:
            want = _jflat(getattr(j, meth)(jshape, jaxes))
            got = _tflat(getattr(t, meth)(shape, taxes))
            assert got == want, (arch, shape.name, meth,
                                 set(got.items()) ^ set(want.items()))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_attn_rules_and_resolve_match_reference(arch):
    from jax.sharding import PartitionSpec as JP

    from repro.configs.families import LM_PARAM_RULES as J_RULES
    from repro.configs.families import _resolve as j_resolve
    from repro.configs.families import lm_attn_rules as j_rules

    cfg = all_archs()[arch].cfg
    for tp in (1, 2, 4, 8, 16):
        jmode, jr = j_rules(cfg.n_heads, cfg.n_kv_heads, tp)
        mode, r = lm_attn_rules(cfg.n_heads, cfg.n_kv_heads, tp)
        assert mode == jmode and sorted(r) == sorted(jr)
        assert all(tuple(r[k]) == tuple(jr[k]) for k in r), (arch, tp)
    for mesh_key in PROD:
        jaxes = _ref_axes(mesh_key)
        taxes = MeshAxes(**dataclasses.asdict(jaxes))
        rules = {**LM_PARAM_RULES, "x/dp": P("dp", None),
                 "x/all": P("all", "fsdp")}
        jrules = {**J_RULES, "x/dp": JP("dp", None),
                  "x/all": JP("all", "fsdp")}
        got, want = _resolve(rules, taxes), j_resolve(jrules, jaxes)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("arch,field,value", [
    ("qwen3-moe-30b-a3b", "moe_fsdp_dim", "ff"),
    ("qwen3-moe-235b-a22b", "moe_fsdp_dim", "d"),
    ("qwen2-72b", "serve_param_fsdp", False),
    ("qwen3-moe-30b-a3b", "serve_param_fsdp", False)])
def test_sharding_variants_match_reference(arch, field, value):
    from repro.configs import all_archs as j_all

    j = dataclasses.replace(j_all()[arch], **{field: value})
    t = dataclasses.replace(all_archs()[arch], **{field: value})
    jaxes = _ref_axes("single")
    taxes = MeshAxes(**dataclasses.asdict(jaxes))
    for shape in _cells(t):
        got = _tflat(t.state_shardings(shape, taxes))
        want = _jflat(j.state_shardings(j.shapes()[shape.name], jaxes))
        assert got == want, (arch, field, shape.name)


def test_map_rules_longest_substring_and_default_replicated():
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from repro.configs.base import map_rules as j_map

    shapes = {"a": {"w": (4, 8), "w_up": (4, 8, 2)}, "b": [(3,), (3, 5)],
              "c": (7,)}

    def build(s, leaf):
        if isinstance(s, dict):
            return {k: build(v, leaf) for k, v in s.items()}
        if isinstance(s, list):
            return [build(v, leaf) for v in s]
        return leaf(s)

    ttree = build(shapes, lambda s: torch.empty(s, device="meta"))

    rules = {"a/w": ("x", None), "a/w_up": (None, "y", "x"), "b/1": ("y",),
             "w": ("z",)}
    got = map_rules(ttree, {k: P(*v) for k, v in rules.items()})
    want = j_map(build(shapes, jnp.zeros),
                 {k: JP(*v) for k, v in rules.items()})
    assert _tflat(got) == _jflat(want)
    assert tuple(got["c"]) == () and tuple(got["a"]["w_up"]) == (None, "y",
                                                                 "x")
    with pytest.raises(ValueError):
        map_rules({"c": torch.empty(7, device="meta")},
                  {"c": P("x", None)})


@pytest.mark.parametrize("multi", [False, True])
def test_axes_of_production_meshes(multi):
    key = "multi" if multi else "single"
    n = 512 if multi else 256
    with tmesh.process_group(n, fake=True):
        mesh = tmesh.make_production_mesh(multi_pod=multi)
        assert tuple(mesh.mesh_dim_names) == PROD[key][1]
        assert tuple(mesh.shape) == PROD[key][0]
        assert dataclasses.asdict(axes_of(mesh)) == dataclasses.asdict(
            _ref_axes(key))


# ---------------------------------------------------------------------------
# (b) shard shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_key", PROD)
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_shapes_match_jax(arch, mesh_key):
    from jax.sharding import AbstractMesh, NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro.configs import all_archs as j_all

    j, t = j_all()[arch], all_archs()[arch]
    jaxes, (mshape, names) = _ref_axes(mesh_key), PROD[mesh_key]
    taxes = axes_of(dict(zip(names, mshape)))
    amesh = AbstractMesh(mshape, names)
    for shape in _cells(t):
        jshape = j.shapes()[shape.name]
        for jtree, ttree, jspec, tspec in (
                (j.abstract_state(jshape), t.abstract_state(shape),
                 j.state_shardings(jshape, jaxes),
                 t.state_shardings(shape, taxes)),
                (j.abstract_inputs(jshape), t.abstract_inputs(shape),
                 j.input_shardings(jshape, jaxes),
                 t.input_shardings(shape, taxes))):
            jleaves, tleaves = _jshapes(jtree), _tshapes(ttree)
            assert sorted(jleaves) == sorted(tleaves), (arch, shape.name)
            jspecs, tspecs = _jflat(jspec), _tflat(tspec)
            for path, (gshape, _) in jleaves.items():
                assert tuple(tleaves[path].shape) == gshape, path
                try:
                    want = NamedSharding(amesh, JP(*jspecs[path])
                                         ).shard_shape(gshape)
                except ValueError:
                    with pytest.raises(ValueError):
                        shard_shape(gshape, P(*tspecs[path]),
                                    dict(zip(names, mshape)))
                    continue
                got = shard_shape(gshape, P(*tspecs[path]),
                                  dict(zip(names, mshape)))
                assert got == tuple(want), (arch, shape.name, path)


def test_placements_and_shard_shape_rules():
    from torch.distributed.tensor import Replicate, Shard

    sizes = {"pod": 2, "data": 4, "model": 8}
    assert placements(P(("pod", "data"), "model"), sizes) == (
        Shard(0), Shard(0), Shard(1))
    assert placements(P(None, "data"), sizes) == (Replicate(), Shard(1),
                                                  Replicate())
    # an axis of size 1 splits nothing
    assert placements(P("data", "model"), {"data": 1, "model": 2}) == (
        Replicate(), Shard(1))
    with pytest.raises(NotImplementedError):
        placements(P(("model", "data")), sizes)
    with pytest.raises(ValueError):
        placements(P("data", "data"), sizes)
    assert shard_shape((16, 24), P(("pod", "data"), "model"), sizes) == (
        2, 3)
    assert shard_shape((5, 3), P(), sizes) == (5, 3)
    for bad in (P("data"), P(None, None, "model"), P("gpu")):
        with pytest.raises(ValueError):
            shard_shape((6, 3), bad, sizes)
    # a one-name tuple is the name, as JAX normalises it
    from jax.sharding import PartitionSpec as JP

    assert tuple(P(("data",), None)) == tuple(JP(("data",), None))


def test_process_group_is_torn_down_and_not_nested():
    import torch.distributed as dist

    with tmesh.process_group(4, fake=True):
        with pytest.raises(RuntimeError):
            with tmesh.process_group(1, device="cpu"):
                pass
        with pytest.raises(RuntimeError):
            tmesh.make_mesh((2, 1), ("data", "model"))
        mesh = tmesh.make_mesh((2, 2), ("data", "model"))
        assert mesh.size() == 4
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with tmesh.process_group(2, device="cpu"):
            pass
    assert not dist.is_initialized()


def test_constrain_is_the_identity_off_a_mesh(cpu_mesh):
    x = torch.arange(6.0).reshape(2, 3)
    assert tl.constrain(x, P("data", None)) is x
    assert tl.constrain(x, None) is x
    d = tmesh.place(x, P(None, "model"), cpu_mesh)
    y = tl.constrain(d, P("data", None))
    assert torch.equal(y.to_local(), x)
    assert tl.constrain(d, None) is d


# ---------------------------------------------------------------------------
# (c) make_step(shape, axes) on a 1x1 mesh against the reference
# ---------------------------------------------------------------------------


def _np_case(t, shape, seed):
    """The port's seeded state and inputs as numpy trees (a decode cache
    filled with random values and lengths; bfloat16 moments kept)."""
    gen = torch.Generator().manual_seed(seed)
    state = t.init_state(shape, "cpu", gen)
    inputs = t.make_inputs(shape, "cpu", gen)
    dtypes = tree_map(lambda x: x.dtype, state)
    state, inputs = (convert.params_to_numpy(state),
                     convert.params_to_numpy(inputs))
    if shape.kind == "decode":
        rng = np.random.default_rng(seed)
        c = state["cache"]
        for f in ("k", "v"):
            c[f] = rng.normal(size=c[f].shape).astype(np.float32)
        c["len"] = rng.integers(1, c["k"].shape[2] - 1,
                                size=c["len"].shape).astype(np.int32)
    return state, dtypes, inputs


def _to_ref(tree, dtypes=None):
    import jax.numpy as jnp

    if dtypes is None:
        return tree_map(jnp.asarray, tree)
    return tree_map(lambda x, d: jnp.asarray(x).astype(jnp.bfloat16)
                    if d == torch.bfloat16 else jnp.asarray(x), tree, dtypes)


def _to_port(tree, dtypes=None):
    if dtypes is None:
        return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)
    return tree_map(lambda x, d: torch.from_numpy(np.array(x)).to(d), tree,
                    dtypes)


def _local(tree):
    return tree_map(lambda x: x.to_local() if tl.is_dtensor(x) else x, tree)


def _ref_step(arch, shape_name, jaxes, **kw):
    from repro.configs import all_archs as j_all

    j = dataclasses.replace(j_all()[arch].reduced(), **kw)
    return j.make_step(j.shapes()[shape_name], jaxes)


CASES = ([(a, s) for a in LM_ARCHS
          for s in ("train_4k", "prefill_32k", "decode_32k")]
         + [(a, s) for a in ("din", "dlrm-mlperf", "dlrm-rm2",
                             "two-tower-retrieval")
            for s in ("train_batch", "serve_p99", "retrieval_cand")]
         + [("gcn-cora", s) for s in ("full_graph_sm", "minibatch_lg",
                                      "ogb_products", "molecule")])
EXTRA = {"accum": ("olmo-1b", "train_4k", {"accum_steps": 2}, 16, 1),
         "two_phase": ("two-tower-retrieval", "retrieval_cand",
                       {"two_phase_topk": True}, 2, 2)}


@pytest.mark.parametrize("case", [f"{a}:{s}" for a, s in CASES]
                         + list(EXTRA))
def test_mesh_step_matches_reference(case, cpu_mesh):
    """The port's ``make_step(shape, axes)`` on DTensor state placed by
    ``state_shardings`` / ``input_shardings`` on the 1x1 mesh: bitwise the
    same step on plain tensors, and within the reference's tolerance of
    its ``make_step(shape, axes)``.  ``accum``: olmo-1b at
    ``accum_steps=2`` with stub axes of ``dp_size`` 16, so that
    ``_eff_accum`` gives 4 microbatches; ``two_phase``: two-tower's
    two-phase top-k over ``axes.all_size`` = 4 blocks."""
    import jax

    from repro.configs.base import MeshAxes as JMeshAxes

    if case in EXTRA:
        arch, shape_name, kw, dp, tp = EXTRA[case]
    else:
        (arch, shape_name), kw, dp, tp = case.split(":"), {}, 1, 1
    t = dataclasses.replace(all_archs()[arch].reduced(), **kw)
    shape = t.shapes()[shape_name]
    fields = dict(dp=("data",), fsdp="data", model="model", dp_size=dp,
                  model_size=tp)
    taxes, jaxes = MeshAxes(**fields), JMeshAxes(**fields)
    state, dtypes, inputs = _np_case(t, shape, seed=3)
    jstate, jout = jax.jit(_ref_step(arch, shape_name, jaxes, **kw))(
        _to_ref(state, dtypes), _to_ref(inputs))
    step = t.make_step(shape, taxes)
    pstate, pout = step(_to_port(state, dtypes), _to_port(inputs))
    mesh_axes = axes_of(cpu_mesh)
    mstate = tmesh.place(_to_port(state, dtypes),
                         t.state_shardings(shape, mesh_axes), cpu_mesh)
    minputs = tmesh.place(_to_port(inputs),
                          t.input_shardings(shape, mesh_axes), cpu_mesh)
    mstate, mout = step(mstate, minputs)
    assert all(tl.is_dtensor(x) for x in tree_leaves(mstate))
    for a, b in zip(tree_leaves((pstate, pout)),
                    tree_leaves(_local((mstate, mout)))):
        assert a.dtype == b.dtype and torch.equal(a, b), case

    _assert_step_close(case, t, shape, state, dtypes, inputs,
                       (pstate, pout), (jstate, jout))


def _assert_step_close(case, t, shape, state, dtypes, inputs, got, want):
    """``got`` = the port's (state, outputs) within the tolerance of
    ``want`` = the reference's or another port step's, by the cell's kind:
    a train step by ``train_step_errors``, prefill logits and caches and
    decode caches by ``LOGITS``, a decode's next token on the rows whose
    top two logits (of the plain decode from ``state``) stand apart, and
    recsys outputs by ``RTOL`` / ``ATOL`` (ids exactly)."""
    (pstate, pout), (jstate, jout) = got, want
    moe = getattr(getattr(t, "cfg", None), "moe", None) is not None
    if shape.kind == "train":
        tol = (step_tolerance(torch.bfloat16, moe, t.moment_dtype)
               if t.family == "lm" else None)
        assert_train_step_close(pstate, pout, jstate, jout, where=case,
                                tol=tol)
    elif shape.kind == "prefill":
        for key, g, w in (
                ("logits", pout["logits"], jout["logits"]),
                ("k", pout["cache"]["k"], jout["cache"]["k"]),
                ("v", pout["cache"]["v"], jout["cache"]["v"])):
            assert_logits_close(g, w, torch.bfloat16, moe, f"{case} {key}")
    elif shape.kind == "decode":
        fresh = _to_port(state, dtypes)
        logits, _ = tt.decode_step(fresh["params"], t.cfg, fresh["cache"],
                                   _to_port(inputs)["tokens"])
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > LOGITS[torch.bfloat16][0] * \
            float(logits.abs().max())
        w = torch.from_numpy(np.array(jout["next_token"]))
        assert torch.equal(pout["next_token"][sure], w[sure]), case
        for f in ("k", "v"):
            assert_logits_close(pstate["cache"][f], jstate["cache"][f],
                                torch.bfloat16, moe, f"{case} {f}")
    else:
        assert sorted(pout) == sorted(jout)
        for key in jout:
            g, w = np.asarray(pout[key]), np.asarray(jout[key])
            assert g.dtype == w.dtype and np.isfinite(g).all()
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{case} {key}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=case)


# ---------------------------------------------------------------------------
# (c) make_step(shape, axes) on a real (2, 2) mesh of four gloo ranks
# ---------------------------------------------------------------------------


# case -> (arch, shape, spec fields, cfg fields): reduced cells whose leaves
# divide a (2, 2) mesh.  The LM's attention sharding by its heads at tp 2:
# "kv" (2 KV heads), "q" (1 KV head, 4 query heads), "hd" (1 KV head, 3
# query heads: head_dim split).  dlrm-rm2's and the GCN's whole-graph train
# cells have leaves that do not divide (2, 2) (``test_torch_dryrun``'s
# error records), so DLRM serves and the GCN trains on molecules.
SPLIT = {
    "olmo-1b:train_4k": ("olmo-1b", "train_4k", {}, {}),
    "olmo-1b:decode_32k": ("olmo-1b", "decode_32k", {}, {}),
    "olmo-1b:train_4k:q": ("olmo-1b", "train_4k", {}, {"n_kv_heads": 1}),
    "olmo-1b:train_4k:hd": ("olmo-1b", "train_4k", {},
                            {"n_heads": 3, "n_kv_heads": 1}),
    "dlrm-rm2:serve_p99": ("dlrm-rm2", "serve_p99", {}, {}),
    "two-tower-retrieval:retrieval_cand": (
        "two-tower-retrieval", "retrieval_cand", {"two_phase_topk": True},
        {}),
    "gcn-cora:molecule": ("gcn-cora", "molecule", {}, {}),
}
SPLIT_AXES = dict(dp=("data",), fsdp="data", model="model", dp_size=2,
                  model_size=2)


@pytest.fixture(scope="module")
def split_mesh_runs(tmp_path_factory):
    """Every ``SPLIT`` case stepped once on a real (2, 2) mesh of four gloo
    ranks (four spawned processes): case -> the gathered (state,
    outputs).  Once a session: under pytest-xdist the first worker to need
    it runs it, under a file lock in the session's temporary root, and the
    others read its result."""
    import fcntl
    import os

    import torch.multiprocessing as mp

    import torch_mesh_worker as worker

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    d = root / "split_mesh"
    with open(root / "split_mesh.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (d / "got.pt").exists():
            d.mkdir(exist_ok=True)
            cases = {}
            for case, (arch, shape_name, spec_kw, cfg_kw) in SPLIT.items():
                t = worker.spec_of(arch, spec_kw, cfg_kw)
                state, dtypes, inputs = _np_case(
                    t, t.shapes()[shape_name], seed=7)
                cases[case] = (arch, shape_name, spec_kw, cfg_kw,
                               _to_port(state, dtypes), _to_port(inputs))
            torch.save(cases, d / "cases.pt")
            mp.spawn(worker.run,
                     args=(4, f"file://{d / 'store'}", str(d / "cases.pt"),
                           str(d / "got.pt")),
                     nprocs=4, join=True)
    return torch.load(d / "got.pt", weights_only=False)


@pytest.mark.parametrize("case", list(SPLIT))
def test_split_mesh_step_matches_plain_and_reference(case, split_mesh_runs):
    """``make_step(shape, axes)`` on a real (2, 2) mesh, each leaf split
    where its spec says (shards, per-device attention blocks, a
    vocabulary-split loss, sharded cache writes, gradients reduced to their
    parameters' placements), gathered whole: within the cell's tolerance
    of the same step on plain tensors and of the reference's
    ``make_step(shape, axes)``, at the same axes (``dp_size`` =
    ``model_size`` = 2)."""
    import jax

    import torch_mesh_worker as worker
    from repro.configs.base import MeshAxes as JMeshAxes

    arch, shape_name, spec_kw, cfg_kw = SPLIT[case]
    t = worker.spec_of(arch, spec_kw, cfg_kw)
    shape = t.shapes()[shape_name]
    state, dtypes, inputs = _np_case(t, shape, seed=7)
    taxes, jaxes = MeshAxes(**SPLIT_AXES), JMeshAxes(**SPLIT_AXES)
    step = t.make_step(shape, taxes)
    plain = step(_to_port(state, dtypes), _to_port(inputs))
    from repro.configs import all_archs as j_all

    j = j_all()[arch].reduced()
    if cfg_kw:
        j = dataclasses.replace(j, cfg=dataclasses.replace(j.cfg, **cfg_kw))
    j = dataclasses.replace(j, **spec_kw)
    ref = jax.jit(j.make_step(j.shapes()[shape_name], jaxes))(
        _to_ref(state, dtypes), _to_ref(inputs))
    got = split_mesh_runs[case]
    for a, b in zip(tree_leaves(got), tree_leaves(plain)):
        assert a.dtype == b.dtype and a.shape == b.shape, case
    _assert_step_close(case, t, shape, state, dtypes, inputs, got, plain)
    _assert_step_close(case, t, shape, state, dtypes, inputs, got, ref)


# ---------------------------------------------------------------------------
# (e) supervised restore onto the placements
# ---------------------------------------------------------------------------


def test_supervised_restore_lands_on_the_placements(cpu_mesh, tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.ft import Supervisor

    t = all_archs()["olmo-1b"].reduced()
    shape = t.shapes()["train_4k"]
    axes = axes_of(cpu_mesh)
    specs = t.state_shardings(shape, axes)
    step = t.make_step(shape, axes)
    state, dtypes, _ = _np_case(t, shape, seed=4)

    def batch(i):
        gen = torch.Generator().manual_seed(100 + i)
        return tmesh.place(t.make_inputs(shape, "cpu", gen),
                           t.input_shardings(shape, axes), cpu_mesh)

    def step_fn(st, i):
        return step(st, batch(i))[0]

    def placed():
        return tmesh.place(_to_port(state, dtypes), specs, cpu_mesh)

    plain = placed()
    for i in range(5):
        plain = step_fn(plain, i)
    shardings = tmesh.shardify(cpu_mesh, specs)
    restored = []

    def spy(st, i):
        restored.append(st)
        return step_fn(st, i)

    sup = Supervisor(CheckpointManager(tmp_path), checkpoint_every=2)
    final, info = sup.run(placed(), spy, 5, shardings=shardings,
                          fail_at={3: 1})
    assert info == {"restarts": 1, "final_step": 5}
    # the step after the failure ran on the restored state: DTensors on
    # the specs' placements
    back = restored[3]
    for x, spec in zip(tree_leaves(back), tree_leaves(specs)):
        assert tl.is_dtensor(x) and tuple(x.placements) == placements(
            spec, cpu_mesh)
    for a, b in zip(tree_leaves(_local(plain)), tree_leaves(_local(final))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_restore_onto_another_layout(cpu_mesh, tmp_path):
    """A checkpoint written from plain tensors restored as DTensors on the
    mesh (the reference's elastic rescale), values unchanged."""
    from repro_torch.checkpoint import CheckpointManager, restore_onto

    t = all_archs()["dlrm-rm2"].reduced()
    shape = t.shapes()["train_batch"]
    state = t.init_state(shape, "cpu", torch.Generator().manual_seed(6))
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, state)
    _, tree, _ = mgr.load(1, like=state)
    specs = t.state_shardings(shape, axes_of(cpu_mesh))
    got = restore_onto(tree, tmesh.shardify(cpu_mesh, specs))
    for a, b in zip(tree_leaves(state), tree_leaves(got)):
        assert tl.is_dtensor(b) and torch.equal(a, b.to_local())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


# cells whose mesh step needs a DTensor strategy that PyTorch 2.11 (the
# card's) lacks; there they raise a sharding-propagation error, which the
# card test accepts for these cells only (2.13 runs them: the CPU cases)
CARD_GAPS = {
    ("dlrm-mlperf", "train_batch"): "index_put with a None index",
    ("dlrm-rm2", "train_batch"): "index_put with a None index",
    ("two-tower-retrieval", "train_batch"): "diagonal_backward",
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_steps_on_card_equal_plain_steps(arch, cuda_device):
    """Under a one-rank NCCL group, every reduced cell with DTensor state on
    the card's 1x1 mesh against its plain step on the card: bitwise, but
    the GCN's train steps, whose scatter-adds (``index_add_``) sum in the
    order the card's atomics take, within ``train_step_errors``; a cell of
    ``CARD_GAPS`` may raise DTensor's sharding-propagation error."""
    from repro_torch.training.tolerance import train_step_errors

    t = all_archs()[arch].reduced()
    with tmesh.process_group(1, device=cuda_device):
        mesh = tmesh.make_mesh((1, 1), ("data", "model"), "cuda")
        axes = axes_of(mesh)
        for shape in _cells(t):
            gen = torch.Generator(device=cuda_device).manual_seed(5)
            state = t.init_state(shape, cuda_device, gen)
            inputs = t.make_inputs(shape, cuda_device, gen)
            m_state = tmesh.place(tree_map(torch.clone, state),
                                  t.state_shardings(shape, axes), mesh)
            m_inputs = tmesh.place(inputs, t.input_shardings(shape, axes),
                                   mesh)
            want_state, want = t.make_step(shape)(state, inputs)
            try:
                got_state, got = t.make_step(shape, axes)(m_state, m_inputs)
            except (RuntimeError, NotImplementedError) as e:
                assert (arch, shape.name) in CARD_GAPS, (arch, shape.name, e)
                assert "strategy" in str(e).lower() or \
                    "Strategy" in str(e), e
                continue
            if t.family == "gnn":
                _, bad = train_step_errors(
                    _local(got_state), float(got["loss"].to_local()
                                             if tl.is_dtensor(got["loss"])
                                             else got["loss"]),
                    want_state, float(want["loss"]))
                assert not bad, (arch, shape.name, bad)
                continue
            for a, b in zip(tree_leaves((want_state, want)),
                            tree_leaves(_local((got_state, got)))):
                assert a.dtype == b.dtype and torch.equal(a, b), (
                    arch, shape.name)
