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

import torch_mesh_worker as worker
from torch_parity import cuda_device  # noqa: F401

from repro_torch.configs import all_archs, axes_of
from repro_torch.configs.base import (MeshAxes, P, map_rules, placements,
                                      shard_shape)
from repro_torch.configs.families import (LM_PARAM_RULES, _resolve,
                                          lm_attn_rules)
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as tl
from repro_torch.training.optimizer import tree_leaves, tree_map

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


def test_real_group_needs_a_rendezvous_and_a_rank_in_it():
    import torch.distributed as dist

    for kw in ({}, {"rank": 4, "init_method": "file:///nonexistent"},
               {"rank": -1, "init_method": "file:///nonexistent"}):
        with pytest.raises(ValueError):
            with tmesh.process_group(4, device="cpu", **kw):
                pass
    assert not dist.is_initialized()


def test_real_four_rank_group_builds_the_mesh(tmp_path):
    """``launch.mesh.spawn``: four processes join one real gloo group
    through ``process_group(4, rank=r, init_method=...)``; each builds the
    (2, 2) mesh at its own coordinates, an all-reduce meets every rank, a
    second group cannot nest inside, and the parent is left with no
    group."""
    import torch.distributed as dist

    tmesh.spawn(worker.group_probe, 4, args=(str(tmp_path),))
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    assert [g["rank"] for g in got] == [0, 1, 2, 3]
    assert all(g["world"] == 4 and g["mesh_shape"] == (2, 2)
               and g["names"] == ("data", "model") and g["sum"] == 6.0
               and not g["nested"] for g in got)
    assert [g["coords"] for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert not dist.is_initialized()


def test_spawn_raises_when_a_rank_fails():
    """A rank that raises ends the group's other ranks (one waits at a
    barrier) and raises in the caller instead of hanging."""
    with pytest.raises(Exception):
        tmesh.spawn(worker.fail_on_rank_one, 2)


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


_np_case = worker.np_case
_to_port = worker.to_port


def _to_ref(tree, dtypes=None):
    import jax.numpy as jnp

    if dtypes is None:
        return tree_map(jnp.asarray, tree)
    return tree_map(lambda x, d: jnp.asarray(x).astype(jnp.bfloat16)
                    if d == torch.bfloat16 else jnp.asarray(x), tree, dtypes)


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


_assert_step_close = worker.assert_step_close


# ---------------------------------------------------------------------------
# (c) make_step(shape, axes) on a real (2, 2) mesh of four gloo ranks
# ---------------------------------------------------------------------------


SPLIT, SPLIT_AXES = worker.SPLIT, worker.SPLIT_AXES


@pytest.fixture(scope="module")
def split_mesh_runs(tmp_path_factory):
    """Every ``SPLIT`` case stepped once on a real (2, 2) mesh of four gloo
    ranks (``launch.mesh.spawn``: four processes in one group): case ->
    the gathered (state, outputs).  Once a session: under pytest-xdist the
    first worker to need it runs it, under a file lock in the session's
    temporary root, and the others read its result."""
    import fcntl
    import os

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    d = root / "split_mesh"
    with open(root / "split_mesh.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (d / "got.pt").exists():
            d.mkdir(exist_ok=True)
            torch.save(worker.split_cases(), d / "cases.pt")
            tmesh.spawn(worker.run, 4,
                        args=(str(d / "cases.pt"), str(d / "got.pt")))
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

    from repro.configs.base import MeshAxes as JMeshAxes

    arch, shape_name, spec_kw, cfg_kw = SPLIT[case]
    t = worker.spec_of(arch, spec_kw, cfg_kw)
    shape = t.shapes()[shape_name]
    state, dtypes, inputs = _np_case(t, shape, worker.SEED)
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
# (d) none of the forms PyTorch 2.11's DTensor refuses
# ---------------------------------------------------------------------------

# ops whose DTensor strategy PyTorch 2.11 (the card's) lacks or gets wrong
# (2.13, this box's, runs them): an indexed tensor's gradient
# (``index_put`` with split values or a None index), ``index_add`` (no
# strategy), ``diagonal_backward`` (none)
REFUSED_211 = ("aten::index_put", "aten::_index_put_impl_",
               "aten::index_add", "aten::index_add_",
               "aten::diagonal_backward")


def _refused_211(func, args):
    """Why PyTorch 2.11's DTensor refuses ``func(*args)``, or None: one of
    ``REFUSED_211``; a view that 2.11 cannot make without a redistribution
    (``_view_refused_211``); an ``index`` whose index tensor splits one dim
    over two mesh dims."""
    from torch.distributed.tensor import Shard

    name = func._schema.name
    if name in REFUSED_211:
        return name
    if name in ("aten::view", "aten::_unsafe_view", "aten::reshape") and \
            tl.is_dtensor(args[0]) and isinstance(args[1], (list, tuple)) \
            and _view_refused_211(args[0], args[1]):
        return f"{name} {list(args[0].shape)} " \
               f"{tuple(args[0].placements)} -> {list(args[1])}"
    if name == "aten::index":
        for ix in args[1]:
            if tl.is_dtensor(ix):
                dims = [p.dim for p in ix.placements if type(p) is Shard]
                if len(dims) != len(set(dims)):
                    return f"{name} with an index {tuple(ix.placements)}"
    return None


def _view_refused_211(x, size) -> bool:
    """2.11's rule for a view of a DTensor (``_view_ops.py``'s
    ``propagate_shape_and_sharding``): a flatten whose dims after the first
    include a split one, or a split of a split dim whose first part does
    not divide by the mesh dim that splits it."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._ops._view_ops import (Flatten, InputDim,
                                                         Split, view_groups)

    split = {}
    for m, p in enumerate(x.placements):
        if type(p) is Shard:
            split.setdefault(p.dim, []).append(x.device_mesh.size(m))

    def first_dim(spec):
        if isinstance(spec, InputDim):
            return spec.input_dim
        if isinstance(spec, Flatten):
            return first_dim(spec.input_dims[0])
        if isinstance(spec, Split) and spec.split_id == 0:
            return first_dim(spec.input_dim)
        return None

    def refused(spec):
        if isinstance(spec, Flatten):
            return any(isinstance(d, InputDim) and d.input_dim in split
                       for d in spec.input_dims[1:])
        if isinstance(spec, Split):
            d = first_dim(spec.input_dim)
            return refused(spec.input_dim) or (
                spec.split_id == 0 and d in split
                and any(spec.group_shape[0] % m for m in split[d]))
        return False

    return any(refused(g) for g in view_groups(list(x.shape), list(size)))


def _steps_clear_of_211(step, state, inputs):
    """The ops of ``step(state, inputs)`` (forward and backward) that
    meet a DTensor and a form of ``_refused_211``."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves as pt_leaves

    found = []

    class Guard(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(tl.is_dtensor(a) for a in pt_leaves((args, kwargs))):
                why = _refused_211(func, args)
                if why:
                    found.append(why)
            return func(*args, **kwargs)

    with Guard():
        step(state, inputs)
    return found


@pytest.mark.parametrize("case", [f"{a}:{s}" for a, s in CASES])
def test_mesh_step_avoids_what_pytorch_2_11_refuses(case, cpu_mesh):
    """Every reduced cell's ``make_step(shape, axes)`` on the 1x1 mesh
    dispatches none of the DTensor forms that PyTorch 2.11 refuses (the
    card's: the faults its one-rank card case and phase 12 met)."""
    arch, shape_name = case.split(":")
    t = all_archs()[arch].reduced()
    shape = t.shapes()[shape_name]
    axes = axes_of(cpu_mesh)
    state, dtypes, inputs = _np_case(t, shape, seed=3)
    m_state = tmesh.place(_to_port(state, dtypes),
                          t.state_shardings(shape, axes), cpu_mesh)
    m_inputs = tmesh.place(_to_port(inputs), t.input_shardings(shape, axes),
                           cpu_mesh)
    assert not _steps_clear_of_211(t.make_step(shape, axes), m_state,
                                   m_inputs), case


@pytest.mark.parametrize("case", list(SPLIT))
def test_split_mesh_step_avoids_what_pytorch_2_11_refuses(case):
    """Each ``SPLIT`` case on a fake (2, 2) mesh (meta local shards, as the
    dry run runs it): no DTensor form that PyTorch 2.11 refuses, split
    leaves included (a flatten of a split dim, an index split twice)."""
    arch, shape_name, spec_kw, cfg_kw = SPLIT[case]
    t = worker.spec_of(arch, spec_kw, cfg_kw)
    shape = t.shapes()[shape_name]
    with tmesh.process_group(4, fake=True):
        mesh = tmesh.make_mesh((2, 2), ("data", "model"))
        axes = axes_of(mesh)
        state = tmesh.place_abstract(t.abstract_state(shape),
                                     t.state_shardings(shape, axes), mesh)
        inputs = tmesh.place_abstract(t.abstract_inputs(shape),
                                      t.input_shardings(shape, axes), mesh)
        found = _steps_clear_of_211(t.make_step(shape, axes), state, inputs)
    assert not found, (case, found[:4])


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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_steps_on_card_equal_plain_steps(arch, cuda_device):
    """Under a one-rank NCCL group, every reduced cell with DTensor state on
    the card's 1x1 mesh against its plain step on the card: bitwise, but
    the GCN's train steps, whose scatter-adds (``index_add_``) sum in the
    order the card's atomics take, within ``train_step_errors``."""
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
            got_state, got = t.make_step(shape, axes)(m_state, m_inputs)
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


@pytest.mark.requires_cuda
def test_group_above_the_card_count_raises(cuda_device, tmp_path):
    """A real group of more ranks than cards refuses at once, in
    ``process_group`` and in ``spawn`` (before any process starts),
    instead of waiting in NCCL's rendezvous."""
    import torch.distributed as dist

    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="cards"):
        with tmesh.process_group(n, device="cuda", rank=0,
                                 init_method=f"file://{tmp_path / 'store'}"):
            pass
    with pytest.raises(ValueError, match="cards"):
        tmesh.spawn(worker.group_probe, n, args=(str(tmp_path),),
                    device="cuda")
    assert not dist.is_initialized()
    assert not list(tmp_path.glob("rank*.pt"))
