"""The port's dry run (``repro_torch.launch.{dryrun,cost,hillclimb}``) on
fake meshes, host-only, against the reference's shard shapes and FLOP
conventions, on the CPU.

  * (d) ``dryrun.run_cell`` on a fake (2, 2) mesh for every reduced arch's
    cells: ``ok`` where every leaf divides the mesh, with the per-device
    argument bytes equal to the sum of JAX's ``shard_shape`` bytes over
    the reference's state and inputs and ``model_flops`` equal to the
    reference's; an ``error`` record where a leaf does not divide, JAX's
    ``shard_shape`` raising for the same cell.
  * On a fake 1x1 mesh the argument bytes and the FLOPs equal those of the
    same step on real tensors (a one-rank gloo group), and
    ``FlopCounterMode``'s count of the plain step: the CPU twin of
    ``chip_smoke.py`` phase 12c.
  * ``cost.StepCost`` counts collectives by kind and by the link their
    group crosses, and FLOPs by the class of their operands, each at its
    peak; a cell's record is the same in a fresh process's first run, its
    second, and a run in a process that ran other cells first; each
    hillclimb variant gives ``ok`` (``ann_index`` with its collectives
    stated as not measured).
"""
import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import all_archs, axes_of
from repro_torch.launch import cost as tcost
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch import mesh as tmesh
from repro_torch.training.optimizer import tree_map

ARCHS = sorted(all_archs())
NAMES = ("data", "model")


def _cells(spec):
    return [s for s in spec.shapes().values() if not s.skip]


def _ref_arg_bytes(j, jshape, mesh_shape):
    """The reference's per-device bytes of its state and inputs for one
    cell (JAX's ``shard_shape``), or the path of a leaf JAX refuses."""
    import jax
    from jax.sharding import AbstractMesh, NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro.configs.base import axes_of as j_axes_of

    amesh = AbstractMesh(mesh_shape, NAMES)
    jaxes = j_axes_of(types.SimpleNamespace(axis_names=NAMES,
                                            devices=np.empty(mesh_shape)))
    total = 0
    for tree, specs in ((j.abstract_state(jshape),
                         j.state_shardings(jshape, jaxes)),
                        (j.abstract_inputs(jshape),
                         j.input_shardings(jshape, jaxes))):
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        spec_leaves = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, JP))
        for (path, x), spec in zip(leaves, spec_leaves):
            try:
                local = NamedSharding(amesh, spec).shard_shape(x.shape)
            except ValueError:
                return None, jax.tree_util.keystr(path)
            total += math.prod(local) * np.dtype(x.dtype).itemsize
    return total, None


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_on_a_fake_2x2_mesh(arch):
    from repro.configs import all_archs as j_all

    j, t = j_all()[arch].reduced(), all_archs()[arch].reduced()
    for shape in _cells(t):
        jshape = j.shapes()[shape.name]
        rec = dryrun.run_cell(t, shape, mesh_shape=(2, 2), axis_names=NAMES,
                              verbose=False)
        want, bad = _ref_arg_bytes(j, jshape, (2, 2))
        where = (arch, shape.name)
        if bad is not None:
            # JAX refuses the leaf as a jit argument; the port's cell is an
            # error record
            assert rec["status"] == "error", (where, bad)
            assert rec["error"].startswith("ValueError"), rec["error"]
            continue
        assert rec["status"] == "ok", (where, rec.get("error"))
        m, r = rec["memory"], rec["roofline"]
        assert m["argument_bytes"] == want, where
        assert r["model_flops"] == j.model_flops(jshape), where
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
        assert m["peak_bytes_per_device"] == (m["argument_bytes"]
                                              + m["output_bytes"]
                                              + m["temp_bytes"]
                                              - m["alias_bytes"])
        assert r["dominant"] in ("compute", "memory", "collective")
        assert rec["host_only"] and rec["n_devices"] == 4


def test_dry_run_at_full_width_on_the_production_mesh():
    """qwen3-moe-235b-a22b's train step at its widths (2 of its layers, 128
    tokens of 16 sequences) on the fake 16x16 mesh: 4 KV heads under a
    16-way model axis ("q" sharding), one sequence a data device.  The
    head-split gradient of the attention's output must be brought back to
    the forward's layout before the (KV, G) unflatten (it raised
    before)."""
    t = all_archs()["qwen3-moe-235b-a22b"]
    t = dataclasses.replace(t, cfg=dataclasses.replace(t.cfg, n_layers=2),
                            train_seq=128, train_batch=16, accum_steps=1)
    rec = dryrun.run_cell(t, t.shapes()["train_4k"], verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == 256 and rec["collectives"]
    assert rec["roofline"]["model_flops"] == t.model_flops(
        t.shapes()["train_4k"])


@pytest.mark.parametrize("arch,shape_name", [
    ("olmo-1b", "train_4k"), ("qwen3-moe-30b-a3b", "decode_32k"),
    ("dlrm-rm2", "serve_p99")])
def test_fake_1x1_counts_equal_a_real_step(arch, shape_name):
    from torch.utils.flop_counter import FlopCounterMode

    t = all_archs()[arch].reduced()
    shape = t.shapes()[shape_name]
    fake = dryrun.run_cell(t, shape, mesh_shape=(1, 1), axis_names=NAMES,
                           verbose=False)
    assert fake["status"] == "ok", fake.get("error")
    gen = torch.Generator().manual_seed(7)
    state = t.init_state(shape, "cpu", gen)
    inputs = t.make_inputs(shape, "cpu", gen)
    copies = tree_map(torch.clone, (state, inputs))
    with FlopCounterMode(display=False) as fc:
        t.make_step(shape)(*copies)
    with tmesh.process_group(1, device="cpu"):
        mesh = tmesh.make_mesh((1, 1), NAMES)
        axes = axes_of(mesh)
        real, _ = dryrun.measure_step(
            t.make_step(shape, axes),
            tmesh.place(state, t.state_shardings(shape, axes), mesh),
            tmesh.place(inputs, t.input_shardings(shape, axes), mesh),
            t.model_flops(shape), 1)
    assert real["memory"]["argument_bytes"] == \
        fake["memory"]["argument_bytes"] == \
        tmesh.local_bytes(state) + tmesh.local_bytes(inputs)
    assert real["roofline"]["flops_per_device"] == \
        fake["roofline"]["flops_per_device"] == fc.get_total_flops()
    assert real["collectives"] == fake["collectives"] == {}


def test_step_cost_counts_collectives_by_link():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with tmesh.process_group(256, fake=True):
        mesh = tmesh.make_production_mesh()
        w = distribute_tensor(torch.empty(64, 32, device="meta"), mesh,
                              [Replicate(), Shard(0)])
        cost = tcost.StepCost()
        with cost:
            full = w.redistribute(mesh, [Replicate(), Replicate()])
        assert full.to_local().shape == (64, 32)
        # 16 consecutive ranks: two nodes of 8, so the network
        assert cost.collectives == {"all-gather": {
            "count": 1, "bytes": 64 * 32 * 4, "nvlink_bytes": 0,
            "network_bytes": 64 * 32 * 4}}
        terms = tcost.roofline(cost, 1.0, 256)
        assert terms.collective_s == 64 * 32 * 4 / tcost.NETWORK_BW
    with tmesh.process_group(8, fake=True):
        mesh = tmesh.make_mesh((2, 4), NAMES)
        x = distribute_tensor(torch.empty(8, 8, device="meta"), mesh,
                              [Shard(0), Shard(1)])
        cost = tcost.StepCost()
        with cost:
            x.redistribute(mesh, [Replicate(), Replicate()])
        # both axes stay inside one node of 8
        kinds = cost.collectives["all-gather"]
        assert kinds["count"] == 2 and kinds["network_bytes"] == 0
        assert kinds["nvlink_bytes"] == kinds["bytes"] > 0


def _record(arch, shape_name, mesh_shape, reduced):
    spec = all_archs()[arch]
    spec = spec.reduced() if reduced else spec
    rec = dryrun.run_cell(spec, spec.shapes()[shape_name],
                          mesh_shape=mesh_shape, axis_names=NAMES,
                          verbose=False)
    return {k: rec.get(k) for k in ("status", "error", "memory",
                                    "collectives", "roofline")}


# gcn-cora's ogb_products, whole, runs ops without a sharding strategy
# (their propagation traces a decomposition); olmo-1b's reduced decode
# plans a redistribution of a split cache
SAME_CELLS = (("gcn-cora", "ogb_products", (16, 16), False),
              ("olmo-1b", "decode_32k", (2, 2), True))


def test_a_cell_counts_the_same_first_or_again():
    """DTensor caches its planning for the process; ``StepCost`` leaves it
    out, so a cell's record does not depend on what ran before: a fresh
    process's first and second runs and this process's run agree."""
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(1) as pool:
        fresh = [[pool.apply(_record, cell) for _ in range(2)]
                 for cell in SAME_CELLS]
    for cell, (first, second) in zip(SAME_CELLS, fresh):
        here = _record(*cell)
        assert first["status"] == "ok", (cell, first["error"])
        assert first == second == here, cell


def test_flops_are_timed_at_their_class_peak():
    a = torch.empty(64, 32, device="meta")
    cost = tcost.StepCost()
    with cost:
        a @ a.t()
        a.bfloat16() @ a.t().bfloat16()
        a.double() @ a.t().double()
    n = 2 * 64 * 32 * 64
    assert cost.flops_by_class == {"fp32": n, "bf16": n, "fp64": n}
    terms = tcost.roofline(cost, 3.0 * n, 1)
    assert terms.compute_s == pytest.approx(
        n / 67e12 + n / 989e12 + n / 67e12, rel=1e-12)
    assert terms.peak_flops == pytest.approx(3 * n / terms.compute_s)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        assert tcost.flop_class([a]) == "tf32"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert tcost.flop_class([a.long(), a.half()]) == "bf16"


@pytest.mark.parametrize("cell", ["moe_train", "decode", "retrieval"])
def test_hillclimb_variants_on_reduced_specs(cell, tmp_path):
    recs = getattr(hillclimb, cell)(hillclimb.VARIANTS, reduced=True,
                                    out_dir=tmp_path)
    want = {"moe_train": 4, "decode": 2, "retrieval": 3}[cell]
    assert len(recs) == want
    for rec in recs:
        assert rec["status"] == "ok", (rec["tag"], rec.get("error"))
        assert (tmp_path / f"{rec['tag']}.json").exists()
    if cell == "retrieval":
        ann = recs[-1]
        assert ann["tag"] == "retrieval__ann_index"
        assert ann["collectives"].startswith("not measured")
        assert ann["memory"]["argument_bytes"] == _ref_ann_bytes(
            all_archs()["two-tower-retrieval"].reduced().cfg.tower_mlp[-1],
            1024, (2, 2))


def _ref_ann_bytes(d, n, mesh_shape):
    """The reference's graph state for ``n`` candidates under the
    hillclimb's placements: per-device bytes by JAX's ``shard_shape``."""
    import jax
    from jax.sharding import AbstractMesh, NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro.core import init_state
    from repro.core.types import ANNConfig

    cfg = ANNConfig(dim=d, n_cap=n, r=64, l_build=128, l_search=128,
                    metric="ip")
    state = jax.eval_shape(lambda: init_state(cfg))
    amesh = AbstractMesh(mesh_shape, NAMES)
    every = NAMES
    row = {"vectors", "norms", "adj", "active", "tombstone", "quarantine",
           "free_stack"}
    total = 4 * d
    for field in state._fields:
        x = getattr(state, field)
        if x is None:
            continue
        spec = JP(every, *([None] * (x.ndim - 1))) if field in row else JP()
        local = NamedSharding(amesh, spec).shard_shape(x.shape)
        total += math.prod(local) * np.dtype(x.dtype).itemsize
    return total


def test_dryrun_cli_writes_records_and_fails_on_an_error(tmp_path,
                                                         monkeypatch):
    import json

    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    dryrun.main(["--arch", "gcn-cora", "--shape", "molecule", "--mesh",
                 "single"])
    path = dryrun.cell_path("gcn-cora", "molecule", "16x16")
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["memory"]["argument_bytes"] > 0
    dryrun.main(["--arch", "gcn-cora", "--shape", "molecule", "--mesh",
                 "single"])                       # cached: no rerun
    monkeypatch.setattr(dryrun, "run_cell", lambda *a, **k: {
        "status": "error", "error": "ValueError: planted"})
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "gcn-cora", "--shape", "molecule", "--mesh",
                     "multi"])
    assert e.value.code == 1


def test_out_shardings_cover_the_outputs():
    """A cell's outputs have as many leaves as its ``out_shardings`` and no
    spec longer than its leaf: checked inside ``run_cell``, here on a
    planted mismatch."""
    t = all_archs()["dlrm-rm2"].reduced()
    shape = t.shapes()["serve_p99"]
    bad = dataclasses.replace(t)
    object.__setattr__(bad, "out_shardings", lambda s, a: ({}, {}))
    rec = dryrun.run_cell(bad, shape, mesh_shape=(1, 1), axis_names=NAMES,
                          verbose=False)
    assert rec["status"] == "error" and "out_shardings" in rec["error"]
