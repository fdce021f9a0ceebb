"""Multi-pod dry run (``repro/launch/dryrun.py``): every (arch x shape x
mesh) cell's step, run once on a fake mesh of the production size.

Host-only by nature: a fake process group of 256 (or 512) ranks stands in
for the reference's 512 placeholder host devices, the state and inputs
are DTensors over local shards of their per-device shapes on the meta
device (every op computes shapes only: nothing is allocated, no
collective moves data), and the step runs eagerly under
``cost.StepCost``.  Per cell this runs

    with process_group(256, fake=True):
        mesh = make_production_mesh()
        state = place_abstract(spec.abstract_state(shape), state_shardings)
        inputs = place_abstract(spec.abstract_inputs(shape), ...)
        with StepCost() as cost:
            spec.make_step(shape, axes_of(mesh))(state, inputs)

and records memory / FLOPs / collective traffic + the three roofline terms
(H100 model, ``cost.py``) to
``experiments/dryrun_torch/<arch>__<shape>__<mesh>__torch<X.Y>.json``
(the record's ``torch`` field in full).  A leaf whose
dims do not divide its mesh axes fails its cell, as ``jit`` refuses such an
argument.  ``out_shardings`` is checked against the outputs' ranks; the
outputs themselves keep the placements the step's ops give them.

A cell's record does not depend on what ran before it in the process:
``StepCost`` leaves out what DTensor's cached planning runs, and holds no
op's tensors in a reference cycle, so the live peak does not follow the
cyclic collector (a run again gives the same record, which the tests
pin).  The CLI and ``hillclimb`` run their cells one after another in one
process.

Usage (times are the host's, not a card's):
    python -m repro_torch.launch.dryrun --arch all --mesh both
    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k \\
        --mesh single
    python -m repro_torch.launch.dryrun --include-skipped
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from ..configs import all_archs, axes_of, get_arch
from ..training.optimizer import tree_leaves
from .cost import StepCost, _local, roofline
from .mesh import PRODUCTION, local_bytes, make_mesh, place_abstract, \
    process_group

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def mesh_name_of(shape) -> str:
    return "x".join(str(n) for n in shape)


def _alias_bytes(args, outs) -> int:
    """Bytes of the outputs' local tensors that share a storage with an
    argument (the reference donates its state: ``donate_argnums=0``)."""
    def key(t):
        return t.untyped_storage()._cdata

    held = {key(_local(t)) for t in tree_leaves(args)}
    seen, total = set(), 0
    for t in tree_leaves(outs):
        t = _local(t)
        k = key(t)
        if k in held and k not in seen:
            seen.add(k)
            total += t.numel() * t.element_size()
    return total


def measure_step(step, state, inputs, model_flops: float, n_devices: int):
    """Run ``step(state, inputs)`` once under ``StepCost``: the record's
    ``memory``, ``collectives`` and ``roofline``, and the step's
    outputs."""
    args = local_bytes(state) + local_bytes(inputs)
    device_type = _local(tree_leaves(state)[0]).device.type
    cost = StepCost(device_type).track((state, inputs))
    with cost:
        new_state, out = step(state, inputs)
    outs = (new_state, out)
    out_bytes = local_bytes(outs)
    alias = _alias_bytes((state, inputs), outs)
    temp = max(0, cost.peak - args - (out_bytes - alias))
    terms = roofline(cost, model_flops, n_devices)
    return {
        "memory": {
            "argument_bytes": args,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": alias,
            "peak_bytes_per_device": args + out_bytes + temp - alias,
        },
        "collectives": cost.collectives,
        "roofline": terms.as_dict(),
    }, outs


def _fake_step(spec, shape, mesh, n_dev):
    """The cell's step on ``mesh`` over meta local shards: the
    ``measure_step`` record, the outputs' leaves and the out specs."""
    axes = axes_of(mesh)
    state = place_abstract(spec.abstract_state(shape),
                           spec.state_shardings(shape, axes), mesh)
    inputs = place_abstract(spec.abstract_inputs(shape),
                            spec.input_shardings(shape, axes), mesh)
    step = spec.make_step(shape, axes)
    res, outs = measure_step(step, state, inputs, spec.model_flops(shape),
                             n_dev)
    return res, tree_leaves(outs), tree_leaves(spec.out_shardings(shape,
                                                                 axes))


def run_cell(spec, shape, *, multi_pod: bool = False, mesh_shape=None,
             axis_names=None, verbose: bool = True) -> dict:
    """One cell on a fake mesh: the production mesh (``multi_pod``), or
    ``mesh_shape`` / ``axis_names`` (e.g. (1, 1) or (2, 2) for tests)."""
    if mesh_shape is None:
        mesh_shape, axis_names = PRODUCTION[multi_pod]
    mesh_shape, axis_names = tuple(mesh_shape), tuple(axis_names)
    n_dev = 1
    for n in mesh_shape:
        n_dev *= n
    mesh_name = mesh_name_of(mesh_shape)
    rec = {
        "arch": spec.name,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": mesh_name,
        "n_devices": n_dev,
        "skip": shape.skip,
        "host_only": True,
        "torch": torch.__version__,
    }
    t0 = time.time()
    try:
        with process_group(n_dev, fake=True):
            # the mesh reads its rank layout from real tensors
            mesh = make_mesh(mesh_shape, axis_names)
            res, outs, out_specs = _fake_step(spec, shape, mesh, n_dev)
        if len(outs) != len(out_specs) or any(
                len(s) > t.dim() for s, t in zip(out_specs, outs)):
            raise ValueError("the step's outputs do not match "
                             "out_shardings")
        rec.update(status="ok", step_s=round(time.time() - t0, 2), **res)
        if verbose:
            m = rec["memory"]
            r = rec["roofline"]
            print(
                f"[ok] {spec.name:24s} {shape.name:14s} {mesh_name:8s} "
                f"host={rec['step_s']:6.1f}s "
                f"mem/dev={m['peak_bytes_per_device']/2**30:6.2f}GiB "
                f"dominant={r['dominant']:10s} "
                f"roofline={r['roofline_fraction']:.3f}",
                flush=True,
            )
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug report
        rec.update(
            status="error",
            step_s=round(time.time() - t0, 2),
            error=f"{type(e).__name__}: {e}",
            traceback=traceback.format_exc()[-2000:],
        )
        if verbose:
            print(f"[ERR] {spec.name} {shape.name} {mesh_name}: "
                  f"{rec['error'][:300]}", flush=True)
    return rec


def torch_tag() -> str:
    """``torch<major>.<minor>`` of the PyTorch that runs the dry run: its
    DTensor's strategies decide a cell's collectives, so records of two
    versions stand side by side."""
    return "torch" + ".".join(torch.__version__.split("+")[0]
                              .split(".")[:2])


def cell_path(arch: str, shape: str, mesh_name: str) -> Path:
    safe = arch.replace("/", "_")
    return OUT_DIR / f"{safe}__{shape}__{mesh_name}__{torch_tag()}.json"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--include-skipped", action="store_true",
                    help="also attempt cells marked skip (bonus long_500k)")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    archs = (all_archs() if args.arch == "all"
             else {args.arch: get_arch(args.arch)})
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_ok = n_err = n_skip = 0
    for name, spec in sorted(archs.items()):
        for sname, shape in spec.shapes().items():
            if args.shape != "all" and sname != args.shape:
                continue
            if shape.skip and not args.include_skipped:
                n_skip += 1
                print(f"[skip] {name} {sname}: {shape.skip}", flush=True)
                continue
            for multi in meshes:
                mesh_name = mesh_name_of(PRODUCTION[multi][0])
                path = cell_path(name, sname, mesh_name)
                if path.exists() and not args.force:
                    rec = json.loads(path.read_text())
                    if rec.get("status") == "ok":
                        print(f"[cached] {name} {sname} {mesh_name}",
                              flush=True)
                        n_ok += 1
                        continue
                rec = run_cell(spec, shape, multi_pod=multi)
                path.write_text(json.dumps(rec, indent=1))
                n_ok += rec["status"] == "ok"
                n_err += rec["status"] == "error"
    print(f"\ndry-run complete: ok={n_ok} errors={n_err} "
          f"skipped={n_skip}", flush=True)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
