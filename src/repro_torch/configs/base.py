"""The uniform architecture-spec interface (``repro/configs/base.py``), in
PyTorch's idiom.

Every arch exposes, per input shape ("cell"):
  * ``abstract_state`` / ``abstract_inputs`` — the persistent state (params,
    optimiser, candidate embeddings) and the step inputs as tensors on
    ``torch.device("meta")``: the reference's tree, shapes and dtypes,
    nothing allocated (the counterpart of ``jax.eval_shape``);
  * ``init_state`` / ``make_inputs`` — the same trees as real tensors, drawn
    from an explicit ``torch.Generator`` (default: the card, seed 0);
  * ``make_step`` — ``step(state, inputs) -> (state', out)``;
  * ``state_shardings`` / ``input_shardings`` / ``out_shardings`` —
    trees of ``PartitionSpec`` (the port's own type, below) over a
    ``MeshAxes``;
  * ``model_flops`` — useful-work FLOPs (the 6·N·D / 2·N·D conventions);
  * ``reduced`` — a tiny same-family spec for CPU tests.

A ``PartitionSpec`` says, per leading tensor dim, which mesh axes split it,
as JAX's does; ``placements`` turns it into the DTensor placements of one
``torch.distributed.device_mesh.DeviceMesh`` (one placement per mesh dim),
and ``shard_shape`` gives the per-device shape, raising on an uneven split
as ``jit``'s arguments do.  ``launch/mesh.py`` places whole trees.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from ..core.types import resolve_device


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                      # train | prefill | decode | serve | ...
    dims: Mapping[str, int]
    skip: Optional[str] = None     # reason string when the cell is skipped


class PartitionSpec:
    """``jax.sharding.PartitionSpec``: one entry per leading tensor dim, a
    mesh axis name, a tuple of names (the dim split over their product,
    the first name major) or None (not split); dims past the last entry
    are not split.  A one-name tuple is that name, as JAX normalises it.
    Not a tuple, so that tree maps take it as a leaf."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e

        self._entries = tuple(norm(e) for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        return (isinstance(other, PartitionSpec)
                and self._entries == other._entries)

    def __hash__(self):
        return hash(self._entries)

    def __repr__(self):
        return "P" + repr(self._entries)

    def axes(self) -> Tuple[Tuple[int, str], ...]:
        """(tensor dim, mesh axis name) for every axis that splits a dim,
        in the spec's order."""
        out = []
        for dim, e in enumerate(self._entries):
            for name in (e if isinstance(e, tuple) else (e,)):
                if name is not None:
                    out.append((dim, name))
        return tuple(out)


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical axis names (and sizes) of the active mesh."""
    dp: Tuple[str, ...]            # pure data-parallel axes (incl. "pod")
    fsdp: Any                      # parameter-sharding data axis (or tuple)
    model: str                     # tensor/expert-parallel axis
    dp_size: int = 16              # product of dp axis sizes
    model_size: int = 16

    @property
    def all(self) -> Tuple[str, ...]:
        return self.dp + (self.model,)

    @property
    def all_size(self) -> int:
        return self.dp_size * self.model_size


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or any object with
    ``mesh_dim_names`` and ``shape``), or of such a mapping itself."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axes_of(mesh) -> MeshAxes:
    shape = mesh_sizes(mesh)
    if "pod" in shape:
        # ZeRO across pods: parameters/optimizer shard over the full DP
        # domain (pod x data), halving per-device model state at 2 pods
        return MeshAxes(
            dp=("pod", "data"), fsdp=("pod", "data"), model="model",
            dp_size=shape["pod"] * shape["data"],
            model_size=shape["model"],
        )
    return MeshAxes(
        dp=("data",), fsdp="data", model="model",
        dp_size=shape["data"], model_size=shape["model"],
    )


def shard_shape(global_shape, spec: PartitionSpec, mesh) -> Tuple[int, ...]:
    """The per-device shape of a leaf of ``global_shape`` under ``spec`` on
    ``mesh`` (see ``mesh_sizes``).  Raises ``ValueError`` where a dim does
    not divide by the product of its axes' sizes (JAX's
    ``NamedSharding.shard_shape``), where the spec has more entries than
    the leaf has dims, names an axis the mesh lacks, or names one twice."""
    sizes = mesh_sizes(mesh)
    shape = tuple(int(n) for n in global_shape)
    if len(spec) > len(shape):
        raise ValueError(f"{spec} has more entries than the rank of a leaf "
                         f"of shape {shape}")
    names = [n for _, n in spec.axes()]
    for n in names:
        if n not in sizes:
            raise ValueError(f"{spec} names axis {n!r}, not in the mesh's "
                             f"{tuple(sizes)}")
    if len(set(names)) != len(names):
        raise ValueError(f"{spec} names a mesh axis twice")
    out = list(shape)
    for dim in range(len(spec)):
        split = 1
        for d, n in spec.axes():
            if d == dim:
                split *= sizes[n]
        if shape[dim] % split:
            raise ValueError(
                f"{spec} splits dim {dim} of a leaf of shape {shape} "
                f"{split} ways, which does not divide {shape[dim]}")
        out[dim] = shape[dim] // split
    return tuple(out)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` where the spec splits tensor dim ``d`` over that axis,
    else ``Replicate()``.  A dim split over several axes is split major
    first in mesh order, as DTensor shards it; a tuple that names them in
    another order has no DTensor placement and raises.  An axis of size 1
    splits nothing: its placement is ``Replicate()``, the same layout,
    which spares DTensor's redistribution planner the strided shards that
    reshapes of a split dim would make."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_sizes(mesh)
    dim_names = tuple(sizes)
    of_axis = {}
    for e_dim, name in spec.axes():
        if name not in dim_names:
            raise ValueError(f"{spec} names axis {name!r}, not in the "
                             f"mesh's {dim_names}")
        if name in of_axis:
            raise ValueError(f"{spec} names a mesh axis twice")
        of_axis[name] = e_dim
    for e in spec:
        if isinstance(e, tuple):
            order = [dim_names.index(n) for n in e]
            if order != sorted(order):
                raise NotImplementedError(
                    f"{spec}: the axes {e} are not in the mesh's order "
                    f"{dim_names}")
    return tuple(Shard(of_axis[n]) if n in of_axis and sizes[n] > 1
                 else Replicate() for n in dim_names)


def map_rules(tree, rules: Dict[str, PartitionSpec]):
    """Map a path->PartitionSpec rule table over a tree.

    Paths are '/'-joined dict keys / sequence indices; the longest rule key
    that is a substring of the path wins; default replicated.
    """

    def lookup(path, leaf):
        keys = "/".join(path)
        best = None
        for k, spec in rules.items():
            if k in keys and (best is None or len(k) > len(best[0])):
                best = (k, spec)
        spec = best[1] if best else P()
        if len(spec) > len(leaf.shape):
            raise ValueError((keys, spec, tuple(leaf.shape)))
        return spec

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(t)]
        return lookup(path, t)

    return walk(tree, ())


def replicated(tree):
    """``P()`` at every leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: replicated(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [replicated(v) for v in tree]
    return P()


def pad_to(n: int, multiple: int) -> int:
    """Mesh-aligned capacity: production allocators pad tables/graph arrays
    to the shard grain so every device holds an equal slice."""
    return -(-n // multiple) * multiple


def generator_for(device=None, generator=None) -> torch.Generator:
    """``generator``, or a fresh one on ``device`` seeded 0 (the reference's
    ``PRNGKey(0)``); None on the meta device, which draws nothing."""
    dev = resolve_device(device)
    if dev.type == "meta" or generator is not None:
        return generator
    return torch.Generator(device=dev).manual_seed(0)


class ArchSpec(abc.ABC):
    name: str
    family: str

    @abc.abstractmethod
    def shapes(self) -> Dict[str, ShapeSpec]:
        ...

    @abc.abstractmethod
    def init_state(self, shape: ShapeSpec, device=None, generator=None):
        ...

    @abc.abstractmethod
    def make_inputs(self, shape: ShapeSpec, device=None,
                    generator=None) -> Dict[str, Any]:
        ...

    @abc.abstractmethod
    def make_step(self, shape: ShapeSpec,
                  axes: Optional[MeshAxes] = None) -> Callable:
        ...

    @abc.abstractmethod
    def state_shardings(self, shape: ShapeSpec, axes: MeshAxes):
        ...

    @abc.abstractmethod
    def input_shardings(self, shape: ShapeSpec, axes: MeshAxes):
        ...

    @abc.abstractmethod
    def model_flops(self, shape: ShapeSpec) -> float:
        ...

    @abc.abstractmethod
    def reduced(self) -> "ArchSpec":
        ...

    # -- shared helpers ------------------------------------------------------

    def abstract_state(self, shape: ShapeSpec):
        return self.init_state(shape, device="meta")

    def abstract_inputs(self, shape: ShapeSpec) -> Dict[str, Any]:
        return self.make_inputs(shape, device="meta")

    def cells(self):
        return [
            (self.name, s.name) for s in self.shapes().values() if not s.skip
        ]

    def skipped_cells(self):
        return [
            (self.name, s.name, s.skip)
            for s in self.shapes().values()
            if s.skip
        ]
