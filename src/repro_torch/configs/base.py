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
  * ``model_flops`` — useful-work FLOPs (the 6·N·D / 2·N·D conventions);
  * ``reduced`` — a tiny same-family spec for CPU tests.

The reference's ``MeshAxes``, ``axes_of``, ``map_rules`` and the
``*_shardings`` methods are ``PartitionSpec`` machinery for its dry run;
they wait for the ``launch/mesh`` slice (ROADMAP Queue 1, item 4).
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from ..core.types import resolve_device


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                      # train | prefill | decode | serve | ...
    dims: Mapping[str, int]
    skip: Optional[str] = None     # reason string when the cell is skipped


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
    def make_step(self, shape: ShapeSpec, n_shards: int = 1) -> Callable:
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
