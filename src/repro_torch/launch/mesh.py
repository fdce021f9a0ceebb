"""Meshes (``repro/launch/mesh.py``) as ``torch.distributed`` device meshes,
and the placing of trees of tensors on them.

A ``DeviceMesh`` needs a default process group with one rank per device.
``process_group`` sets one up and tears it down again (the default group
is process-wide, so a test or a phase that makes one must leave none
behind):

  * ``process_group(256, fake=True)``: the dry run's stand-in for the
    reference's 512 placeholder host devices.  A fake group
    (``torch.testing._internal.distributed.fake_pg``) of ``world_size``
    ranks in which this process is rank 0 and every collective returns
    at once; over meta tensors nothing is allocated either.  It lives on
    the host only: its mesh's device type is the CPU.
  * ``process_group(1)``: a real one-rank group for real steps, NCCL on
    the card and gloo on the CPU, over an in-process store (no port).
  * ``process_group(n, rank=r, init_method=url)``: rank ``r`` of a real
    group of ``n`` ranks, one process each, which meet at ``url`` (a
    ``file://`` store, or any URL ``init_process_group`` takes): gloo on
    the CPU, NCCL with one card per rank (rank ``r`` on card ``r``).  A
    group of more ranks than cards raises before any rank waits for the
    others (NCCL cannot put two ranks on one card).  ``spawn`` starts the
    ``n`` local processes and their rendezvous.

``make_production_mesh`` / ``make_mesh`` build a mesh with the reference's
shapes and axis names over the group that is up.

Why DTensor placements and not the device-list layout of
``core/distributed.py``: the specs (``configs.base.PartitionSpec``) say how
every leaf of a model splits over a 2-D or 3-D mesh, and the dry run has to
see what the step then computes and sends per device.  A DTensor carries
exactly that (one placement per mesh dim), runs the step's own torch ops
with sharding propagation, and issues the collectives the layout needs,
which ``CommDebugMode`` and a dispatch mode can count under a fake group.
The device-list layout is the index's own: whole logical rows per device,
one controller, no collectives, and nothing that splits a weight's dim.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional

import torch

from ..configs.base import placements, shard_shape

PRODUCTION = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


@contextlib.contextmanager
def process_group(world_size: int = 1, *, fake: bool = False,
                  device=None, rank: int = 0,
                  init_method: Optional[str] = None):
    """The default process group for a mesh of ``world_size`` devices, torn
    down on exit.  ``fake``: a fake group (host-only, no collective moves
    data); else a real group in which this process is rank ``rank``, NCCL
    where ``device`` is a card (default) and gloo on the CPU.  One rank
    meets itself over an in-process store; more ranks meet at
    ``init_method``, each in its own process (``spawn``), on card
    ``rank`` unless ``device`` names one."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("a default process group is already up; a mesh "
                           "takes one group at a time")
    if fake:
        try:
            from torch.testing._internal.distributed.fake_pg import FakeStore
        except ImportError as e:
            raise RuntimeError("this PyTorch has no fake process group "
                               "(torch.testing._internal.distributed."
                               "fake_pg), which the dry run needs") from e
        dist.init_process_group("fake", store=FakeStore(),
                                world_size=world_size, rank=0)
    else:
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} of a group of {world_size}")
        if world_size > 1 and init_method is None:
            raise ValueError(f"a group of {world_size} ranks needs a "
                             f"rendezvous (init_method, e.g. a file:// "
                             f"store; launch.mesh.spawn makes one)")
        dev = torch.device("cuda" if device is None else device)
        _check_cards(world_size, dev)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            index = dev.index if dev.index is not None else (
                rank if world_size > 1 else None)
            if index is not None:
                torch.cuda.set_device(index)
        if init_method is None:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0)
        else:
            dist.init_process_group(backend, init_method=init_method,
                                    world_size=world_size, rank=rank)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _check_cards(world_size: int, dev) -> None:
    if dev.type == "cuda" and world_size > torch.cuda.device_count():
        raise ValueError(
            f"a group of {world_size} ranks on cards needs {world_size} "
            f"cards; this machine has {torch.cuda.device_count()} (NCCL "
            f"cannot put two ranks on one card)")


def spawn(fn, world_size: int, args=(), *, device="cpu") -> None:
    """``fn(rank, world_size, *args)`` in ``world_size`` new local
    processes, each inside ``process_group(world_size, rank=rank, ...)``:
    one real group, gloo on the CPU (``device="cpu"``) or NCCL with rank
    ``r`` on card ``r`` (``device="cuda"``), whose ranks meet over a file
    store in a new temporary directory, removed afterwards.  Returns when
    every rank has returned; a rank that raises ends the others and
    raises here.  ``fn`` must be importable by name (a module's
    function)."""
    import os
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    dev = torch.device(device)
    _check_cards(world_size, dev)
    d = tempfile.mkdtemp(prefix="mesh_rendezvous_")
    try:
        mp.spawn(_rank_main, nprocs=world_size, join=True,
                 args=(world_size, f"file://{os.path.join(d, 'store')}",
                       dev.type, fn, tuple(args)))
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _rank_main(rank, world_size, init_method, device_type, fn, args):
    dev = (torch.device("cuda", rank) if device_type == "cuda"
           else torch.device(device_type))
    with process_group(world_size, device=dev, rank=rank,
                       init_method=init_method):
        fn(rank, world_size, *args)


def make_mesh(shape, axes, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default group,
    which must have ``prod(shape)`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(shape), tuple(axes)
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"a mesh of {shape} needs a default process "
                           f"group of {n} ranks (launch.mesh."
                           f"process_group)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """Single pod: (data=16, model=16) = 256 devices.  Multi-pod: (pod=2,
    data=16, model=16) = 512; the "pod" axis is pure data parallelism."""
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes, device_type)


# ---------------------------------------------------------------------------
# trees on a mesh
# ---------------------------------------------------------------------------


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map2(fn, v, specs[i]) for i, v in enumerate(tree)]
    return fn(tree, specs)


def place(tree, specs, mesh):
    """Every leaf of ``tree`` as a DTensor on ``mesh`` with the placements of
    its spec in ``specs`` (a tree of ``PartitionSpec`` of the same
    structure).  A leaf whose dims do not divide raises, as ``jit`` does
    for its arguments (DTensor itself would split it unevenly).  On a mesh
    of one device each local tensor is the leaf itself."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(x, spec):
        shard_shape(x.shape, spec, mesh)
        pl = placements(spec, mesh)
        if mesh.size() == 1:
            return DTensor.from_local(x, mesh, pl, run_check=False)
        return distribute_tensor(x, mesh, pl)

    return _map2(one, tree, specs)


def place_abstract(tree, specs, mesh):
    """``tree``'s leaves (tensors on the meta device: shapes and dtypes
    only) as DTensors on ``mesh`` whose local tensors are meta tensors of
    the per-device shape: a step over them computes every shape and
    allocates nothing."""
    from torch.distributed.tensor import DTensor

    def one(x, spec):
        local = torch.empty(shard_shape(x.shape, spec, mesh), dtype=x.dtype,
                            device="meta")
        return DTensor.from_local(local, mesh, placements(spec, mesh),
                                  run_check=False, shape=x.shape,
                                  stride=torch.empty(x.shape,
                                                     device="meta").stride())

    return _map2(one, tree, specs)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a spec on a mesh."""
    mesh: Any
    spec: Any


def shardify(mesh, specs):
    """A tree of ``PartitionSpec`` as a tree of ``NamedSharding`` on
    ``mesh`` (the reference's ``dryrun._shardify``)."""
    return _map2(lambda spec, _: NamedSharding(mesh, spec), specs, specs)


def place_named(tree, shardings):
    """Every leaf of ``tree`` (tensors or numpy arrays) as a DTensor on its
    ``NamedSharding`` in ``shardings``, on the mesh's device type."""
    import numpy as np

    def one(x, sh):
        if isinstance(x, np.ndarray) or not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, copy=True))
        dev = torch.device(sh.mesh.device_type)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return place(x.to(dev), sh.spec, sh.mesh)

    return _map2(one, tree, shardings)


def local_bytes(tree) -> int:
    """``sum(numel * element_size)`` over the per-device tensors of a tree
    (a DTensor counts its local shard)."""
    from ..training.optimizer import tree_leaves

    return sum(x.numel() * x.element_size()
               for x in (getattr(x, "_local_tensor", x)
                         for x in tree_leaves(tree)))


__all__ = ["NamedSharding", "PRODUCTION", "local_bytes", "make_mesh",
           "make_production_mesh", "place", "place_abstract", "place_named",
           "process_group", "shardify", "spawn"]
