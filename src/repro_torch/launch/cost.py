"""Per-device cost of one step on a mesh and its three roofline terms
(``repro/launch/hlo_analysis.py`` and ``hlo_cost.py``), read from the
step's own torch ops.

The reference compiles the step with XLA and reads the partitioned HLO
text.  Here the step runs eagerly on DTensors (for the dry run over meta
local shards on a fake process group: nothing is allocated and no
collective moves data), and ``StepCost``, a dispatch mode, sees every op
a device runs on its local shard:

  * FLOPs: ``torch.utils.flop_counter``'s per-op formulas (the registry
    ``FlopCounterMode`` counts with, decomposing an op it has no formula
    for as ``FlopCounterMode`` does), applied to the local shapes, so per
    device, and kept by the class of the op's floating operands (bf16 /
    fp16, tf32, fp32, fp64, fp8), each of which has its own peak.  The
    port loops over layers in Python, so every layer's ops are seen; the
    reference's trip-count logic (XLA counts a ``scan`` body once) has no
    counterpart and is not needed.
  * Bytes: each op's tensor operands and results, once each (views and
    allocations count nothing).  Nothing is fused, so this is an upper
    bound on what a fused step would move; XLA's fusion internals, which
    the reference leaves out, have no counterpart.
  * Collectives: every functional collective (all-gather, all-reduce,
    reduce-scatter, all-to-all) by kind, with its count and payload bytes
    (the result's bytes per device, the reference's convention), and the
    link it crosses: NVLink when all ranks of its group sit on one node of
    ``GPUS_PER_NODE`` cards (ranks laid out row-major over the mesh), else
    the network between nodes.  A group of one rank moves nothing and is
    not counted.
  * Memory: the live bytes of the storages the step holds, the arguments
    first, and their peak (storages tracked by weak reference as they are
    made and freed).  XLA's ``temp_size_in_bytes`` (its buffer assignment)
    has no counterpart; ``temp_bytes`` is this peak less the arguments and
    the outputs that do not alias them.  Eager PyTorch frees what the
    step's Python drops, and autograd keeps what backward needs, so the
    peak is the eager step's own, not a fused program's.

Nothing DTensor's planning runs is counted.  Its sharding propagation
runs ops of global shapes: under a fake mode of its own (the output's
metadata) and, for an op without a strategy, through the op's
decomposition on meta tensors; its redistribution planner makes small
index tensors.  Both cache their results for the process, so a count that
took them in would depend on what ran before (gcn-cora's
``ogb_products`` on 16x16 counted 4.6x the bytes in a process's first run
as in its second); ``StepCost`` counts nothing while either works, so a
step counts the same first or again.

Which reference outputs have no torch analog: the HLO text, loop trip
counts, XLA's buffer assignment (``temp_size_in_bytes``), fusion.

The hardware model is one NVIDIA H100 SXM (data sheet, NVIDIA H100 80GB
HBM3 at its 700 W limit, dense rates): 989 TFLOP/s bf16 / fp16 and 495
tf32 on the tensor cores, 67 TFLOP/s fp32 outside them and fp64, 1,979
fp8; 3.35 TB/s HBM3; NVLink 4 at 450 GB/s a direction per card, and one
400 Gb/s NIC per card (50 GB/s) between the nodes of 8 (a DGX H100
layout).  float32 matrix products count as tf32 only where
``torch.backends.cuda.matmul.allow_tf32`` is set while they are counted
(the port leaves it off).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

HARDWARE = "NVIDIA H100 80GB HBM3, 700 W (SXM data sheet)"
# dense peak FLOP/s per card by operand class (NVIDIA H100 80GB HBM3, 700 W)
PEAKS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "fp64": 67e12,
         "fp8": 1979e12}
PEAK_FLOPS = PEAKS["bf16"]   # the tensor cores' bf16 peak, per card
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s per card, one direction (NVLink 4)
NETWORK_BW = 50e9            # bytes/s per card: one 400 Gb/s NIC
GPUS_PER_NODE = 8

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# aten ops that move no data (views are told by ``func.is_view``)
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh"}


def _tensors(tree, out=None):
    """The tensors of a tree of lists, tuples and dicts.  (No recursive
    closure: one would be a reference cycle holding every op's tensors
    until the cyclic collector ran, and the live peak would follow its
    timing.)"""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    return out


def flop_class(tensors) -> str:
    """The peak class of an op's FLOPs, from its first floating operand:
    "bf16" (bf16 / fp16), "fp8", "fp64", and for float32 "tf32" where
    ``torch.backends.cuda.matmul.allow_tf32`` is set, else "fp32"."""
    for t in tensors:
        dt = t.dtype
        if not dt.is_floating_point:
            continue
        if dt in (torch.bfloat16, torch.float16):
            return "bf16"
        if dt == torch.float64:
            return "fp64"
        if dt.itemsize == 1:
            return "fp8"
        return ("tf32" if torch.backends.cuda.matmul.allow_tf32
                else "fp32")
    return "fp32"


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _group_ranks(group_name):
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    return dist.get_process_group_ranks(_resolve_process_group(group_name))


def group_size(group_name) -> int:
    return len(_group_ranks(group_name))


def group_link(group_name) -> str:
    """"nvlink" when every rank of the group sits on one node, else
    "network"."""
    nodes = {r // GPUS_PER_NODE for r in _group_ranks(group_name)}
    return "nvlink" if len(nodes) == 1 else "network"


class StepCost(TorchDispatchMode):
    """Counts what one device runs inside it: FLOPs, bytes, collectives
    and live memory.  A DTensor op is let through (``NotImplemented``) so
    that DTensor splits it into local ops, which come back here; the ops
    DTensor's planning runs (``_silence_propagation``) are not counted,
    nor, given ``device_type``, ops on another device (DTensor's
    bookkeeping on host index tensors beside a step over meta shards).
    ``track(tree)`` first marks the arguments' storages as live."""

    def __init__(self, device_type=None):
        super().__init__()
        self.device_type = device_type
        from torch.utils.flop_counter import flop_registry

        self._registry = flop_registry
        self.flops = 0
        self.flops_by_class: Dict[str, int] = {}
        self.bytes = 0
        self.collectives: Dict[str, Dict[str, float]] = {}
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakValueDictionary()
        self._refs = set()
        self._quiet = 0
        self._depth = 0           # a decomposition re-enters the mode
        self._unpatch = []

    # -- memory --------------------------------------------------------------

    def track(self, tree):
        for t in _tensors(tree):
            self._track(_local(t))
        return self

    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if self._seen.get(key) is st:
            return
        n = st.nbytes()
        self._seen[key] = st

        def gone(ref, n=n):
            self.live -= n
            self._refs.discard(ref)

        self._refs.add(weakref.ref(st, gone))
        self.live += n
        self.peak = max(self.peak, self.live)

    # -- dispatch ------------------------------------------------------------

    def __enter__(self):
        if self._depth == 0:
            self._silence_propagation()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                for undo in reversed(self._unpatch):
                    undo()
                self._unpatch.clear()

    def _silence_propagation(self):
        """While it is entered, DTensor's planning counts nothing: the
        sharding propagator's entry points (the cached one, the uncached one
        that a cache miss and a traced op call, and ``propagate``) and the
        redistribution planner are wrapped, and the wrappers taken off
        again on exit."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor import _redistribute

        prop = DTensor._op_dispatcher.sharding_propagator
        for obj, name in ((prop, "propagate"),
                          (prop, "propagate_op_sharding"),
                          (prop, "propagate_op_sharding_non_cached"),
                          (_redistribute, "_gen_transform_infos_non_cached")):
            if not hasattr(obj, name):
                continue
            had = name in vars(obj)
            inner = getattr(obj, name)

            def quiet(*args, _inner=inner, **kwargs):
                self._quiet += 1
                try:
                    return _inner(*args, **kwargs)
                finally:
                    self._quiet -= 1

            setattr(obj, name, quiet)
            self._unpatch.append(
                (lambda o=obj, n=name, v=inner: setattr(o, n, v)) if had
                else (lambda o=obj, n=name: delattr(o, n)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self._quiet:
            return func(*args, **kwargs)        # DTensor's planning
        if self.device_type is not None and any(
                t.device.type != self.device_type
                for t in _tensors((args, kwargs))):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        if packet not in self._registry and func.namespace == "aten":
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if packet in self._registry:
            n = self._registry[packet](*args, **kwargs, out_val=out)
            cls = flop_class(_tensors((args, kwargs)))
            self.flops += n
            self.flops_by_class[cls] = self.flops_by_class.get(cls, 0) + n
        outs = _tensors(out)
        if func.namespace == "_c10d_functional" and name in _COLLECTIVES:
            group = kwargs.get("group_name", args[-1])
            if group_size(group) == 1:
                return out     # nothing crosses a link
            kind = _COLLECTIVES[name]
            e = self.collectives.setdefault(
                kind, {"count": 0, "bytes": 0, "nvlink_bytes": 0,
                       "network_bytes": 0})
            payload = sum(_nbytes(t) for t in outs)
            e["count"] += 1
            e["bytes"] += payload
            e[group_link(group) + "_bytes"] += payload
        elif (func.namespace == "aten" and not func.is_view
              and name not in _NO_BYTES):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    model_flops: float
    n_devices: int
    flops_by_class: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total else float("nan")

    @property
    def peak_flops(self) -> float:
        """The step's own peak: its FLOPs over its compute time (each class
        at its rate); the bf16 peak for a step that counts none."""
        if self.compute_s <= 0:
            return PEAK_FLOPS
        return self.flops_per_device / self.compute_s

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs throughput at the dominant bound vs the step's
        peak compute (its mix of classes)."""
        if self.bound_s <= 0:
            return float("nan")
        useful_per_dev = self.model_flops / self.n_devices
        return useful_per_dev / self.bound_s / self.peak_flops

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "flops_by_class": dict(self.flops_by_class),
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "hardware": HARDWARE,
        }


def roofline(cost: StepCost, model_flops: float,
             n_devices: int) -> RooflineTerms:
    """The three terms of a counted step on the H100 model: each class's
    FLOPs over its peak, bytes over HBM, and each collective's payload over
    the link its group crosses."""
    coll = sum(c["bytes"] for c in cost.collectives.values())
    coll_s = sum(c["nvlink_bytes"] / NVLINK_BW
                 + c["network_bytes"] / NETWORK_BW
                 for c in cost.collectives.values())
    return RooflineTerms(
        compute_s=sum(n / PEAKS[c] for c, n in cost.flops_by_class.items()),
        memory_s=cost.bytes / HBM_BW,
        collective_s=coll_s,
        flops_per_device=float(cost.flops),
        bytes_per_device=float(cost.bytes),
        collective_bytes=float(coll),
        model_flops=model_flops,
        n_devices=n_devices,
        flops_by_class={c: float(n) for c, n in cost.flops_by_class.items()},
    )


__all__ = ["GPUS_PER_NODE", "HARDWARE", "HBM_BW", "NETWORK_BW", "NVLINK_BW",
           "PEAKS", "PEAK_FLOPS", "RooflineTerms", "StepCost", "flop_class",
           "group_link",
           "roofline"]
