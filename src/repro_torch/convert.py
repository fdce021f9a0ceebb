"""Carry an index state across packages as numpy arrays.

The layout is the reference's: ``{"graph": {field: array}, "ext2slot": ...,
"slot2ext": ..., "n_inserts": ..., ...}`` with the graph fields of
``GraphState`` in order; ``quant`` is None or the int8 tier's ``{codes,
scale, qnorms}`` arrays (a dict, or the reference's ``QuantStore`` of numpy
arrays).  A reference state becomes this dict with
``repro.core.types.as_numpy_state`` on its ``graph`` plus ``np.asarray`` on
the other leaves; ``index_state_from_numpy`` turns it into the port's
tensors and ``index_state_to_numpy`` back.  Packed bitmaps are
uint32 in the reference and int32 with the same bits here
(``words_from_numpy`` / ``words_to_numpy``).

An HNSW hierarchy (``core/hnsw.py::HNSWState``) travels as ``{field:
array}`` over its fields in order: ``hnsw_state_from_numpy`` /
``hnsw_state_to_numpy`` (a reference ``HNSWState`` becomes that dict with
``np.asarray`` on each field).

A recsys parameter tree (``models/recsys.py``: dicts, and lists for an
MLP's ``w`` and ``b``) travels leaf for leaf in the reference's layout,
weights ``(in, out)`` as they are (the port uses no ``nn.Linear``, so
nothing is transposed): ``params_from_numpy`` / ``params_to_numpy``, and
``module_from_numpy`` loads a tree into ``DLRM`` / ``DIN`` / ``TwoTower``.
A reference tree of JAX arrays goes in as it is (each leaf through
``np.asarray``).  The same functions carry the GCN's parameters (a list of
``{"w", "b"}`` layers) and a train state ``{"params", "opt": {"m", "v",
"step"}}``, AdamW's moments and its int32 step count included, so the
reference's exact state can be fed to the port's train step and back.
bfloat16 moments come in from the reference's ``bfloat16`` arrays and go
out widened to float32, which holds them exactly (numpy has no bfloat16;
the reference's update reads its moments in float32 either way).
An LM's tree (``models/transformer.py::init_params``) travels the same
way: its ``layers`` leaves stay stacked on their leading (L, ...) axis,
an MoE's expert weights under ``layers/moe``, and an OLMo-style arch's
zero-size ``final_norm`` as an empty tensor; bfloat16 serving params and
caches come in as bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.quant import QuantStore
from .core.types import GraphState, IndexState, resolve_device

_INDEX_LEAVES = ("ext2slot", "slot2ext", "n_inserts", "n_deletes",
                 "insert_comps", "delete_comps")
_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.int8): torch.int8,
           np.dtype(np.bool_): torch.bool}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return words_from_numpy(a, device)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            dtype=torch.bfloat16, device=device)
    return torch.from_numpy(np.array(a, copy=True)).to(
        dtype=_DTYPES[a.dtype], device=device)


def graph_state_from_numpy(g: dict, device=None) -> GraphState:
    dev = resolve_device(device)
    q = g.get("quant")
    if q is not None:
        q = q if isinstance(q, dict) else q._asdict()
        q = QuantStore(*(_tensor(q[f], dev) for f in QuantStore._fields))
    return GraphState(*(_tensor(g[f], dev) for f in GraphState._fields
                        if f != "quant"), quant=q)


def index_state_from_numpy(d: dict, device=None) -> IndexState:
    """The port's ``IndexState`` from the numpy layout above, on ``device``
    (default: the card)."""
    dev = resolve_device(device)
    return IndexState(graph=graph_state_from_numpy(d["graph"], dev),
                      **{f: _tensor(d[f], dev) for f in _INDEX_LEAVES})


def graph_state_to_numpy(g: GraphState) -> dict:
    out = {f: v.cpu().numpy() for f, v in g._asdict().items()
           if f != "quant"}
    out["quant"] = None if g.quant is None else {
        f: v.cpu().numpy() for f, v in g.quant._asdict().items()}
    return out


def index_state_to_numpy(state: IndexState) -> dict:
    out = {"graph": graph_state_to_numpy(state.graph)}
    out.update({f: getattr(state, f).cpu().numpy() for f in _INDEX_LEAVES})
    return out


def hnsw_state_from_numpy(d: dict, device=None):
    """The port's ``HNSWState`` from ``{field: array}``, on ``device``
    (default: the card)."""
    from .core.hnsw import HNSWState

    dev = resolve_device(device)
    return HNSWState(*(_tensor(d[f], dev) for f in HNSWState._fields))


def hnsw_state_to_numpy(st) -> dict:
    return {f: v.cpu().numpy() for f, v in st._asdict().items()}


def params_from_numpy(tree, device=None):
    """A parameter tree of numpy (or JAX) arrays -> the same tree of
    tensors on ``device`` (default: the card)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, dev) for v in tree]
    return _tensor(tree, dev)


def params_to_numpy(tree):
    """A parameter tree of tensors -> the same tree of numpy arrays
    (bfloat16 leaves widened to float32)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    t = tree.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def module_from_numpy(cls, cfg, tree, device=None):
    """``cls(cfg, params)`` (``models/recsys.py``'s ``DLRM``, ``DIN`` or
    ``TwoTower``) over ``params_from_numpy(tree, device)``."""
    return cls(cfg, params_from_numpy(tree, device))


def words_from_numpy(words, device=None) -> torch.Tensor:
    """uint32 packed words -> the int32 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(words, np.uint32)).view(np.int32)
    return torch.from_numpy(a.copy()).to(resolve_device(device))


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 packed words -> uint32 numpy with the same bits."""
    return words.cpu().numpy().astype(np.int32).view(np.uint32)
