"""Checkpoints with atomic manifests (``repro/checkpoint/manager.py``), for
trees of PyTorch tensors.

The on-disk format is the reference's, so a checkpoint written by either
package restores in the other:

  * one ``.npy`` file per leaf, addressed by the leaf's path in the tree
    and named as the reference's ``_flatten`` names it: a ``NamedTuple``
    field as ``.field``, a dict key bare (keys in sorted order), a sequence
    item by its index, parts joined by ``/`` (``.graph/.vectors``,
    ``.graph/.quant/.codes``); ``None`` holds no leaf;
  * writes go to ``step_XXXXXXXX.tmp/``, every leaf file is fsynced, the
    ``MANIFEST.json`` inside is written last and fsynced, then the
    directory entries are fsynced and the tmp dir is renamed to
    ``step_XXXXXXXX/`` with a final fsync of the parent: a checkpoint
    exists completely or not at all;
  * ``latest()`` finds the newest complete manifest, so a crash mid-write
    falls back to the previous step;
  * ``load`` checks every leaf against the manifest's shape and dtype and,
    given a ``like`` template, against the template's keys, shapes and
    dtypes, raising the typed ``CheckpointMismatchError``.

The manifest's ``"treedef"`` is a description for readers; neither
package's loader parses it.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch


class CheckpointMismatchError(ValueError):
    """A checkpoint failed validation against its manifest or the caller's
    template: torn leaf files, missing or surplus keys, or (at the
    ``core/persist.py`` layer) schema, config or capacity drift.  Typed, so
    restore paths can catch it and the checks survive ``python -O``."""


def _children(node):
    """``[(key part, child)]`` of an inner node, or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _flatten(tree) -> dict:
    """``{path: leaf}`` in the reference's key scheme and leaf order."""
    out = {}

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out["/".join(path)] = node
            return
        for part, child in kids:
            walk(child, path + [part])

    walk(tree, [])
    return out


def _unflatten(like, flat: dict):
    """A tree shaped as ``like`` whose leaves are ``flat[path]``."""

    def build(node, path):
        kids = _children(node)
        if kids is None:
            return flat["/".join(path)]
        if node is None:
            return None
        built = [build(c, path + [p]) for p, c in kids]
        if isinstance(node, dict):
            return dict(zip(sorted(node), built))
        if hasattr(node, "_fields"):
            return type(node)(*built)
        return type(node)(built)

    return build(like, [])


def _treedef(tree) -> str:
    kids = _children(tree)
    if kids is None:
        return "*"
    if tree is None:
        return "None"
    inner = ", ".join(f"{p}={_treedef(c)}" for p, c in kids)
    return f"{type(tree).__name__}({inner})"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        from torch.distributed.tensor import DTensor

        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _meta(leaf) -> Tuple[tuple, np.dtype]:
    """Shape and numpy dtype of a leaf, without reading its data (a
    template may live on the ``meta`` device)."""
    if isinstance(leaf, torch.Tensor):
        dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
        return tuple(leaf.shape), dtype
    a = np.asarray(leaf)
    return a.shape, a.dtype


def _fsync_file(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -- write ----------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             *, on_event: Optional[Callable[[str], None]] = None) -> Path:
        """Write one atomic checkpoint.  ``on_event`` is a failure-injection
        hook: called with ``"leaf:<i>"`` after each leaf file lands,
        ``"manifest"`` after the manifest is written (before the commit
        rename) and ``"rename"`` right after the rename; a hook that raises
        simulates a kill at exactly that point."""
        ev = on_event or (lambda _e: None)
        leaves = _flatten(tree)
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        index = {}
        for i, (key, leaf) in enumerate(leaves.items()):
            arr = _to_numpy(leaf)
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, arr)
            # a power loss after the (durable) rename must not surface torn
            # leaf files behind a complete-looking manifest
            _fsync_file(tmp / fname)
            ev(f"leaf:{i}")
            index[key] = {"file": fname, "shape": list(arr.shape),
                          "dtype": str(arr.dtype)}
        manifest = {"step": step, "leaves": index,
                    "treedef": _treedef(tree), "extra": extra or {}}
        mpath = tmp / "MANIFEST.json"
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)          # directory entries of the leaves + manifest
        ev("manifest")
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(self.dir)     # the rename itself
        ev("rename")
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self._complete_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- read -----------------------------------------------------------------

    def _complete_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp":
                continue
            if (p / "MANIFEST.json").exists():
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    continue
        return out

    def latest(self) -> Optional[int]:
        steps = self._complete_steps()
        return max(steps) if steps else None

    def manifest(self, step: Optional[int] = None) -> dict:
        """The manifest dict of ``step`` (default: the latest complete
        step): metadata only, no leaf reads."""
        if step is None:
            step = self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        return json.loads((d / "MANIFEST.json").read_text())

    def load(self, step: Optional[int] = None,
             like: Any = None) -> Tuple[int, Any, dict]:
        """Returns ``(step, tree of numpy arrays, extra)``.  ``like``
        supplies the structure (tensors, numpy arrays or ``meta`` tensors);
        without it a flat ``{path: array}`` dict is returned.

        Every leaf file is checked against the manifest's shape and dtype,
        and with ``like`` the key set and every leaf's shape and dtype
        against the template's."""
        if step is None:
            step = self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        flat = {}
        for key, meta in manifest["leaves"].items():
            try:
                arr = np.load(d / meta["file"])
            except Exception as e:
                raise CheckpointMismatchError(
                    f"step {step}: unreadable leaf {key!r} "
                    f"({meta['file']}): {e}"
                ) from e
            if (list(arr.shape) != list(meta["shape"])
                    or str(arr.dtype) != meta["dtype"]):
                raise CheckpointMismatchError(
                    f"step {step}: torn leaf {key!r}: file holds "
                    f"{tuple(arr.shape)}/{arr.dtype}, manifest recorded "
                    f"{tuple(meta['shape'])}/{meta['dtype']}"
                )
            flat[key] = arr
        if like is None:
            return step, flat, manifest["extra"]
        like_flat = _flatten(like)
        if set(like_flat) != set(flat):
            missing = sorted(set(like_flat) - set(flat))
            surplus = sorted(set(flat) - set(like_flat))
            raise CheckpointMismatchError(
                f"step {step}: checkpoint/template structure mismatch: "
                f"missing from checkpoint {missing}, "
                f"not in template {surplus}"
            )
        for key, tmpl in like_flat.items():
            t_shape, t_dtype = _meta(tmpl)
            if flat[key].shape != t_shape or flat[key].dtype != t_dtype:
                raise CheckpointMismatchError(
                    f"step {step}: leaf {key!r} is "
                    f"{flat[key].shape}/{flat[key].dtype} in the checkpoint "
                    f"but {t_shape}/{t_dtype} in the template"
                )
        return step, _unflatten(like, flat), manifest["extra"]


def restore_onto(tree_np: Any, shardings: Any = None, device=None):
    """Materialise a numpy tree as tensors: with ``shardings`` (a tree of
    ``launch.mesh.NamedSharding`` of the same structure, possibly on
    another mesh than the one that wrote it: elastic rescale) as DTensors
    on their placements, on the mesh's device type; else on ``device``
    (default: the card)."""
    if shardings is not None:
        from ..launch.mesh import place_named

        return place_named(tree_np, shardings)
    dev = torch.device("cuda" if device is None else device)
    flat = {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in _flatten(tree_np).items()}
    return _unflatten(tree_np, flat)
