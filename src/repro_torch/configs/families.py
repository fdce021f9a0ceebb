"""Per-family ArchSpec implementations (``repro/configs/families.py``): the
recsys half (DLRM, DIN, two-tower).  The LM and GNN specs wait for their
slices (ROADMAP slice 15), as does every ``train`` step: ``make_step`` on a
``train`` shape raises ``NotImplementedError``.

Serve and retrieval steps run under ``torch.no_grad``.  ``make_step``'s
``n_shards`` stands for the reference's ``axes.all_size``: the block count
of ``TwoTowerSpec``'s two-phase top-k.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..core.types import resolve_device
from ..models import recsys as rec_mod
from .base import ArchSpec, ShapeSpec, generator_for, pad_to

TRAIN_WAITS = ("the recsys train steps wait for the training slice "
               "(ROADMAP slice 15: training/{optimizer,train}.py)")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _state(params, shape: ShapeSpec, device) -> dict:
    """``{"params": ...}``, plus for a ``train`` shape the optimiser state
    of the reference's ``training/optimizer.py::adamw_init`` (float32
    moments, an int32 step count)."""
    if shape.kind != "train":
        return {"params": params}
    return {"params": params, "opt": {
        "m": _tree_map(torch.zeros_like, params),
        "v": _tree_map(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=resolve_device(device))}}


def _randint(gen, high: int, shape, device) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.int32, device=device)
    return torch.randint(0, high, shape, generator=gen, dtype=torch.int32,
                         device=device)


def _randn(gen, shape, device) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=gen, device=device)


def _labels(gen, b: int, device) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty((b,), dtype=torch.float32, device=device)
    return (torch.rand((b,), generator=gen, device=device) < 0.25).float()


def _no_train(shape: ShapeSpec) -> None:
    if shape.kind == "train":
        raise NotImplementedError(TRAIN_WAITS)


# ===========================================================================
# RecSys family
# ===========================================================================

RECSYS_SHAPES = {
    "train_batch": ("train", 65536),
    "serve_p99": ("serve", 512),
    "serve_bulk": ("serve", 262144),
    "retrieval_cand": ("retrieval", 1),
}


def _recsys_shapes(scale: float, n_cand: int) -> Dict[str, ShapeSpec]:
    out = {}
    for name, (kind, b) in RECSYS_SHAPES.items():
        dims = {"batch": max(4, int(b * scale))}
        if kind == "retrieval":
            dims["n_candidates"] = max(64, int(n_cand * scale))
        out[name] = ShapeSpec(name, kind, dims)
    return out


@dataclasses.dataclass(frozen=True)
class DLRMSpec(ArchSpec):
    name: str
    cfg: rec_mod.DLRMConfig
    family: str = "recsys"
    scale: float = 1.0

    def shapes(self):
        return _recsys_shapes(self.scale, 1_000_000)

    def _padded_cfg(self):
        """Embedding tables padded to mesh-aligned capacity (512 grain)."""
        if self.scale != 1.0:
            return self.cfg
        return dataclasses.replace(
            self.cfg,
            vocab_sizes=tuple(pad_to(v, 512) if v >= 65536 else v
                              for v in self.cfg.vocab_sizes),
        )

    def init_state(self, shape, device=None, generator=None):
        params = rec_mod.init_dlrm_params(
            generator_for(device, generator), self._padded_cfg(),
            device=device)
        return _state(params, shape, device)

    def _batch(self, shape):
        if shape.kind == "retrieval":
            return shape.dims["n_candidates"]
        return shape.dims["batch"]

    def make_inputs(self, shape, device=None, generator=None):
        dev = resolve_device(device)
        gen = generator_for(dev, generator)
        b = self._batch(shape)
        out = {
            "dense": _randn(gen, (b, self.cfg.n_dense), dev),
            "sparse": torch.stack([_randint(gen, v, (b,), dev)
                                   for v in self.cfg.vocab_sizes], dim=1),
        }
        if shape.kind == "train":
            out["labels"] = _labels(gen, b, dev)
        return out

    def make_step(self, shape, n_shards: int = 1):
        _no_train(shape)
        cfg = self.cfg

        @torch.no_grad()
        def serve_step(state, inputs):
            logits = rec_mod.dlrm_forward(
                state["params"], cfg, inputs["dense"], inputs["sparse"]
            )
            return state, {"scores": torch.sigmoid(logits)}

        return serve_step

    def model_flops(self, shape):
        b = self._batch(shape)
        cfg = self.cfg
        bot = sum(2.0 * a * c for a, c in zip(cfg.bot_mlp, cfg.bot_mlp[1:]))
        f = cfg.n_sparse + 1
        top_in = cfg.embed_dim + f * (f - 1) // 2
        dims = (top_in,) + cfg.top_mlp[1:]
        top = sum(2.0 * a * c for a, c in zip(dims, dims[1:]))
        inter = 2.0 * f * f * cfg.embed_dim
        fwd = b * (bot + top + inter)
        return 3.0 * fwd if shape.kind == "train" else fwd

    def reduced(self):
        small = dataclasses.replace(
            self.cfg,
            vocab_sizes=tuple(min(v, 1000) for v in self.cfg.vocab_sizes),
            bot_mlp=(13, 32, self.cfg.embed_dim),
            top_mlp=(32, 16, 1),
        )
        return dataclasses.replace(
            self, name=self.name + "-reduced", cfg=small, scale=0.001
        )


@dataclasses.dataclass(frozen=True)
class DINSpec(ArchSpec):
    name: str
    cfg: rec_mod.DINConfig
    family: str = "recsys"
    scale: float = 1.0

    def shapes(self):
        return _recsys_shapes(self.scale, 1_000_000)

    def _padded_cfg(self):
        if self.scale != 1.0:
            return self.cfg
        return dataclasses.replace(
            self.cfg, item_vocab=pad_to(self.cfg.item_vocab, 512)
        )

    def init_state(self, shape, device=None, generator=None):
        params = rec_mod.init_din_params(
            generator_for(device, generator), self._padded_cfg(),
            device=device)
        return _state(params, shape, device)

    def make_inputs(self, shape, device=None, generator=None):
        dev = resolve_device(device)
        gen = generator_for(dev, generator)
        s, v = self.cfg.seq_len, self.cfg.item_vocab
        if shape.kind == "retrieval":
            # one user's history scored against N candidate targets
            return {
                "hist": _randint(gen, v, (1, s), dev),
                "hist_len": _randint(gen, s + 1, (1,), dev),
                "target": _randint(gen, v, (shape.dims["n_candidates"],),
                                   dev),
            }
        b = shape.dims["batch"]
        out = {
            "hist": _randint(gen, v, (b, s), dev),
            "hist_len": _randint(gen, s + 1, (b,), dev),
            "target": _randint(gen, v, (b,), dev),
        }
        if shape.kind == "train":
            out["labels"] = _labels(gen, b, dev)
        return out

    def make_step(self, shape, n_shards: int = 1):
        _no_train(shape)
        cfg = self.cfg
        if shape.kind == "retrieval":

            @torch.no_grad()
            def retrieval_step(state, inputs):
                n = inputs["target"].shape[0]
                hist = inputs["hist"].expand(n, cfg.seq_len)
                hist_len = inputs["hist_len"].expand(n)
                logits = rec_mod.din_forward(
                    state["params"], cfg, hist, hist_len, inputs["target"]
                )
                return state, {"scores": torch.sigmoid(logits)}

            return retrieval_step

        @torch.no_grad()
        def serve_step(state, inputs):
            logits = rec_mod.din_forward(
                state["params"], cfg, inputs["hist"], inputs["hist_len"],
                inputs["target"],
            )
            return state, {"scores": torch.sigmoid(logits)}

        return serve_step

    def model_flops(self, shape):
        cfg = self.cfg
        b = (
            shape.dims["n_candidates"]
            if shape.kind == "retrieval"
            else shape.dims["batch"]
        )
        d = cfg.embed_dim
        attn_dims = (4 * d,) + cfg.attn_mlp + (1,)
        attn = sum(2.0 * a * c for a, c in zip(attn_dims, attn_dims[1:]))
        mlp_dims = (3 * d,) + cfg.mlp + (1,)
        mlp = sum(2.0 * a * c for a, c in zip(mlp_dims, mlp_dims[1:]))
        fwd = b * (cfg.seq_len * attn + mlp + 2.0 * cfg.seq_len * d)
        return 3.0 * fwd if shape.kind == "train" else fwd

    def reduced(self):
        small = dataclasses.replace(
            self.cfg, item_vocab=1000, seq_len=8
        )
        return dataclasses.replace(
            self, name=self.name + "-reduced", cfg=small, scale=0.001
        )


@dataclasses.dataclass(frozen=True)
class TwoTowerSpec(ArchSpec):
    name: str
    cfg: rec_mod.TwoTowerConfig
    family: str = "recsys"
    scale: float = 1.0
    # two-phase top-k for retrieval_cand (local per-shard k, merge)
    two_phase_topk: bool = False

    def shapes(self):
        return _recsys_shapes(self.scale, 1_000_000)

    def _padded_cfg(self):
        if self.scale != 1.0:
            return self.cfg
        return dataclasses.replace(
            self.cfg,
            user_vocab=pad_to(self.cfg.user_vocab, 512),
            item_vocab=pad_to(self.cfg.item_vocab, 512),
        )

    def init_state(self, shape, device=None, generator=None):
        """Params; for ``retrieval`` also ``cand_embs``: the item tower over
        item rows ``0, 1, ...`` (mod the vocabulary), the candidate set the
        exact scan and the graph index serve."""
        params = rec_mod.init_two_tower_params(
            generator_for(device, generator), self._padded_cfg(),
            device=device)
        state = _state(params, shape, device)
        if shape.kind == "retrieval":
            n = shape.dims["n_candidates"]
            if self.scale == 1.0:
                n = pad_to(n, 512)
            emb = params["item_emb"]
            ids = torch.arange(n, device=emb.device) % emb.shape[0]
            with torch.no_grad():
                state["cand_embs"] = rec_mod._mlp(
                    params["item_tower"], rec_mod.take_rows(emb, ids))
        return state

    def make_inputs(self, shape, device=None, generator=None):
        dev = resolve_device(device)
        gen = generator_for(dev, generator)
        if shape.kind == "retrieval":
            return {"user_ids": _randint(gen, self.cfg.user_vocab, (1,),
                                         dev)}
        b = shape.dims["batch"]
        return {
            "user_ids": _randint(gen, self.cfg.user_vocab, (b,), dev),
            "item_ids": _randint(gen, self.cfg.item_vocab, (b,), dev),
        }

    def make_step(self, shape, n_shards: int = 1):
        _no_train(shape)
        cfg = self.cfg
        if shape.kind == "retrieval":
            n_blocks = n_shards if self.two_phase_topk else 1

            @torch.no_grad()
            def retrieval_step(state, inputs):
                top, idx = rec_mod.two_tower_score_candidates(
                    state["params"], cfg, inputs["user_ids"],
                    state["cand_embs"], k=100, n_blocks=n_blocks,
                )
                return state, {"scores": top, "ids": idx}

            return retrieval_step

        @torch.no_grad()
        def serve_step(state, inputs):
            u, i = rec_mod.two_tower_embed(
                state["params"], cfg, inputs["user_ids"], inputs["item_ids"]
            )
            return state, {"scores": torch.sum(u * i, dim=-1)}

        return serve_step

    def model_flops(self, shape):
        cfg = self.cfg
        dims = (cfg.embed_dim,) + cfg.tower_mlp
        tower = sum(2.0 * a * c for a, c in zip(dims, dims[1:]))
        if shape.kind == "retrieval":
            n = shape.dims["n_candidates"]
            return tower + 2.0 * n * cfg.tower_mlp[-1]
        b = shape.dims["batch"]
        fwd = 2.0 * b * tower
        if shape.kind == "train":
            fwd += 2.0 * b * b * cfg.tower_mlp[-1]  # in-batch logits
            return 3.0 * fwd
        return fwd

    def reduced(self):
        small = dataclasses.replace(
            self.cfg, user_vocab=1000, item_vocab=1000,
            tower_mlp=(64, 32, 16),
        )
        return dataclasses.replace(
            self, name=self.name + "-reduced", cfg=small, scale=0.001
        )


__all__ = ["DINSpec", "DLRMSpec", "RECSYS_SHAPES", "TRAIN_WAITS",
           "TwoTowerSpec"]
