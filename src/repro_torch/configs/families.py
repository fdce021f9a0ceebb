"""Per-family ArchSpec implementations (``repro/configs/families.py``): the
LM family (dense GQA and MoE), the GNN family (GCN) and the recsys half
(DLRM, DIN, two-tower).

A ``train`` step is the reference's: the loss's value and gradients
(``torch.autograd``, dense), then ``adamw_update`` (``AdamWConfig()``; an
LM's from its ``moment_dtype`` / ``grad_clip``, with ``accum_steps``
microbatches), returning ``({"params", "opt"}, {"loss"})``; it updates the
state's tensors in place.  Serve, prefill, decode and retrieval steps run
under ``torch.no_grad``; an LM's decode step writes its cache in place.

The ``*_shardings`` methods give the reference's ``PartitionSpec`` trees
(``configs.base.PartitionSpec``), path for path.  ``make_step(shape,
axes)`` changes what the reference's does: the LM's activation anchors
(``TransformerConfig.act``, honoured by ``models.layers.constrain`` on
DTensors), ``_eff_accum``'s microbatch count, and two-tower's two-phase
top-k block count ``axes.all_size``.  With ``axes`` the step runs under
``implicit_replication``: the plain tensors it makes (positions, masks,
constants) count as replicated beside the DTensor state, as constants do
in a GSPMD program.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import torch

from ..core.types import resolve_device
from ..models import gnn as gnn_mod
from ..models import recsys as rec_mod
from ..models import transformer as tf_mod
from ..models.moe import MoEConfig
from ..training.optimizer import (AdamWConfig, adamw_init, adamw_update,
                                  tree_map)
from ..training.train import TrainStepConfig, make_train_step, value_and_grad
from .base import (ArchSpec, MeshAxes, P, ShapeSpec, generator_for,
                   map_rules, pad_to, replicated)


def _on_mesh(step, axes):
    """``step`` itself without a mesh; with one, ``step`` under DTensor's
    ``implicit_replication``."""
    if axes is None:
        return step

    @functools.wraps(step)
    def run(state, inputs):
        from torch.distributed.tensor.experimental import \
            implicit_replication

        with implicit_replication():
            return step(state, inputs)

    return run


def _opt_specs(params):
    return {"m": params, "v": params, "step": P()}


def _state(params, shape: ShapeSpec) -> dict:
    """``{"params": ...}``, plus for a ``train`` shape ``adamw_init``'s
    optimiser state (float32 moments, an int32 step count)."""
    if shape.kind != "train":
        return {"params": params}
    return {"params": params, "opt": adamw_init(params)}


def _train_step(loss_of):
    """The reference's ``train_step``: value-and-grad of ``loss_of(params,
    inputs)``, then AdamW with ``AdamWConfig()``."""
    opt_cfg = AdamWConfig()

    def train_step(state, inputs):
        loss, grads = value_and_grad(loss_of)(state["params"], inputs)
        params, opt = adamw_update(grads, state["opt"], state["params"],
                                   opt_cfg)
        return {"params": params, "opt": opt}, {"loss": loss}

    return train_step


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


# ===========================================================================
# LM family (dense GQA + MoE)
# ===========================================================================

LM_PARAM_RULES = {
    "embed": P("model", "fsdp"),
    "lm_head": P("fsdp", "model"),
    "final_norm": P(None),
    "layers/attn_norm": P(None, None),
    "layers/mlp_norm": P(None, None),
    "layers/w_gate": P(None, "fsdp", "model"),
    "layers/w_up": P(None, "fsdp", "model"),
    "layers/w_down": P(None, "model", "fsdp"),
    "layers/moe/router": P(None, "fsdp", "model"),
    "layers/moe/w_gate": P(None, "model", "fsdp", None),
    "layers/moe/w_up": P(None, "model", "fsdp", None),
    "layers/moe/w_down": P(None, "model", None, "fsdp"),
}


def lm_attn_rules(n_heads: int, n_kv_heads: int, tp: int):
    """Attention param sharding chosen by divisibility (see
    TransformerConfig.attn_shard):
      kv-head axis when kv % tp == 0; else q-head axis with KV projections
      sharded on head_dim (Megatron GQA: KV effectively replicated across
      the tp groups that share a KV head); else head_dim everywhere."""
    if n_kv_heads % tp == 0:
        mode = "kv"
        rules = {
            "layers/wq": P(None, "fsdp", "model", None),
            "layers/wk": P(None, "fsdp", "model", None),
            "layers/wv": P(None, "fsdp", "model", None),
            "layers/wo": P(None, "model", None, "fsdp"),
            "layers/bq": P(None, "model", None),
            "layers/bk": P(None, "model", None),
            "layers/bv": P(None, "model", None),
        }
    elif n_heads % tp == 0:
        mode = "q"
        rules = {
            "layers/wq": P(None, "fsdp", "model", None),
            "layers/wk": P(None, "fsdp", None, "model"),
            "layers/wv": P(None, "fsdp", None, "model"),
            "layers/wo": P(None, "model", None, "fsdp"),
            "layers/bq": P(None, "model", None),
            "layers/bk": P(None, None, "model"),
            "layers/bv": P(None, None, "model"),
        }
    else:
        mode = "hd"
        rules = {
            "layers/wq": P(None, "fsdp", None, "model"),
            "layers/wk": P(None, "fsdp", None, "model"),
            "layers/wv": P(None, "fsdp", None, "model"),
            "layers/wo": P(None, None, "model", "fsdp"),
            "layers/bq": P(None, None, "model"),
            "layers/bk": P(None, None, "model"),
            "layers/bv": P(None, None, "model"),
        }
    return mode, rules


def _resolve(rules: Dict[str, P], axes: MeshAxes) -> Dict[str, P]:
    def fix(spec: P) -> P:
        out = []
        for s in spec:
            if s == "fsdp":
                out.append(axes.fsdp)
            elif s == "dp":
                out.append(axes.dp)
            elif s == "all":
                out.append(axes.all)
            else:
                out.append(s)
        return P(*out)

    return {k: fix(v) for k, v in rules.items()}


_LONG_SKIP = (
    "pure full-attention arch: long_500k requires sub-quadratic "
    "attention (see DESIGN.md §Arch-applicability); bonus best-effort "
    "decode dry-run reported separately in EXPERIMENTS.md"
)


@dataclasses.dataclass(frozen=True)
class LMSpec(ArchSpec):
    name: str
    cfg: tf_mod.TransformerConfig
    train_seq: int = 4096
    train_batch: int = 256
    prefill_seq: int = 32768
    prefill_batch: int = 32
    decode_seq: int = 32768
    decode_batch: int = 128
    long_seq: int = 524288
    long_batch: int = 1
    # microbatch gradient accumulation (memory lever for the big models)
    accum_steps: int = 1
    # Megatron sequence parallelism (see transformer.py) for train/prefill
    seq_parallel: bool = False
    # fsdp axis placement for MoE expert weights: "d" (d_model, default) or
    # "ff" (expert hidden dim — avoids sharding the einsum contraction)
    moe_fsdp_dim: str = "d"
    # serving params: fsdp-sharded (ZeRO-style, default) vs model-only (TP:
    # weights resident, no per-token all-gather)
    serve_param_fsdp: bool = True
    # optimizer moment dtype ("bfloat16" for the largest models)
    moment_dtype: str = "float32"
    # None disables the global-norm clip pass
    grad_clip: Optional[float] = 1.0
    # cast fp32 master weights to bf16 before the layers run
    bf16_weight_gather: bool = False
    # all five assigned LM archs are pure full attention -> long_500k skipped
    long_skip: Optional[str] = _LONG_SKIP
    family: str = "lm"

    def _opt_cfg(self):
        return AdamWConfig(moment_dtype=self.moment_dtype,
                           grad_clip=self.grad_clip)

    def _eff_accum(self, axes) -> int:
        """dp-adaptive microbatching: a 16-wide dp axis can split the global
        batch twice as fine as the 32-wide multi-pod dp (divisibility)."""
        if self.accum_steps == 1 or axes is None:
            return self.accum_steps
        return self.accum_steps * max(1, 32 // axes.dp_size)

    def shapes(self) -> Dict[str, ShapeSpec]:
        return {
            "train_4k": ShapeSpec(
                "train_4k", "train",
                {"seq": self.train_seq, "batch": self.train_batch},
            ),
            "prefill_32k": ShapeSpec(
                "prefill_32k", "prefill",
                {"seq": self.prefill_seq, "batch": self.prefill_batch},
            ),
            "decode_32k": ShapeSpec(
                "decode_32k", "decode",
                {"seq": self.decode_seq, "batch": self.decode_batch},
            ),
            "long_500k": ShapeSpec(
                "long_500k", "decode",
                {"seq": self.long_seq, "batch": self.long_batch},
                skip=self.long_skip,
            ),
        }

    # -- state / inputs -----------------------------------------------------

    def abstract_params(self, dtype):
        return tf_mod.init_params(None, self.cfg, dtype, device="meta")

    def init_state(self, shape, device=None, generator=None):
        """train: float32 params and AdamW's state from ``_opt_cfg()``;
        prefill: bfloat16 params; decode: bfloat16 params and an empty
        ``init_cache`` of (batch, seq)."""
        gen = generator_for(device, generator)
        if shape.kind == "train":
            params = tf_mod.init_params(gen, self.cfg, torch.float32,
                                        device=device)
            return {"params": params,
                    "opt": adamw_init(params, self._opt_cfg())}
        params = tf_mod.init_params(gen, self.cfg, torch.bfloat16,
                                    device=device)
        if shape.kind == "decode":
            cache = tf_mod.init_cache(self.cfg, shape.dims["batch"],
                                      shape.dims["seq"], device=device)
            return {"params": params, "cache": cache}
        return {"params": params}

    def make_inputs(self, shape, device=None, generator=None):
        dev = resolve_device(device)
        gen = generator_for(dev, generator)
        b, s = shape.dims["batch"], shape.dims["seq"]
        v = self.cfg.vocab
        if shape.kind == "train":
            return {"tokens": _randint(gen, v, (b, s), dev),
                    "labels": _randint(gen, v, (b, s), dev)}
        if shape.kind == "prefill":
            return {"tokens": _randint(gen, v, (b, s), dev)}
        return {"tokens": _randint(gen, v, (b,), dev)}

    # -- step functions -------------------------------------------------------

    def make_step(self, shape, axes: Optional[MeshAxes] = None):
        cfg = self.cfg
        if axes is not None:
            # activation-sharding anchors (see transformer.py)
            mode, _ = lm_attn_rules(
                cfg.n_heads, cfg.n_kv_heads, axes.model_size
            )
            cfg = dataclasses.replace(
                cfg, dp_axes=tuple(axes.dp), tp_axis=axes.model,
                attn_shard=mode,
                seq_parallel=self.seq_parallel
                and shape.kind in ("train", "prefill"),
            )
        return _on_mesh(self._step(shape, cfg, axes), axes)

    def _step(self, shape, cfg, axes):
        if shape.kind == "train":
            cast_bf16 = self.bf16_weight_gather

            def loss_of(p, batch):
                if cast_bf16:
                    p = tree_map(lambda w: w.to(torch.bfloat16)
                                 if w.dtype == torch.float32 else w, p)
                return tf_mod.loss_fn(p, cfg, batch)

            step = make_train_step(loss_of, TrainStepConfig(
                optimizer=self._opt_cfg(),
                accum_steps=self._eff_accum(axes)))

            def train_step(state, inputs):
                params, opt, out = step(state["params"], state["opt"],
                                        inputs)
                return {"params": params, "opt": opt}, out

            return train_step
        if shape.kind == "prefill":

            @torch.no_grad()
            def prefill_step(state, inputs):
                logits, cache = tf_mod.prefill(state["params"], cfg,
                                               inputs["tokens"])
                return state, {"logits": logits, "cache": cache}

            return prefill_step

        @torch.no_grad()
        def decode(state, inputs):
            logits, cache = tf_mod.decode_step(
                state["params"], cfg, state["cache"], inputs["tokens"])
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
            return ({"params": state["params"], "cache": cache},
                    {"next_token": next_tok})

        return decode

    # -- shardings ------------------------------------------------------------

    def state_shardings(self, shape: ShapeSpec, axes: MeshAxes):
        _, attn_rules = lm_attn_rules(
            self.cfg.n_heads, self.cfg.n_kv_heads, axes.model_size
        )
        merged = {**LM_PARAM_RULES, **attn_rules}
        if self.moe_fsdp_dim == "ff":
            merged = {**merged,
                      "layers/moe/w_gate": P(None, "model", None, "fsdp"),
                      "layers/moe/w_up": P(None, "model", None, "fsdp"),
                      "layers/moe/w_down": P(None, "model", "fsdp", None)}
        if shape.kind != "train" and not self.serve_param_fsdp:
            merged = {
                k: P(*[None if a == "fsdp" else a for a in v])
                for k, v in merged.items()
            }
        rules = _resolve(merged, axes)
        params = map_rules(self.abstract_params(torch.float32), rules)
        if shape.kind == "train":
            return {"params": params, "opt": _opt_specs(params)}
        if shape.kind == "decode":
            b = shape.dims["batch"]
            if b >= 16:
                kv = P(None, axes.dp, axes.model, None, None)
                ln = P(axes.dp)
            else:
                kv = P(None, None, axes.dp + (axes.model,), None, None)
                ln = P(None)
            return {
                "params": params,
                "cache": {"k": kv, "v": kv, "len": ln},
            }
        return {"params": params}

    def input_shardings(self, shape: ShapeSpec, axes: MeshAxes):
        if shape.kind in ("train", "prefill"):
            tok = P(axes.dp, None)
            if shape.kind == "train":
                return {"tokens": tok, "labels": tok}
            return {"tokens": tok}
        b = shape.dims["batch"]
        return {"tokens": P(axes.dp) if b >= 16 else P(None)}

    def out_shardings(self, shape: ShapeSpec, axes: MeshAxes):
        state = self.state_shardings(shape, axes)
        if shape.kind == "train":
            return (state, {"loss": P()})
        if shape.kind == "prefill":
            # cache rides (batch->dp, seq->model): kv_heads (4/8/16) need not
            # divide the model axis, the 32k sequence always does
            cache_kv = P(None, axes.dp, axes.model, None, None)
            return (
                state,
                {
                    "logits": P(axes.dp, axes.model),
                    "cache": {"k": cache_kv, "v": cache_kv, "len": P(axes.dp)},
                },
            )
        b = shape.dims["batch"]
        return (state, {"next_token": P(axes.dp) if b >= 16 else P(None)})

    # -- roofline ------------------------------------------------------------

    def model_flops(self, shape: ShapeSpec) -> float:
        n = self.cfg.n_active_params()
        b, s = shape.dims["batch"], shape.dims["seq"]
        if shape.kind == "train":
            return 6.0 * n * b * s
        if shape.kind == "prefill":
            return 2.0 * n * b * s
        # decode: one token per sequence + KV-cache attention reads
        attn = (
            4.0 * b * s * self.cfg.n_layers * self.cfg.n_heads * self.cfg.hd
        )
        return 2.0 * n * b + attn

    def reduced(self) -> "LMSpec":
        cfg = self.cfg
        moe = (
            MoEConfig(n_experts=8, top_k=2, d_ff_expert=64)
            if cfg.moe
            else None
        )
        small = tf_mod.TransformerConfig(
            name=cfg.name + "-reduced", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
            qkv_bias=cfg.qkv_bias, norm=cfg.norm, moe=moe,
            tie_embeddings=cfg.tie_embeddings, remat=False,
        )
        return dataclasses.replace(
            self, name=self.name + "-reduced", cfg=small,
            train_seq=32, train_batch=4, prefill_seq=64, prefill_batch=2,
            decode_seq=64, decode_batch=4, long_seq=128, long_batch=1,
            accum_steps=1, seq_parallel=False,
        )


# ===========================================================================
# GNN family (GCN)
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class GNNSpec(ArchSpec):
    name: str
    n_layers: int = 2
    d_hidden: int = 16
    family: str = "gnn"
    scale: float = 1.0  # reduced() shrinks shapes

    def _dims(self, v: int) -> int:
        return max(4, int(v * self.scale))

    def _padded(self, v: int) -> int:
        """Mesh-aligned capacity for arrays sharded over the full mesh
        (production graph allocators pad to the shard grain)."""
        v = self._dims(v)
        return pad_to(v, 512) if self.scale == 1.0 else v

    def shapes(self) -> Dict[str, ShapeSpec]:
        s = self._dims
        return {
            "full_graph_sm": ShapeSpec(
                "full_graph_sm", "fullbatch",
                {"n_nodes": self._padded(2708), "n_edges": self._padded(10556),
                 "d_feat": s(1433), "n_classes": 7},
            ),
            "minibatch_lg": ShapeSpec(
                "minibatch_lg", "minibatch",
                {"n_nodes": self._padded(232965),
                 "n_edges": self._padded(114615892) if self.scale == 1.0 else s(10000),
                 "batch_nodes": s(1024), "fan1": 15 if self.scale == 1.0 else 3,
                 "fan2": 10 if self.scale == 1.0 else 2, "d_feat": s(602),
                 "n_classes": 41},
            ),
            "ogb_products": ShapeSpec(
                "ogb_products", "fullbatch",
                {"n_nodes": self._padded(2449029),
                 "n_edges": self._padded(61859140),
                 "d_feat": s(100), "n_classes": 47},
            ),
            "molecule": ShapeSpec(
                "molecule", "graphbatch",
                {"n_nodes": 30, "n_edges": 64, "batch": s(128),
                 "d_feat": s(32), "n_classes": 16},
            ),
        }

    def _cfg(self, shape: ShapeSpec) -> gnn_mod.GCNConfig:
        return gnn_mod.GCNConfig(
            name=self.name, n_layers=self.n_layers, d_hidden=self.d_hidden,
            d_feat=shape.dims["d_feat"], n_classes=shape.dims["n_classes"],
            graph_level=(shape.kind == "graphbatch"),
        )

    def init_state(self, shape, device=None, generator=None):
        params = gnn_mod.init_gcn_params(
            generator_for(device, generator), self._cfg(shape),
            device=device)
        return {"params": params, "opt": adamw_init(params)}

    def make_csr(self, shape, device=None, generator=None):
        """The minibatch shape's graph: a seeded random CSR over ``n_nodes``
        with ``n_edges`` edges (uniform sources and targets), as
        ``(row_offsets int32 (N + 1,), cols int32 (E,))``.  ``make_inputs``
        draws it first from its generator, so a generator seeded alike
        gives the graph its samples came from."""
        dev = resolve_device(device)
        gen = generator_for(dev, generator)
        n, e = shape.dims["n_nodes"], shape.dims["n_edges"]
        offsets = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
        counts = torch.bincount(_randint(gen, n, (e,), dev), minlength=n)
        offsets[1:] = torch.cumsum(counts, 0)
        return offsets, _randint(gen, n, (e,), dev)

    def make_inputs(self, shape, device=None, generator=None):
        dev = resolve_device(device)
        gen = generator_for(dev, generator)
        d = shape.dims
        if shape.kind == "fullbatch":
            n = d["n_nodes"]
            return {
                "feats": _randn(gen, (n, d["d_feat"]), dev),
                "edges": _randint(gen, n, (2, d["n_edges"]), dev),
                "labels": _randint(gen, d["n_classes"], (n,), dev),
            }
        if shape.kind == "minibatch":
            b, f1, f2 = d["batch_nodes"], d["fan1"], d["fan2"]
            if dev.type == "meta":
                seeds = _randint(gen, 1, (b,), dev)
                hop1 = _randint(gen, 1, (b * f1,), dev)
                hop2 = _randint(gen, 1, (b * f1 * f2,), dev)
            else:
                offsets, cols = self.make_csr(shape, dev, gen)
                seeds = _randint(gen, d["n_nodes"], (b,), dev)
                hop1 = gnn_mod.sample_neighbors(gen, offsets, cols, seeds,
                                                f1).reshape(-1)
                hop2 = gnn_mod.sample_neighbors(gen, offsets, cols, hop1,
                                                f2).reshape(-1)
                del offsets, cols
            return {
                "feats": _randn(gen, (d["n_nodes"], d["d_feat"]), dev),
                "seeds": seeds, "hop1": hop1, "hop2": hop2,
                "labels": _randint(gen, d["n_classes"], (b,), dev),
            }
        # graph batch: ``batch`` disjoint graphs of ``n_nodes`` nodes, each
        # with ``n_edges`` edges inside it
        g, nodes = d["batch"], d["n_nodes"]
        if dev.type == "meta":
            edges = _randint(gen, 1, (2, g * d["n_edges"]), dev)
            graph_ids = _randint(gen, 1, (g * nodes,), dev)
        else:
            base = (torch.arange(g, dtype=torch.int32, device=dev)
                    * nodes)[None, :, None]
            edges = (_randint(gen, nodes, (2, g, d["n_edges"]), dev)
                     + base).reshape(2, -1)
            graph_ids = torch.arange(g * nodes, dtype=torch.int32,
                                     device=dev) // nodes
        return {
            "feats": _randn(gen, (g * nodes, d["d_feat"]), dev),
            "edges": edges,
            "graph_ids": graph_ids,
            "labels": _randint(gen, d["n_classes"], (g,), dev),
        }

    def make_step(self, shape, axes: Optional[MeshAxes] = None):
        cfg = self._cfg(shape)
        n_graphs = shape.dims.get("batch", 0)

        def loss_of(p, inputs):
            if shape.kind == "minibatch":
                return gnn_mod.sampled_gcn_loss(p, cfg, inputs)
            batch = dict(inputs)
            if shape.kind == "graphbatch":
                batch["n_graphs"] = n_graphs
            return gnn_mod.gcn_loss(p, cfg, batch)

        return _on_mesh(_train_step(loss_of), axes)

    def state_shardings(self, shape: ShapeSpec, axes: MeshAxes):
        params = replicated(self.abstract_state(shape)["params"])
        return {"params": params, "opt": _opt_specs(params)}

    def input_shardings(self, shape: ShapeSpec, axes: MeshAxes):
        if shape.kind == "fullbatch":
            return {
                "feats": P(axes.all, None),
                "edges": P(None, axes.all),
                "labels": P(axes.all),
            }
        if shape.kind == "minibatch":
            return {
                "feats": P(axes.all, None),
                "seeds": P(axes.dp),
                "hop1": P(axes.dp),
                "hop2": P(axes.dp),
                "labels": P(axes.dp),
            }
        return {
            "feats": P(axes.dp, None),
            "edges": P(None, axes.dp),
            "graph_ids": P(axes.dp),
            "labels": P(axes.dp),
        }

    def out_shardings(self, shape: ShapeSpec, axes: MeshAxes):
        return (self.state_shardings(shape, axes), {"loss": P()})

    def model_flops(self, shape: ShapeSpec) -> float:
        cfg = self._cfg(shape)
        d = shape.dims
        if shape.kind == "minibatch":
            b, f1, f2 = d["batch_nodes"], d["fan1"], d["fan2"]
            fwd = 2.0 * (
                b * f1 * f2 * cfg.d_feat * cfg.d_hidden
                + b * f1 * cfg.d_hidden * cfg.n_classes
            )
            return 3.0 * fwd
        n = d["n_nodes"] * d.get("batch", 1)
        e = d["n_edges"] * d.get("batch", 1)
        dims = cfg.layer_dims()
        fwd = sum(2.0 * n * i * o for i, o in dims)  # transforms
        fwd += sum(2.0 * e * o for _, o in dims)     # message adds
        return 3.0 * fwd

    def reduced(self) -> "GNNSpec":
        return dataclasses.replace(
            self, name=self.name + "-reduced", scale=0.01
        )


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
        return _state(params, shape)

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

    def make_step(self, shape, axes: Optional[MeshAxes] = None):
        cfg = self.cfg
        if shape.kind == "train":
            return _on_mesh(_train_step(
                lambda p, inputs: rec_mod.dlrm_loss(p, cfg, inputs)), axes)

        @torch.no_grad()
        def serve_step(state, inputs):
            logits = rec_mod.dlrm_forward(
                state["params"], cfg, inputs["dense"], inputs["sparse"]
            )
            return state, {"scores": torch.sigmoid(logits)}

        return _on_mesh(serve_step, axes)

    def _table_specs(self, axes: MeshAxes):
        return {
            f"t{i}": P(axes.all, None) if v >= 65536 else P()
            for i, v in enumerate(self.cfg.vocab_sizes)
        }

    def state_shardings(self, shape, axes):
        params_abs = self.abstract_state(shape)["params"]
        params = {
            "tables": self._table_specs(axes),
            "bot": replicated(params_abs["bot"]),
            "top": replicated(params_abs["top"]),
        }
        if shape.kind == "train":
            return {"params": params, "opt": _opt_specs(params)}
        return {"params": params}

    def input_shardings(self, shape, axes):
        sh = {"dense": P(axes.dp, None), "sparse": P(axes.dp, None)}
        if shape.kind == "train":
            sh["labels"] = P(axes.dp)
        return sh

    def out_shardings(self, shape, axes):
        state = self.state_shardings(shape, axes)
        if shape.kind == "train":
            return (state, {"loss": P()})
        return (state, {"scores": P(axes.dp)})

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
        return _state(params, shape)

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

    def make_step(self, shape, axes: Optional[MeshAxes] = None):
        return _on_mesh(self._step(shape), axes)

    def _step(self, shape):
        cfg = self.cfg
        if shape.kind == "train":
            return _train_step(
                lambda p, inputs: rec_mod.din_loss(p, cfg, inputs))
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

    def state_shardings(self, shape, axes):
        params = replicated(self.abstract_state(shape)["params"])
        params["items"] = P(axes.all, None)
        if shape.kind == "train":
            return {"params": params, "opt": _opt_specs(params)}
        return {"params": params}

    def input_shardings(self, shape, axes):
        if shape.kind == "retrieval":
            return {
                "hist": P(None, None),
                "hist_len": P(None),
                "target": P(axes.dp),
            }
        sh = {
            "hist": P(axes.dp, None),
            "hist_len": P(axes.dp),
            "target": P(axes.dp),
        }
        if shape.kind == "train":
            sh["labels"] = P(axes.dp)
        return sh

    def out_shardings(self, shape, axes):
        state = self.state_shardings(shape, axes)
        if shape.kind == "train":
            return (state, {"loss": P()})
        return (state, {"scores": P(axes.dp)})

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
        state = _state(params, shape)
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

    def make_step(self, shape, axes: Optional[MeshAxes] = None):
        return _on_mesh(self._step(shape, axes), axes)

    def _step(self, shape, axes):
        cfg = self.cfg
        if shape.kind == "train":
            return _train_step(
                lambda p, inputs: rec_mod.two_tower_loss(p, cfg, inputs))
        if shape.kind == "retrieval":
            n_blocks = (axes.all_size if axes is not None
                        and self.two_phase_topk else 1)

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

    def state_shardings(self, shape, axes):
        params = replicated(self.abstract_state(shape)["params"])
        params["user_emb"] = P(axes.all, None)
        params["item_emb"] = P(axes.all, None)
        state = {"params": params}
        if shape.kind == "train":
            state["opt"] = _opt_specs(params)
        if shape.kind == "retrieval":
            state["cand_embs"] = P(axes.all, None)
        return state

    def input_shardings(self, shape, axes):
        if shape.kind == "retrieval":
            return {"user_ids": P(None)}
        return {"user_ids": P(axes.dp), "item_ids": P(axes.dp)}

    def out_shardings(self, shape, axes):
        state = self.state_shardings(shape, axes)
        if shape.kind == "train":
            return (state, {"loss": P()})
        if shape.kind == "retrieval":
            return (state, {"scores": P(None, None), "ids": P(None, None)})
        return (state, {"scores": P(axes.dp)})

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


__all__ = ["DINSpec", "DLRMSpec", "GNNSpec", "LMSpec", "LM_PARAM_RULES",
           "RECSYS_SHAPES", "TwoTowerSpec", "lm_attn_rules"]
