"""RecSys family (``repro/models/recsys.py``): DLRM (dot interaction), DIN
(target attention), two-tower retrieval, on PyTorch tensors.

A parameter tree is the reference's: dicts, and lists for an MLP's ``w``
and ``b``, each weight in the reference's ``(in, out)`` layout (``x @ w +
b``).  The ``nn.Module``s (``MLP``, ``DLRM``, ``DIN``, ``TwoTower``) hold
such a tree as parameters (sharing its storage) and run the same functions
as the reference's names (``dlrm_forward``, ``din_forward``,
``two_tower_embed``, ...), which take the tree itself.  Initialisers draw
from an explicit ``torch.Generator`` on the target device; ``device="meta"``
gives the shapes and dtypes and allocates nothing.

Three semantics follow JAX rather than PyTorch, so the two packages agree:

  * lookups are ``jnp.take`` (``take_rows``): an id in ``[-V, 0)`` wraps, any
    other id outside ``[0, V)`` gives a row of NaN (plain indexing raises);
  * ``embedding_bag`` is ``segment_sum`` over unsorted segment ids
    (``index_add_``): ids outside ``[0, n_segments)`` are dropped, empty
    bags are 0, ``mode="mean"`` divides by ``max(count, 1)``;
  * top-k is ``lax.top_k``'s: ties to the lower index (a stable sort;
    ``torch.topk`` promises no tie order).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..core.types import resolve_device
from ..kernels.ref import stable_topk_smallest
from .layers import add_on_shards, is_dtensor, take_on_shards

# Criteo-Kaggle per-field cardinalities (DLRM RM2 regime, public counts).
CRITEO_KAGGLE_VOCABS = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
)
# Criteo-1TB (MLPerf DLRM benchmark) per-field cardinalities.
CRITEO_TB_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295,
    39664984, 585935, 12972, 108, 36,
)


# ---------------------------------------------------------------------------
# lookups, EmbeddingBag, MLPs, loss
# ---------------------------------------------------------------------------


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: rows ``ids.shape + (d,)``; an id in
    ``[-V, 0)`` wraps to ``V + id``, any other out-of-range id gives NaN.
    On DTensors it runs on each device's local tensors
    (``layers.take_on_shards``)."""
    return take_on_shards(table, ids, _jnp_rows)


def _jnp_rows(ids, v: int):
    ids = ids.long()
    ids = torch.where(ids < 0, ids + v, ids)
    return ids.clamp(0, v - 1), (ids < 0) | (ids >= v)


def _segment_sum(x, segment_ids, n_segments: int):
    """``jax.ops.segment_sum``: rows with a segment id outside ``[0,
    n_segments)`` are dropped (routed to a spare row, then cut off).  On
    DTensors it runs on each device's local rows, a partial sum where the
    rows are split (``layers.add_on_shards``)."""
    return add_on_shards(
        lambda xl, sl: _segment_sum_local(xl, sl, n_segments), x,
        segment_ids)


def _segment_sum_local(x, segment_ids, n_segments: int):
    seg = segment_ids.long()
    seg = torch.where((seg >= 0) & (seg < n_segments), seg,
                      torch.full_like(seg, n_segments))
    # in place: it spares a second (n_segments + 1, d) buffer, 4 (N + 1) d
    # bytes (0.46 GB at ogb_products' 2,449,408 nodes and its last layer's
    # d = 47)
    out = x.new_zeros((n_segments + 1,) + tuple(x.shape[1:]))
    return out.index_add_(0, seg, x)[:n_segments]


def embedding_bag(table, flat_ids, segment_ids, n_segments: int,
                  mode: str = "sum", weights=None):
    """torch.nn.EmbeddingBag semantics with unsorted segment ids (not
    offsets): table (V, d); flat_ids (L,) int; ``segment_ids`` (L,) maps
    each id to its bag.  Returns (n_segments, d)."""
    rows = take_rows(table, flat_ids)
    if weights is not None:
        rows = rows * weights[:, None]
    out = _segment_sum(rows, segment_ids, n_segments)
    if mode == "mean":
        cnt = _segment_sum(torch.ones_like(segment_ids,
                                           dtype=torch.float32),
                           segment_ids, n_segments)
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def _normal(generator, shape, dtype, device, scale):
    dev = resolve_device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=dev).mul_(scale)


def _mlp_params(generator, dims, dtype=torch.float32, device=None):
    ws, bs = [], []
    for a, b in zip(dims[:-1], dims[1:]):
        ws.append(_normal(generator, (a, b), dtype, device, 1.0 / a ** 0.5))
        bs.append(torch.zeros((b,), dtype=dtype,
                              device=resolve_device(device)))
    return {"w": ws, "b": bs}


def _mlp(p, x, final_act=None):
    """``x @ w + b`` per layer, ReLU between layers; the bias add and the
    ReLU run in place on the product (the same values; it spares a
    (B, width) copy a layer, 0.5 GiB at ``serve_bulk``'s B = 262,144 and
    DLRM's 512-wide top MLP), but on a DTensor product, whose placement
    may be a pending sum that only an out-of-place op may resolve."""
    n = len(p["w"])
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        x = torch.matmul(x, w)
        inplace = not is_dtensor(x)
        x = x.add_(b) if inplace else x + b
        if i < n - 1:
            x = torch.relu_(x) if inplace else torch.relu(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def bce_loss(logits, labels):
    """The reference's stable form: mean(max(z, 0) - z y + log1p(e^-|z|)),
    with ``jnp.maximum``'s and ``jnp.abs``'s gradients at z = 0 (0.5 and
    1; ``clamp`` and ``abs`` give 1 and 0)."""
    z = logits.to(torch.float32)
    return torch.mean(torch.maximum(z, torch.zeros_like(z)) - z * labels
                      + torch.log1p(torch.exp(-torch.where(z >= 0, z, -z))))


def _top_k(x, k: int):
    """``lax.top_k`` along the last axis: the k largest, ties to the lower
    index; ids int32."""
    if k > x.shape[-1]:
        raise ValueError(f"top-k of {k} over an axis of {x.shape[-1]}")
    vals, idx = stable_topk_smallest(-x, k)
    return -vals, idx.to(torch.int32)


# ---------------------------------------------------------------------------
# modules over a parameter tree
# ---------------------------------------------------------------------------


def _param(t):
    return nn.Parameter(t, requires_grad=False)


class MLP(nn.Module):
    """An MLP's ``{"w": [...], "b": [...]}`` as parameters ``w.i`` /
    ``b.i`` (no copy)."""

    def __init__(self, p):
        super().__init__()
        self.w = nn.ParameterList([_param(t) for t in p["w"]])
        self.b = nn.ParameterList([_param(t) for t in p["b"]])

    def tree(self):
        return {"w": list(self.w), "b": list(self.b)}

    def forward(self, x, final_act=None):
        return _mlp(self.tree(), x, final_act)


class _Tree(nn.Module):
    """A model over the reference's parameter tree: table leaves become
    parameters, MLP subtrees ``MLP`` modules, ``tree()`` gives the tree
    back (the parameters themselves)."""

    def __init__(self, cfg, params):
        super().__init__()
        self.cfg = cfg
        self._keys = tuple(params)
        for key, v in params.items():
            if isinstance(v, dict) and set(v) == {"w", "b"}:
                setattr(self, key, MLP(v))
            elif isinstance(v, dict):
                setattr(self, key, nn.ParameterDict(
                    {k: _param(t) for k, t in v.items()}))
            else:
                setattr(self, key, _param(v))

    def tree(self):
        out = {}
        for key in self._keys:
            m = getattr(self, key)
            out[key] = (m.tree() if isinstance(m, MLP) else
                        dict(m.items()) if isinstance(m, nn.ParameterDict)
                        else m)
        return out


# ---------------------------------------------------------------------------
# DLRM
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_dense: int = 13
    embed_dim: int = 64
    bot_mlp: Tuple[int, ...] = (13, 512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)
    vocab_sizes: Tuple[int, ...] = CRITEO_KAGGLE_VOCABS
    interaction: str = "dot"

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    def n_params(self) -> int:
        emb = sum(self.vocab_sizes) * self.embed_dim
        bot = sum(a * b + b for a, b in zip(self.bot_mlp, self.bot_mlp[1:]))
        f = self.n_sparse + 1
        top_in = self.embed_dim + f * (f - 1) // 2
        dims = (top_in,) + self.top_mlp[1:]
        top = sum(a * b + b for a, b in zip(dims, dims[1:]))
        return emb + bot + top


def init_dlrm_params(generator, cfg: DLRMConfig, dtype=torch.float32,
                     device=None):
    f = cfg.n_sparse + 1
    top_in = cfg.embed_dim + f * (f - 1) // 2
    return {
        "tables": {
            f"t{i}": _normal(generator, (v, cfg.embed_dim), dtype, device,
                             1.0 / cfg.embed_dim ** 0.5)
            for i, v in enumerate(cfg.vocab_sizes)
        },
        "bot": _mlp_params(generator, cfg.bot_mlp, dtype, device),
        "top": _mlp_params(generator, (top_in,) + cfg.top_mlp[1:], dtype,
                           device),
    }


def dlrm_forward(params, cfg: DLRMConfig, dense, sparse):
    """dense (B, 13) f32; sparse (B, 26) int -> logits (B,)."""
    bot = _mlp(params["bot"], dense)                         # (B, d)
    embs = [take_rows(params["tables"][f"t{i}"], sparse[:, i])
            for i in range(cfg.n_sparse)]
    z = torch.stack([bot] + embs, dim=1)                      # (B, F, d)
    zz = torch.bmm(z, z.transpose(1, 2))                      # (B, F, F)
    b, f = z.shape[:2]
    iu, ju = torch.triu_indices(f, f, offset=1, device=z.device)
    # zz[:, iu, ju] as a gather over the flattened pairs: the same values,
    # and a gradient (a scatter-add) that DTensor propagates on PyTorch
    # 2.11 too (the indexing's, index_put with a None index, it cannot)
    inter = torch.gather(zz.reshape(b, f * f), 1,
                         (iu * f + ju).expand(b, -1))         # (B, F(F-1)/2)
    top_in = torch.cat([bot, inter], dim=1)
    return _mlp(params["top"], top_in)[:, 0]


def dlrm_loss(params, cfg: DLRMConfig, batch):
    logits = dlrm_forward(params, cfg, batch["dense"], batch["sparse"])
    return bce_loss(logits, batch["labels"])


class DLRM(_Tree):
    """``dlrm_forward`` over parameters ``tables.t<i>``, ``bot``, ``top``."""

    def forward(self, dense, sparse):
        return dlrm_forward(self.tree(), self.cfg, dense, sparse)


# ---------------------------------------------------------------------------
# DIN — target attention over the user behaviour sequence
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: Tuple[int, ...] = (80, 40)
    mlp: Tuple[int, ...] = (200, 80)
    item_vocab: int = 1_000_000

    def n_params(self) -> int:
        d = self.embed_dim
        attn_dims = (4 * d,) + self.attn_mlp + (1,)
        attn = sum(a * b + b for a, b in zip(attn_dims, attn_dims[1:]))
        mlp_dims = (3 * d,) + self.mlp + (1,)
        mlp = sum(a * b + b for a, b in zip(mlp_dims, mlp_dims[1:]))
        return self.item_vocab * d + attn + mlp


def init_din_params(generator, cfg: DINConfig, dtype=torch.float32,
                    device=None):
    d = cfg.embed_dim
    return {
        "items": _normal(generator, (cfg.item_vocab, d), dtype, device, 0.01),
        "attn": _mlp_params(generator, (4 * d,) + cfg.attn_mlp + (1,), dtype,
                            device),
        "mlp": _mlp_params(generator, (3 * d,) + cfg.mlp + (1,), dtype,
                           device),
    }


def din_forward(params, cfg: DINConfig, hist, hist_len, target):
    """hist (B, S) int, hist_len (B,), target (B,) -> logits (B,)."""
    h = take_rows(params["items"], hist)                      # (B, S, d)
    t = take_rows(params["items"], target)                    # (B, d)
    tb = t[:, None].expand(h.shape)
    attn_in = torch.cat([h, tb, h - tb, h * tb], dim=-1)
    scores = _mlp(params["attn"], attn_in)[..., 0]            # (B, S)
    del attn_in
    # empty histories attend to position 0 only (avoids an all -inf softmax)
    safe_len = torch.clamp(hist_len, min=1)
    mask = (torch.arange(cfg.seq_len, device=h.device)[None]
            < safe_len[:, None])
    scores = torch.where(mask, scores, torch.full((), float("-inf"),
                                                  device=h.device))
    w = torch.softmax(scores, dim=-1)
    user = torch.einsum("bs,bsd->bd", w, h)
    x = torch.cat([user, t, user * t], dim=-1)
    return _mlp(params["mlp"], x)[:, 0]


def din_loss(params, cfg: DINConfig, batch):
    logits = din_forward(params, cfg, batch["hist"], batch["hist_len"],
                         batch["target"])
    return bce_loss(logits, batch["labels"])


class DIN(_Tree):
    """``din_forward`` over parameters ``items``, ``attn``, ``mlp``."""

    def forward(self, hist, hist_len, target):
        return din_forward(self.tree(), self.cfg, hist, hist_len, target)


# ---------------------------------------------------------------------------
# Two-tower retrieval (in-batch sampled softmax)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str
    embed_dim: int = 256
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    user_vocab: int = 1_000_000
    item_vocab: int = 1_000_000

    def n_params(self) -> int:
        d = self.embed_dim
        dims = (d,) + self.tower_mlp
        tower = sum(a * b + b for a, b in zip(dims, dims[1:]))
        return (self.user_vocab + self.item_vocab) * d + 2 * tower


def init_two_tower_params(generator, cfg: TwoTowerConfig,
                          dtype=torch.float32, device=None):
    d = cfg.embed_dim
    return {
        "user_emb": _normal(generator, (cfg.user_vocab, d), dtype, device,
                            0.01),
        "item_emb": _normal(generator, (cfg.item_vocab, d), dtype, device,
                            0.01),
        "user_tower": _mlp_params(generator, (d,) + cfg.tower_mlp, dtype,
                                  device),
        "item_tower": _mlp_params(generator, (d,) + cfg.tower_mlp, dtype,
                                  device),
    }


def two_tower_embed(params, cfg: TwoTowerConfig, user_ids, item_ids):
    u = _mlp(params["user_tower"], take_rows(params["user_emb"], user_ids))
    i = _mlp(params["item_tower"], take_rows(params["item_emb"], item_ids))
    return u, i


# in-batch logits per block of rows (2^28 floats, 1 GiB): at the train
# batch of 65,536 the whole (B, B) matrix is 17.2 GB, and its backward
# would hold several
LOGIT_BLOCK = 1 << 28


def _row_nll(u_rows, i, row0: int):
    logits = (u_rows @ i.T).to(torch.float32)                 # (b, B)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.diagonal(logits, offset=row0)
    return lse - ll


def _nll_rows(u, i, row0: int):
    """The in-batch NLL of each row of ``u`` against every row of ``i``,
    row r's own item at row ``row0 + r`` of ``i``: rows go in blocks of at
    most ``LOGIT_BLOCK`` logits; under autograd each block is recomputed in
    the backward (``torch.utils.checkpoint``), so one block's logits are
    held at a time.  Each row's arithmetic is the unblocked one's."""
    b = u.shape[0]
    rows = max(1, LOGIT_BLOCK // i.shape[0])
    if not torch.is_grad_enabled() or rows >= b:
        return torch.cat([_row_nll(u[r:r + rows], i, row0 + r)
                          for r in range(0, b, rows)])
    from torch.utils.checkpoint import checkpoint

    return torch.cat([
        checkpoint(_row_nll, u[r:r + rows], i, row0 + r, use_reentrant=False)
        for r in range(0, b, rows)])


def _nll_on_shards(u, i):
    """``_nll_rows`` of DTensors, on each device's local rows: ``u`` keeps
    its split of the batch, ``i`` is whole on every device (B x d, 64 MiB
    at the train batch), and each device's rows run against it at their
    global offset (the diagonal of a split logits block, whose gradient
    PyTorch 2.11's DTensor cannot propagate, and the row blocks, which
    would gather ``u``, stay on the device)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from .layers import _from_local, _placed

    mesh = (u if is_dtensor(u) else i).device_mesh
    u, i = _placed(u, mesh), _placed(i, mesh)
    u_pl = [p if p == Shard(0) else Replicate() for p in u.placements]
    i_grad = [Partial() if p == Shard(0) else Replicate() for p in u_pl]
    row0 = compute_local_shape_and_global_offset(u.shape, mesh, u_pl)[1][0]
    nll = _nll_rows(
        u.redistribute(mesh, u_pl).to_local(grad_placements=u_pl),
        i.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
            grad_placements=i_grad), row0)
    return _from_local(nll, mesh, u_pl, (u.shape[0],))


def two_tower_loss(params, cfg: TwoTowerConfig, batch):
    """In-batch sampled softmax with logQ-style uniform correction:
    mean over rows of logsumexp(u_r . i) - u_r . i_r (``_nll_rows``; on
    DTensors ``_nll_on_shards``)."""
    u, i = two_tower_embed(params, cfg, batch["user_ids"], batch["item_ids"])
    if is_dtensor(u) or is_dtensor(i):
        return torch.mean(_nll_on_shards(u, i))
    return torch.mean(_nll_rows(u, i, 0))


def two_tower_score_candidates(params, cfg: TwoTowerConfig, user_ids,
                               cand_embs, k: int = 100, n_blocks: int = 1):
    """One (or few) queries against a precomputed candidate embedding
    matrix (N_cand, d): batched dot + top-k.  ``n_blocks > 1`` (and N
    divisible by it): two-phase top-k, per-block (per-shard) local top-k,
    then a merge over the k * n_blocks survivors in (block, k) order.
    Returns (scores (B, k), ids int32 (B, k))."""
    u = _mlp(params["user_tower"], take_rows(params["user_emb"], user_ids))
    scores = u @ cand_embs.T                                  # (B, N_cand)
    b, n = scores.shape
    if n_blocks > 1 and n % n_blocks == 0:
        blk = scores.reshape(b, n_blocks, n // n_blocks)
        l_top, l_idx = _top_k(blk, k)                         # (B, nb, k)
        base = (torch.arange(n_blocks, dtype=torch.int32,
                             device=scores.device) * (n // n_blocks))
        g_idx = l_idx + base[None, :, None]
        top, sel = _top_k(l_top.reshape(b, -1), k)
        return top, torch.gather(g_idx.reshape(b, -1), 1, sel.long())
    return _top_k(scores, k)


class TwoTower(_Tree):
    """``two_tower_embed`` over parameters ``user_emb``, ``item_emb``,
    ``user_tower``, ``item_tower``."""

    def forward(self, user_ids, item_ids):
        return two_tower_embed(self.tree(), self.cfg, user_ids, item_ids)

    def item_embeddings(self, item_ids=None):
        """The item tower over ``item_ids`` (default: the whole table): the
        candidate embeddings the index and the exact scan serve."""
        p = self.tree()
        rows = (p["item_emb"] if item_ids is None
                else take_rows(p["item_emb"], item_ids))
        return _mlp(p["item_tower"], rows)

    def score_candidates(self, user_ids, cand_embs, k: int = 100,
                         n_blocks: int = 1):
        return two_tower_score_candidates(self.tree(), self.cfg, user_ids,
                                          cand_embs, k=k, n_blocks=n_blocks)


__all__ = [
    "CRITEO_KAGGLE_VOCABS", "CRITEO_TB_VOCABS", "DIN", "DINConfig", "DLRM",
    "DLRMConfig", "MLP", "TwoTower", "TwoTowerConfig", "bce_loss",
    "din_forward", "din_loss", "dlrm_forward", "dlrm_loss", "embedding_bag",
    "init_din_params", "init_dlrm_params", "init_two_tower_params",
    "take_rows", "two_tower_embed", "two_tower_loss",
    "two_tower_score_candidates",
]
