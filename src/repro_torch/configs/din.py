"""din [recsys] embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
interaction=target-attn [arXiv:1706.06978; paper]."""
from ..models.recsys import DINConfig
from .families import DINSpec
from .registry import register

SPEC = register(DINSpec(
    name="din",
    cfg=DINConfig(
        name="din", embed_dim=18, seq_len=100, attn_mlp=(80, 40),
        mlp=(200, 80), item_vocab=1_000_000,
    ),
))
