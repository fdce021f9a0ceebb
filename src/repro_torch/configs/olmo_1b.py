"""olmo-1b [dense] 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304
— non-parametric LN, tied embeddings [arXiv:2402.00838; hf]."""
from ..models.transformer import TransformerConfig
from .families import LMSpec
from .registry import register

SPEC = register(LMSpec(
    name="olmo-1b",
    cfg=TransformerConfig(
        name="olmo-1b", n_layers=16, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=8192, vocab=50304, head_dim=128, qkv_bias=False,
        norm="nonparam_ln", rope_theta=1e4, tie_embeddings=True,
    ),
))
