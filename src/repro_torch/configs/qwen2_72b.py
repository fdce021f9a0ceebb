"""qwen2-72b [dense] 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — GQA, QKV bias [arXiv:2407.10671; hf]."""
from ..models.transformer import TransformerConfig
from .families import LMSpec
from .registry import register

SPEC = register(LMSpec(
    accum_steps=8,
    name="qwen2-72b",
    cfg=TransformerConfig(
        name="qwen2-72b", n_layers=80, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=29568, vocab=152064, head_dim=128, qkv_bias=True,
        norm="rmsnorm", rope_theta=1e6, remat_block=8,
    ),
))
