"""qwen2.5-32b [dense] 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064 — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf]."""
from ..models.transformer import TransformerConfig
from .families import LMSpec
from .registry import register

SPEC = register(LMSpec(
    accum_steps=8,
    name="qwen2.5-32b",
    cfg=TransformerConfig(
        name="qwen2.5-32b", n_layers=64, d_model=5120, n_heads=40,
        n_kv_heads=8, d_ff=27648, vocab=152064, head_dim=128, qkv_bias=True,
        norm="rmsnorm", rope_theta=1e6, remat_block=8,
    ),
))
