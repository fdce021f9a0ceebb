"""qwen3-moe-30b-a3b [moe] 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from .families import LMSpec
from .registry import register

SPEC = register(LMSpec(
    accum_steps=8,
    moe_fsdp_dim="ff",  # §Perf B1: halves the compute term
    name="qwen3-moe-30b-a3b",
    cfg=TransformerConfig(
        name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
        n_kv_heads=4, d_ff=768, vocab=151936, head_dim=128, qkv_bias=False,
        norm="rmsnorm", rope_theta=1e6, remat_block=8,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
    ),
))
