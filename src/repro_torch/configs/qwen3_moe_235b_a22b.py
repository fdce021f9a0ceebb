"""qwen3-moe-235b-a22b [moe] 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from .families import LMSpec
from .registry import register

SPEC = register(LMSpec(
    accum_steps=8,
    moe_fsdp_dim="ff",  # §Perf B1: halves the compute term
    moment_dtype="bfloat16",
    grad_clip=None,
    name="qwen3-moe-235b-a22b",
    cfg=TransformerConfig(
        name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096, n_heads=64,
        n_kv_heads=4, d_ff=1536, vocab=151936, head_dim=128, qkv_bias=False,
        norm="rmsnorm", rope_theta=1e6, remat_block=2,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536,
                      dispatch_chunk=65536),
    ),
))
