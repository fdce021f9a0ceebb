from .ann import high_recall, low_recall, test_scale
from .base import ArchSpec, ShapeSpec, pad_to
from .registry import all_archs, get_arch, register

# importing an arch module registers its SPEC
from . import (  # noqa: F401
    din,
    dlrm_mlperf,
    dlrm_rm2,
    gcn_cora,
    olmo_1b,
    qwen2_5_32b,
    qwen2_72b,
    qwen3_moe_235b_a22b,
    qwen3_moe_30b_a3b,
    two_tower_retrieval,
)

__all__ = ["ArchSpec", "ShapeSpec", "all_archs", "get_arch", "high_recall",
           "low_recall", "pad_to", "register", "test_scale"]
