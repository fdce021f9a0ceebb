from .ann import high_recall, low_recall, test_scale
from .base import (ArchSpec, MeshAxes, P, PartitionSpec, ShapeSpec, axes_of,
                   map_rules, pad_to, placements, shard_shape)
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

__all__ = ["ArchSpec", "MeshAxes", "P", "PartitionSpec", "ShapeSpec",
           "all_archs", "axes_of", "get_arch", "high_recall", "low_recall",
           "map_rules", "pad_to", "placements", "register", "shard_shape",
           "test_scale"]
