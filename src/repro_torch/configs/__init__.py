from .ann import high_recall, low_recall, test_scale
from .base import ArchSpec, ShapeSpec, pad_to
from .registry import all_archs, get_arch, register

# importing an arch module registers its SPEC; the LM archs wait for
# their slice (ROADMAP Queue 1, item 2)
from . import (  # noqa: F401
    din,
    dlrm_mlperf,
    dlrm_rm2,
    gcn_cora,
    two_tower_retrieval,
)

__all__ = ["ArchSpec", "ShapeSpec", "all_archs", "get_arch", "high_recall",
           "low_recall", "pad_to", "register", "test_scale"]
