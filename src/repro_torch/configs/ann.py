"""The paper's own index configurations (§4 Parameters).

``backend``: ``"auto"`` (default) picks the hand-written CUDA kernels for
a state on the card and the plain PyTorch engine for one on the CPU;
``"torch"`` / ``"ref"`` / ``"cuda"`` force an engine.
"""
from __future__ import annotations

from ..core.types import ANNConfig


def high_recall(dim: int, n_cap: int, metric: str = "l2",
                backend: str = "auto") -> ANNConfig:
    """R=64, l_b = l_s = 128, alpha = 1.2 (paper's high-recall regime)."""
    return ANNConfig(
        dim=dim, n_cap=n_cap, r=64, l_build=128, l_search=128, l_delete=128,
        k_delete=50, n_copies=3, alpha=1.2, metric=metric,
        consolidation_threshold=0.2, backend=backend,
    )


def low_recall(dim: int, n_cap: int, metric: str = "l2",
               backend: str = "auto") -> ANNConfig:
    """R=32, l_b = l_s = 64 (paper's resource-constrained regime)."""
    return ANNConfig(
        dim=dim, n_cap=n_cap, r=32, l_build=64, l_search=64, l_delete=64,
        k_delete=50, n_copies=3, alpha=1.2, metric=metric,
        consolidation_threshold=0.2, backend=backend,
    )


def test_scale(dim: int, n_cap: int, metric: str = "l2",
               backend: str = "auto") -> ANNConfig:
    """Shrunk parameters for small-scale tests (same ratios)."""
    return ANNConfig(
        dim=dim, n_cap=n_cap, r=16, l_build=32, l_search=32, l_delete=32,
        k_delete=16, n_copies=3, alpha=1.2, metric=metric,
        consolidation_threshold=0.2, backend=backend,
    )
