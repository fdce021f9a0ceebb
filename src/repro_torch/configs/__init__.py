from .ann import high_recall, low_recall, test_scale

__all__ = ["high_recall", "low_recall", "test_scale"]
