from .pipeline import VectorStream

__all__ = ["VectorStream"]
