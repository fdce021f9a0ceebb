from .pipeline import ClickStream, TokenStream, VectorStream

__all__ = ["ClickStream", "TokenStream", "VectorStream"]
