"""Models of the seed scaffolding (``repro/models``).  Ported: the recsys
family (``recsys.py``); the LM and GNN families wait (ROADMAP slice 15)."""
from . import recsys  # noqa: F401
