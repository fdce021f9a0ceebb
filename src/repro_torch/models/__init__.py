"""Models of the seed scaffolding (``repro/models``).  Ported: the recsys
family (``recsys.py``), the GCN family (``gnn.py``) and the loss it trains
with (``layers.py``); the LM family waits (ROADMAP Queue 1, item 2)."""
from . import gnn, layers, recsys  # noqa: F401
