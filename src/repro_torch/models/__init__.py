"""Models of the seed scaffolding (``repro/models``): the recsys family
(``recsys.py``), the GCN family (``gnn.py``), the LM family
(``transformer.py``, ``moe.py``) and the layers they share
(``layers.py``)."""
from . import gnn, layers, moe, recsys, transformer  # noqa: F401
