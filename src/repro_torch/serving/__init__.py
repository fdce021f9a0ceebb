"""repro_torch.serving: the serving front door (``repro/serving``).

Admission queue + deadline-driven dynamic batching (``batcher``),
double-buffered snapshot-isolated read states (``snapshot``), serving
metrics (``metrics``), and the ``ServingFront`` composing them over a
``StreamingIndex`` or ``ShardedIndex`` engine (``front``).
"""
from .batcher import Dispatch, DynamicBatcher, QueryRequest, group_vectors
from .front import ServingFront, ShardedEngine, StreamingEngine
from .metrics import ServingMetrics, percentile
from .snapshot import SnapshotStore

__all__ = [
    "Dispatch",
    "DynamicBatcher",
    "QueryRequest",
    "ServingFront",
    "ServingMetrics",
    "ShardedEngine",
    "SnapshotStore",
    "StreamingEngine",
    "group_vectors",
    "percentile",
]
