"""repro_torch: the IP-DiskANN streaming index on PyTorch and CUDA.

The PyTorch/CUDA port of the JAX package ``repro``, which it is held
against.  It imports ``torch`` (and numpy), never JAX.  Entry points
allocate on the card unless the caller names another device; ``"auto"``
backends resolve by the device of the state's tensors: the hand-written
CUDA kernels (``repro_torch/csrc``) on the card, their plain PyTorch
versions on the CPU.  Ported: the streaming index and its policies, the
HNSW baseline, segments, durability, the serving front door
(``serving``, ``launch/serve.py``), the sharded index
(``core.ShardedIndex``) and, of the seed scaffolding, the recsys family:
``models.recsys`` (DLRM, DIN, two-tower), its arch specs
(``configs.all_archs()``: ``dlrm-rm2``, ``dlrm-mlperf``, ``din``,
``two-tower-retrieval``) and the ``TokenStream`` / ``ClickStream`` data
streams.  Training, the LM and GNN families and the dry-run tools are not
yet.
"""
from . import checkpoint, configs, core, data, ft, kernels, launch  # noqa: F401
from . import models  # noqa: F401
from . import serving  # noqa: F401
from .core import (  # noqa: F401
    ANNConfig,
    IndexState,
    StreamingIndex,
    apply,
    graph_recall,
    init_index_state,
    make_dataset,
    maybe_consolidate,
    run_runbook,
    search_index,
)
