# IP-DiskANN's streaming loop (insert, in-place delete, beam search,
# recall), the fresh and local update policies, the HNSW baseline, the
# StreamingIndex shell with capacity growth, whole-segment update streams,
# durability (checkpoint, restore, supervised replay), the published
# snapshots the serving layer reads, the runbook driver, the int8
# quantized tier and the sharded index (L logical rows over a list of
# devices), on PyTorch tensors, with hand-written CUDA kernels on the card.
from .api import (
    FreshDiskANNPolicy,
    IPDiskANNPolicy,
    LocalRepairPolicy,
    Segment,
    SegmentPlan,
    SnapshotHandle,
    UpdatePolicy,
    apply,
    apply_segment,
    auto_unroll,
    available_policies,
    clone_state,
    compact_owner_batch,
    compact_owner_segment,
    consolidate_if_needed,
    delete_batch,
    device_sweep,
    get_policy,
    insert_batch,
    make_update_batch,
    maybe_consolidate,
    mixed_update_batch,
    pad_update_batch,
    plan_segments,
    register_policy,
    run_segments,
    segment_scan,
    segment_step,
    take_snapshot,
)
from .api import search as search_index
from .backend import (
    DistanceBackend,
    available_backends,
    get_backend,
    register_backend,
    resolve_backend,
)
from .batched import insert_many_batched, ip_delete_many_batched
from .consolidate import (consolidate_stacked, consolidation_due,
                          fresh_consolidate, light_consolidate)
from .delete import (ip_delete, ip_delete_many, lazy_delete,
                     lazy_delete_many, local_delete, local_delete_many)
from .distributed import ShardedIndex, as_int_payload
from .driver import RunbookReport, StepMetrics, run_runbook
from .grow import (HIGH_WATER, ensure_capacity, grow_index, needs_growth,
                   next_capacity)
from .edges import remove_target_everywhere
from .hnsw import HNSWConfig, HNSWIndex, HNSWState, init_hnsw
from .index import EvalCounters, OpCounters, StreamingIndex
from .insert import insert, insert_many
from .persist import (CFG_CRITICAL, SCHEMA_VERSION, CheckpointMismatchError,
                      restore_index, run_segments_supervised, save_index,
                      validate_index_manifest)
from .prune import robust_prune, robust_prune_rows
from .quant import (QuantStore, dequantize_rows, init_quant_store,
                    quant_dists_to_ids_batched, quant_write_rows,
                    quantize_rows)
from .recall import brute_force_topk, graph_recall, recall_at_k
from .runbook import (Runbook, RunbookStep, make_dataset, make_runbook,
                      runbook_segment_plan, runbook_update_stream,
                      sliding_window_runbook, step_update_batch)
from .search import (SearchResult, greedy_search, search_batch,
                     search_batch_vmap, se_key)
from .search_batched import (batched_greedy_search, merge_topk, next_bucket,
                             pad_batch, resolved_hop_fused)
from . import bitset
from .types import (
    INVALID,
    KIND_DELETE,
    KIND_INSERT,
    ANNConfig,
    ApplyResult,
    GraphState,
    IndexState,
    SegmentResult,
    UpdateBatch,
    init_index_state,
    init_state,
    noop_update_batch,
    stack_states,
    stack_update_batches,
    take_update_lanes,
    unstack_state,
)
