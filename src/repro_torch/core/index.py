"""``StreamingIndex``: the host shell over the device-resident index handle
(``repro/core/index.py``).

The class owns no index state of its own: the external-id map, the graph
and the per-op counters live in one ``IndexState`` on ``device`` (the card
unless the caller names another), and every insert/delete goes through
``core/api.py::apply``.  What remains here is host orchestration: wall-clock
timing, the bootstrap-vs-batched windowing, capacity growth
(``core/grow.py``), the consolidation trigger and the exception contracts.

``apply`` updates the handle's tensors in place (the reference donates
them), so callers must not hold raw tensors of ``istate`` across an update;
``core.api.clone_state`` gives a copy.  Evaluation traffic (``recall``)
books into ``eval_counters``, never into the serving ``counters``.

Every registered update policy runs (``ip``, ``fresh``, ``local``); a
delete ends with ``maybe_consolidate`` under the index's own policy.
``apply_segments`` runs an op stream as segments (``core/api.py::
run_segments``); ``save`` / ``restore`` checkpoint the handle and the host
counters (``core/persist.py``), in the reference's format.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .api import (apply, available_policies, delete_batch, get_policy,
                  insert_batch, maybe_consolidate, plan_segments,
                  run_segments, search)
from .grow import ensure_capacity
from .persist import CheckpointMismatchError, restore_index, save_index
from .recall import brute_force_topk, recall_at_k
from .types import KIND_INSERT, ANNConfig, GraphState, IndexState, \
    init_index_state, resolve_device


@dataclasses.dataclass
class OpCounters:
    """Serving-side accounting (host wall clock + device comp counts)."""

    insert_s: float = 0.0
    delete_s: float = 0.0        # includes consolidation (paper's accounting)
    segment_s: float = 0.0       # whole-segment streams (mixed ops)
    search_s: float = 0.0
    n_inserts: int = 0
    n_deletes: int = 0
    n_queries: int = 0
    insert_comps: int = 0
    delete_comps: int = 0
    search_comps: int = 0
    n_consolidations: int = 0


@dataclasses.dataclass
class EvalCounters:
    """Evaluation-side accounting: ``recall()`` and runbook eval sweeps book
    here so they never pollute the serving counters."""

    search_s: float = 0.0
    n_queries: int = 0
    search_comps: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StreamingIndex:
    """A single-shard streaming ANNS index with external integer ids."""

    def __init__(self, cfg: ANNConfig, mode: str = "ip",
                 max_external_id: Optional[int] = None,
                 batch_updates: bool = False,
                 backend: Optional[str] = None, auto_grow: bool = True,
                 device=None):
        """``mode``: the update policy name (``available_policies()``).
        ``batch_updates``: run the search phase of a batch of updates
        data-parallel (relaxed visibility, see ``core/batched.py``).
        ``backend``: override ``cfg.backend``.  ``auto_grow``: grow
        ``n_cap`` into the next power-of-two bucket when an update stream
        would cross the high-water mark; disable to keep the hard
        capacity-exhausted contract.  ``device``: where the handle lives
        (default: the card)."""
        if mode not in available_policies():
            raise ValueError(
                f"unknown policy {mode!r}; available: {available_policies()}"
            )
        if backend is not None:
            cfg = dataclasses.replace(cfg, backend=backend)
        self.cfg = cfg
        self.mode = mode
        self.policy = get_policy(mode)
        self.batch_updates = batch_updates
        self.auto_grow = auto_grow
        self.device = resolve_device(device)
        if max_external_id is None:
            max_external_id = cfg.n_cap * 4
        self.max_external_id = max_external_id
        self.istate: IndexState = init_index_state(cfg, max_external_id,
                                                   device=self.device)
        self.counters = OpCounters()
        self.eval_counters = EvalCounters()

    @property
    def state(self) -> GraphState:
        """The graph inside the handle."""
        return self.istate.graph

    # -- updates -----------------------------------------------------------

    def _apply(self, batch, *, sequential: bool):
        self.istate, res = apply(self.istate, self.cfg, batch,
                                 policy=self.mode, sequential=sequential)
        return res

    def _ensure_capacity(self, incoming: int) -> bool:
        """Grow the handle into a bigger capacity bucket when ``incoming``
        more inserts would cross the high-water mark."""
        if not self.auto_grow:
            return False
        self.istate, self.cfg, grew = ensure_capacity(self.istate, self.cfg,
                                                      incoming)
        return grew

    def _apply_insert(self, ext_ids, vectors, batched: bool):
        oob = (ext_ids < 0) | (ext_ids >= self.max_external_id)
        if oob.any():
            raise ValueError(
                f"external id(s) outside [0, {self.max_external_id}): "
                f"{ext_ids[oob][:8].tolist()}"
            )
        self._ensure_capacity(len(ext_ids))
        res = self._apply(insert_batch(ext_ids, vectors, device=self.device),
                          sequential=not batched)
        ok = res.ok.cpu().numpy()
        self.counters.insert_comps += int(res.n_comps.sum())
        if not ok[:len(ext_ids)].all():
            raise RuntimeError("index capacity exhausted")

    def insert(self, ext_ids: np.ndarray, vectors: np.ndarray) -> None:
        assert len(ext_ids) == len(vectors)
        t0 = time.perf_counter()
        ext_ids = np.asarray(ext_ids)
        if not self.batch_updates:
            self._apply_insert(ext_ids, vectors, batched=False)
        else:
            # relaxed visibility (searches see the pre-batch graph) is only
            # sound when the batch is small against the live graph:
            # bootstrap serially to 2*l_build, then power-of-two windows
            # capped at min(n_active, 512)
            i = 0
            n = len(ext_ids)
            while i < n:
                na = self.n_active
                boot = 2 * self.cfg.l_build
                if na < boot:
                    take = min(boot - na, n - i)
                    batched = False
                else:
                    c = 64
                    while c * 2 <= min(na, 512):
                        c *= 2
                    take = min(c, n - i)
                    batched = True
                self._apply_insert(ext_ids[i:i + take],
                                   vectors[i:i + take], batched=batched)
                i += take
        _sync(self.device)
        self.counters.insert_s += time.perf_counter() - t0
        self.counters.n_inserts += len(ext_ids)

    def delete(self, ext_ids: np.ndarray) -> None:
        """Delete by external id.  Duplicates within one call are deleted
        once.  Unknown ids raise ``KeyError`` after the known ids of the
        batch are applied and booked."""
        t0 = time.perf_counter()
        ext_ids = np.asarray(ext_ids)
        _, first = np.unique(ext_ids, return_index=True)
        ext_ids = ext_ids[np.sort(first)]   # dedupe, keep caller order
        res = self._apply(delete_batch(ext_ids, self.cfg.dim,
                                       device=self.device),
                          sequential=not self.batch_updates)
        self.counters.delete_comps += int(res.n_comps.sum())
        ok = res.ok.cpu().numpy()[:len(ext_ids)]
        self.counters.delete_s += time.perf_counter() - t0
        self.counters.n_deletes += int(ok.sum())
        self.maybe_consolidate()
        if not ok.all():
            raise KeyError(
                f"delete of unknown external id(s): "
                f"{ext_ids[~ok][:8].tolist()}"
            )

    def apply_segments(self, steps, *, splits=None, max_t: int = 64,
                       sequential: bool = False, unroll=None):
        """Run a list of ``UpdateBatch`` ops as segments
        (``core/api.py::run_segments``): the policy's trigger after every
        op (ip, local: the sweep at once; fresh: Alg 4 at the segment
        boundary when any op raised ``needs_consolidation``).

        Books wall time into ``counters.segment_s`` and op counts and comps
        from the handle's counters (applied ops: invalid lanes are silent
        no-ops here, where ``insert`` / ``delete`` raise).  Returns the
        per-segment ``SegmentResult`` list."""
        # grow before planning, for the whole stream's insert demand
        # (deletes inside the stream only return capacity)
        self._ensure_capacity(sum(
            int((s.valid & (s.kind == KIND_INSERT)).sum()) for s in steps))
        plan = plan_segments(steps, splits=splits, max_t=max_t)
        t0 = time.perf_counter()
        st = self.istate
        before = (int(st.n_inserts), int(st.n_deletes),
                  int(st.insert_comps), int(st.delete_comps))
        self.istate, results = run_segments(
            self.istate, self.cfg, plan, policy=self.mode,
            sequential=sequential, unroll=unroll)
        _sync(self.device)
        self.counters.segment_s += time.perf_counter() - t0
        st = self.istate
        self.counters.n_inserts += int(st.n_inserts) - before[0]
        self.counters.n_deletes += int(st.n_deletes) - before[1]
        self.counters.insert_comps += int(st.insert_comps) - before[2]
        self.counters.delete_comps += int(st.delete_comps) - before[3]
        if self.policy.device_consolidation:
            self.counters.n_consolidations += sum(
                int(r.consolidated.sum()) for r in results)
        else:
            self.counters.n_consolidations += sum(
                bool(r.needs_consolidation.any()) for r in results)
        return results

    def maybe_consolidate(self, force: bool = False) -> bool:
        t0 = time.perf_counter()
        self.istate, did = maybe_consolidate(self.istate, self.cfg,
                                             policy=self.mode, force=force)
        if did:
            _sync(self.device)
            self.counters.delete_s += time.perf_counter() - t0
            self.counters.n_consolidations += 1
        return did

    # -- durability ----------------------------------------------------------

    def save(self, manager, step: int, *, extra: Optional[dict] = None,
             on_event=None):
        """Checkpoint the handle and the host accounting (``counters`` and
        ``eval_counters`` ride the manifest's ``extra``).  Call between
        updates."""
        user = {
            "mode": self.mode,
            "batch_updates": self.batch_updates,
            "counters": dataclasses.asdict(self.counters),
            "eval_counters": dataclasses.asdict(self.eval_counters),
        }
        user.update(extra or {})
        return save_index(manager, step, self.istate, self.cfg,
                          policy=self.mode, extra=user, on_event=on_event)

    @classmethod
    def restore(cls, manager, cfg: ANNConfig, *, step=None, mode=None,
                batch_updates: Optional[bool] = None,
                backend: Optional[str] = None, device=None):
        """Restore a ``StreamingIndex`` from the latest (or given) step
        written by ``save`` (of either package) onto ``device`` (default:
        the card).  Returns ``(index, step)``; the serving and eval
        counters resume from the checkpointed values.  ``mode`` defaults
        to the checkpoint's policy; given, it is validated against it
        (``CheckpointMismatchError``, as is a stacked checkpoint of
        ``ShardedIndex``)."""
        step, istate, extra = restore_index(manager, cfg, step=step,
                                            policy=mode, device=device)
        meta, user = extra["index"], extra.get("user", {})
        if meta["n_logical"]:
            raise CheckpointMismatchError(
                f"checkpoint holds a {meta['n_logical']}-shard stacked "
                f"state; restore it with ShardedIndex.restore"
            )
        # the constructor's empty handle is replaced at once: it is
        # allocated on the meta device, which holds no data
        idx = cls(
            cfg, mode=meta["policy"],
            max_external_id=meta["max_external_id"],
            batch_updates=(user.get("batch_updates", False)
                           if batch_updates is None else batch_updates),
            backend=backend, device="meta",
        )
        idx.device = resolve_device(device)
        idx.istate = istate
        idx.counters = OpCounters(**user.get("counters", {}))
        idx.eval_counters = EvalCounters(**user.get("eval_counters", {}))
        return idx, step

    # -- queries -----------------------------------------------------------

    def _search(self, queries, k, l, counters):
        """One query batch through the front door, booked into the given
        counters object (serving or evaluation)."""
        t0 = time.perf_counter()
        ext, dists, res = search(
            self.istate, self.cfg,
            torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device),
            k=k, l=l or self.cfg.l_search,
        )
        ext = ext.cpu().numpy()
        counters.search_comps += int(res.n_comps.sum())
        counters.search_s += time.perf_counter() - t0
        counters.n_queries += queries.shape[0]
        return ext, dists.cpu().numpy(), res.topk_ids.cpu().numpy()

    def search(self, queries: np.ndarray, k: int = 10,
               l: Optional[int] = None):
        """Returns (ext_ids (Q, k), dists (Q, k), slot_ids (Q, k))."""
        return self._search(queries, k, l, self.counters)

    # -- evaluation --------------------------------------------------------

    def recall(self, queries: np.ndarray, k: int = 10,
               l: Optional[int] = None) -> float:
        """Recall@k against the exact oracle; books into
        ``eval_counters``."""
        _, _, slot_ids = self._search(queries, k, l, self.eval_counters)
        true_ids, _ = brute_force_topk(
            self.istate.graph, self.cfg,
            torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device),
            k=k,
        )
        return recall_at_k(slot_ids, true_ids, k)

    @property
    def n_active(self) -> int:
        return int(self.istate.graph.n_active)


__all__ = ["EvalCounters", "OpCounters", "StreamingIndex"]
