"""HNSW baseline (``repro/core/hnsw.py``; §4, hnswlib-style) with
mark-delete and replacement inserts, on PyTorch tensors.

Hierarchical levels, ef_construction / ef_search beams, the select-neighbours
heuristic (RobustPrune with alpha = 1), deletion as tombstoning, and the §4
"replace a deleted node on insert" repair: every one-hop neighbour of the
reused slot p gets p's two-hop neighbours added and is pruned back to the
degree limit, then the insert proceeds into p's slot.

Each level's adjacency is viewed as a ``GraphState`` (same vectors and masks,
another ``adj``), so the levels ride the DiskANN machinery: the serial
``greedy_search`` of an insert (the single-query gather kernel on the card),
``robust_prune_rows`` and ``append_rows`` for the links, and the batched
engine for queries, whose per-lane ``starts`` carry the per-query descent
(the fused hop kernel on the card).  Levels are drawn from
``np.random.default_rng(seed)`` exactly as the reference draws them, so both
packages build the same hierarchy.  The state's tensors are updated in place.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .edges import append_rows
from .index import EvalCounters, OpCounters, _sync
from .prune import robust_prune, robust_prune_rows
from .search import greedy_search, search_batch
from .types import INVALID, ANNConfig, GraphState, clip_ids, resolve_device


@dataclasses.dataclass(frozen=True)
class HNSWConfig:
    dim: int
    n_cap: int
    m: int = 48                      # paper: M = 48
    ef_construction: int = 128
    ef_search: int = 128
    max_level: int = 4               # levels 1..max_level live in adj_up
    metric: str = "l2"
    consolidation_threshold: float = 0.2
    # the distance engine of every level ("auto": by the state's device)
    backend: str = "auto"

    @property
    def m0(self) -> int:
        return 2 * self.m

    def level_cfg(self, level: int) -> ANNConfig:
        return _level_cfg(self, level)


@functools.lru_cache(maxsize=None)
def _level_cfg(cfg: HNSWConfig, level: int) -> ANNConfig:
    return ANNConfig(
        dim=cfg.dim, n_cap=cfg.n_cap, r=cfg.m0 if level == 0 else cfg.m,
        l_build=cfg.ef_construction, l_search=cfg.ef_search, alpha=1.0,
        metric=cfg.metric, backend=cfg.backend,
    )


class HNSWState(NamedTuple):
    vectors: torch.Tensor     # f32[n_cap, dim]
    norms: torch.Tensor       # f32[n_cap]
    adj0: torch.Tensor        # i32[n_cap, m0]
    adj_up: torch.Tensor      # i32[max_level, n_cap, m]
    level: torch.Tensor       # i32[n_cap]  top level of each node (-1 unused)
    active: torch.Tensor      # bool[n_cap]
    tombstone: torch.Tensor   # bool[n_cap]
    free_stack: torch.Tensor  # i32[n_cap]
    free_top: torch.Tensor    # i32[]
    entry: torch.Tensor       # i32[]
    entry_level: torch.Tensor  # i32[]
    n_active: torch.Tensor    # i32[]
    n_pending: torch.Tensor   # i32[]


def init_hnsw(cfg: HNSWConfig, device=None) -> HNSWState:
    """An empty hierarchy on ``device`` (default: the card)."""
    dev = resolve_device(device)
    n = cfg.n_cap

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return HNSWState(
        vectors=torch.zeros((n, cfg.dim), dtype=torch.float32, device=dev),
        norms=torch.zeros((n,), dtype=torch.float32, device=dev),
        adj0=torch.full((n, cfg.m0), INVALID, dtype=torch.int32, device=dev),
        adj_up=torch.full((cfg.max_level, n, cfg.m), INVALID,
                          dtype=torch.int32, device=dev),
        level=torch.full((n,), INVALID, dtype=torch.int32, device=dev),
        active=torch.zeros((n,), dtype=torch.bool, device=dev),
        tombstone=torch.zeros((n,), dtype=torch.bool, device=dev),
        free_stack=torch.arange(n - 1, -1, -1, dtype=torch.int32,
                                device=dev),
        free_top=i32(n),
        entry=i32(INVALID),
        entry_level=i32(INVALID),
        n_active=i32(0),
        n_pending=i32(0),
    )


def _level_view(st: HNSWState, cfg: HNSWConfig, level: int,
                start: Optional[torch.Tensor] = None) -> GraphState:
    """Level ``level`` as a ``GraphState`` sharing the hierarchy's tensors
    (writes through the view land in the hierarchy), entered at ``start``
    (default: the entry point)."""
    return GraphState(
        vectors=st.vectors, norms=st.norms,
        adj=st.adj0 if level == 0 else st.adj_up[level - 1],
        active=st.active, tombstone=st.tombstone,
        quarantine=torch.zeros_like(st.active),
        free_stack=st.free_stack, free_top=st.free_top,
        start=st.entry if start is None else start,
        n_active=st.n_active, n_pending=st.n_pending,
    )


def _put_adj(st: HNSWState, level: int, rows, new_rows) -> HNSWState:
    """Write ``new_rows`` into rows ``rows`` of level ``level``, in place."""
    adj = st.adj0 if level == 0 else st.adj_up[level - 1]
    adj[rows] = new_rows
    return st


def _descend(st: HNSWState, cfg: HNSWConfig, x, from_level: int,
             to_level: int, start):
    """Greedy ef = 1 descent from ``from_level`` down to ``to_level``
    (exclusive)."""
    cur = start
    for lvl in range(from_level, to_level, -1):
        if lvl > cfg.max_level:
            continue
        res = greedy_search(_level_view(st, cfg, lvl, cur),
                            cfg.level_cfg(lvl), x, k=1, l=1, max_visits=64)
        cur = torch.where(res.topk_ids[0] >= 0, res.topk_ids[0], cur)
    return cur


def _link(st: HNSWState, cfg: HNSWConfig, level: int, slot: int, x,
          cand_ids, cand_dists) -> HNSWState:
    """Select neighbours for ``slot`` on ``level`` and add the reverse
    edges.  The reference's reverse loop touches distinct rows (``nout`` is
    deduplicated) and its prune reads no adjacency, so the r appends go
    through one ``append_rows``."""
    lcfg = cfg.level_cfg(level)
    view = _level_view(st, cfg, level)
    nout = robust_prune(view, lcfg, x, cand_ids, cand_dists, p_id=slot)
    _put_adj(st, level, slot, nout)
    append_rows(view, lcfg, nout, torch.tensor(slot, device=nout.device))
    return st


def _insert_at_levels(st: HNSWState, cfg: HNSWConfig, x, slot: int,
                      node_level: int) -> HNSWState:
    """The insert body (slot already allocated), in place."""
    x = x.to(torch.float32)
    st.vectors[slot] = x
    st.norms[slot] = torch.dot(x, x)
    st.level[slot] = node_level
    st.active[slot] = True
    st.n_active.add_(1)
    entry_level = int(st.entry_level)
    cur = _descend(st, cfg, x, cfg.max_level, node_level, st.entry.clone())
    for lvl in range(min(cfg.max_level, node_level), -1, -1):
        res = greedy_search(_level_view(st, cfg, lvl, cur),
                            cfg.level_cfg(lvl), x, k=1,
                            l=cfg.ef_construction)
        _link(st, cfg, lvl, slot, x, res.visited_ids, res.visited_dists)
        cur = torch.where(res.topk_ids[0] >= 0, res.topk_ids[0], cur)
    if node_level > entry_level:
        st.entry.fill_(slot)
    st.entry_level.fill_(max(entry_level, node_level))
    return st


def _repair_replaced(st: HNSWState, cfg: HNSWConfig, p: int) -> HNSWState:
    """Pre-insert repair of the tombstoned slot p (the §4 replace
    procedure), in place: on every level each out-neighbour z of p is
    pruned over its own row plus p's two-hop neighbours (C = m + m^2
    candidates: the prune's per-step formulation), all against the level
    as it was, then p's row is cleared."""
    sp = min(max(p, 0), cfg.n_cap - 1)
    for lvl in range(cfg.max_level + 1):
        lcfg = cfg.level_cfg(lvl)
        view = _level_view(st, cfg, lvl)
        row = view.adj[sp].clone()
        z = row[row >= 0]
        if z.numel():
            two_hop = torch.where((row >= 0)[:, None],
                                  view.adj[clip_ids(row, cfg.n_cap)],
                                  torch.full_like(view.adj[:1], INVALID))
            cand = torch.cat([view.adj[z.long()],
                              two_hop.reshape(1, -1).expand(z.numel(), -1)],
                             1)
            cand = torch.where(cand == p, torch.full_like(cand, INVALID),
                               cand)
            new_rows = robust_prune_rows(view, lcfg, st.vectors[z.long()],
                                         cand, p_ids=z)
            _put_adj(st, lvl, z.long(), new_rows)
        view.adj[sp] = INVALID
    st.tombstone[sp] = False
    st.level[sp] = INVALID
    st.n_pending.sub_(1)
    if int(st.entry) == p:
        st.entry.copy_(torch.argmax(st.active.to(torch.int8)).to(torch.int32))
    return st


class HNSWIndex:
    """Host-orchestrated HNSW with external ids, on ``device`` (default: the
    card).  Duck-type compatible with ``run_runbook``'s index surface
    (``mode``, ``batch_updates``, ``counters``, ``eval_counters``, insert /
    delete / recall / ``n_active``)."""

    mode = "hnsw"
    batch_updates = False

    def __init__(self, cfg: HNSWConfig, max_external_id: Optional[int] = None,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = init_hnsw(cfg, self.device)
        self.rng = np.random.default_rng(seed)
        n_ext = max_external_id or cfg.n_cap * 4
        self._ext2slot = np.full((n_ext,), INVALID, np.int64)
        self._slot2ext = np.full((cfg.n_cap,), INVALID, np.int64)
        self._replace_queue: list = []
        self.counters = OpCounters()
        self.eval_counters = EvalCounters()
        self._ml = 1.0 / np.log(cfg.m)

    # the reference's read-only views of ``counters``
    @property
    def insert_s(self) -> float:
        return self.counters.insert_s

    @property
    def search_s(self) -> float:
        return self.counters.search_s

    @property
    def search_comps(self) -> int:
        return self.counters.search_comps

    @property
    def n_inserts(self) -> int:
        return self.counters.n_inserts

    @property
    def n_queries(self) -> int:
        return self.counters.n_queries

    def _sample_level(self) -> int:
        return min(int(-np.log(self.rng.uniform(1e-12, 1.0)) * self._ml),
                   self.cfg.max_level)

    def insert(self, ext_ids, vectors) -> None:
        t0 = time.perf_counter()
        st = self.state
        n_pending = int(st.n_pending)
        use_replace = n_pending > self.cfg.consolidation_threshold * max(
            int(st.n_active), 1)
        if use_replace and not self._replace_queue:
            self._replace_queue = list(
                np.nonzero(st.tombstone.cpu().numpy())[0])
        xs = torch.as_tensor(np.asarray(vectors, np.float32),
                             device=self.device)
        for ext, x in zip(np.asarray(ext_ids), xs):
            if self._replace_queue:
                slot = int(self._replace_queue.pop())
                _repair_replaced(st, self.cfg, slot)
            else:
                ft = int(st.free_top)
                if ft <= 0:
                    raise RuntimeError("hnsw capacity exhausted")
                slot = int(st.free_stack[ft - 1])
                st.free_top.sub_(1)
            _insert_at_levels(st, self.cfg, x, slot, self._sample_level())
            self._ext2slot[int(ext)] = slot
            self._slot2ext[slot] = int(ext)
        _sync(self.device)
        self.counters.insert_s += time.perf_counter() - t0
        self.counters.n_inserts += len(np.asarray(ext_ids))

    def delete(self, ext_ids) -> None:
        """Mark-delete; the cost is charged to insertion through the
        replacement repair (§4)."""
        t0 = time.perf_counter()
        st = self.state
        slots = self._ext2slot[np.asarray(ext_ids)]
        sl = torch.as_tensor(slots, device=self.device)
        st.active[sl] = False
        st.tombstone[sl] = True
        st.n_active.sub_(len(slots))
        st.n_pending.add_(len(slots))
        self._ext2slot[np.asarray(ext_ids)] = INVALID
        self._slot2ext[slots] = INVALID
        _sync(self.device)
        self.counters.insert_s += time.perf_counter() - t0
        self.counters.n_deletes += len(slots)

    def search(self, queries, k: int = 10, ef: Optional[int] = None):
        """Returns (ext_ids (Q, k), dists (Q, k), slot_ids (Q, k)).  The
        upper levels descend at l = 1 with the batch's shared entry, then
        each query's own start; level 0 at l = ef from those starts."""
        t0 = time.perf_counter()
        st = self.state
        x = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device)
        ef = ef or self.cfg.ef_search
        starts = None
        for lvl in range(min(int(st.entry_level), self.cfg.max_level), 0,
                         -1):
            res = search_batch(_level_view(st, self.cfg, lvl),
                               self.cfg.level_cfg(lvl), x, k=1, l=1,
                               max_visits=None if starts is None else 64,
                               starts=starts)
            starts = torch.where(res.topk_ids[:, 0] >= 0, res.topk_ids[:, 0],
                                 st.entry)
        res = search_batch(_level_view(st, self.cfg, 0),
                           self.cfg.level_cfg(0), x, k=k, l=ef,
                           starts=starts)
        ids = res.topk_ids.cpu().numpy()
        self.counters.search_comps += int(res.n_comps.sum())
        self.counters.search_s += time.perf_counter() - t0
        self.counters.n_queries += x.shape[0]
        ext = np.where(ids >= 0, self._slot2ext[np.clip(ids, 0, None)],
                       INVALID)
        return ext, res.topk_dists.cpu().numpy(), ids

    def recall(self, queries, k: int = 10) -> float:
        """Recall@k against the exact oracle; books into
        ``eval_counters``, never the serving counters."""
        from .recall import brute_force_topk, recall_at_k

        t0 = time.perf_counter()
        c = self.counters
        saved = (c.search_comps, c.search_s, c.n_queries)
        _, _, slot_ids = self.search(queries, k=k)
        self.eval_counters.search_comps += c.search_comps - saved[0]
        self.eval_counters.n_queries += c.n_queries - saved[2]
        c.search_comps, c.search_s, c.n_queries = saved
        self.eval_counters.search_s += time.perf_counter() - t0
        true_ids, _ = brute_force_topk(
            _level_view(self.state, self.cfg, 0), self.cfg.level_cfg(0),
            torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device), k=k)
        return recall_at_k(slot_ids, true_ids, k)

    @property
    def n_active(self) -> int:
        return int(self.state.n_active)


__all__ = ["HNSWConfig", "HNSWIndex", "HNSWState", "init_hnsw"]
