"""Durability (``repro/core/persist.py``): checkpoint and restore of an
``IndexState``, and supervised crash-recoverable segment streams.

  * ``save_index(manager, step, state, cfg)`` writes every leaf of the
    handle through ``checkpoint/manager.py``'s atomic commit, with the
    config, policy and capacity in the manifest's ``extra["index"]``; the
    leaves, their names and dtypes and the manifest are the reference's,
    so a checkpoint restores in either package;
  * ``restore_index(manager, cfg)`` checks the schema version, the
    critical config fields (``CFG_CRITICAL``), the capacity, the policy
    and every leaf's shape and dtype, raising ``CheckpointMismatchError``;
    a checkpoint of a smaller capacity bucket is grown into the caller's
    (``core/grow.py::grow_index``);
  * ``run_segments_supervised`` drives a ``SegmentPlan`` under a restart
    loop: a checkpoint every K segments and once before the first, and on
    any failure a restore of the latest complete checkpoint and a replay
    of the plan's tail.  Segments are deterministic and the ``.npy`` round
    trip is exact, so the recovered state is bitwise the uninterrupted
    run's.

Both take a single handle or ``ShardedIndex``'s stacked (L, ...) state:
the manifest's ``n_logical`` is 0 for a single handle and L for a stack,
which ``ShardedIndex.restore`` lays over any device list whose length
divides L (elastic reshard).

The port updates the handle in place (the reference donates it), so a
failure in the middle of a segment leaves the handle half-written: the
supervised runner never goes on with it, it restores.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..checkpoint.manager import (CheckpointManager, CheckpointMismatchError,
                                  restore_onto)
from ..ft.supervisor import SimulatedFailure
from .api import SegmentPlan, segment_step
from .grow import grow_index
from .types import ANNConfig, IndexState, init_index_state, stack_states

# bumped whenever the IndexState layout changes incompatibly (the
# reference's value: the two packages share the format)
SCHEMA_VERSION = 1

# config fields that must match between writer and reader: they size the
# tensors (dim, r), change distance semantics (metric) or the leaf set
# (quantized).  Beam widths, thresholds and the backend are recorded but
# free.  ``n_cap`` may grow across a restore, never shrink.
CFG_CRITICAL = ("dim", "r", "metric", "quantized")


def _index_meta(state: IndexState, cfg: ANNConfig, policy: str) -> dict:
    stacked = state.graph.vectors.ndim == 3
    return {
        "kind": "index_state",
        "schema": SCHEMA_VERSION,
        "config": dataclasses.asdict(cfg),
        "policy": policy,
        "max_external_id": int(state.ext2slot.shape[-1]),
        "n_logical": int(state.graph.vectors.shape[0]) if stacked else 0,
    }


def save_index(manager: CheckpointManager, step: int, state: IndexState,
               cfg: ANNConfig, *, policy: str = "ip",
               extra: Optional[dict] = None,
               on_event: Optional[Callable[[str], None]] = None):
    """Checkpoint the whole ``IndexState`` (single or stacked, tensors or
    numpy arrays) at ``step``.  The manifest's
    ``extra`` holds the index metadata under ``"index"`` and the caller's
    ``extra`` under ``"user"``; ``on_event`` goes to
    ``CheckpointManager.save`` (crash injection).  Reads the state (one
    copy to the host per leaf) and leaves it untouched."""
    payload = {"index": _index_meta(state, cfg, policy), "user": extra or {}}
    return manager.save(step, state, extra=payload, on_event=on_event)


def validate_index_manifest(manifest: dict, cfg: ANNConfig,
                            policy: Optional[str] = None) -> dict:
    """Check a manifest's ``extra["index"]`` against the caller's config
    (and policy, when given); returns the metadata dict."""
    extra = manifest.get("extra", {})
    meta = extra.get("index")
    if not isinstance(meta, dict) or meta.get("kind") != "index_state":
        raise CheckpointMismatchError(
            "checkpoint does not hold an IndexState (no index metadata in "
            "the manifest — was it written by save_index?)"
        )
    if meta.get("schema") != SCHEMA_VERSION:
        raise CheckpointMismatchError(
            f"checkpoint schema {meta.get('schema')!r} != supported "
            f"{SCHEMA_VERSION}"
        )
    saved = meta.get("config", {})
    mine = dataclasses.asdict(cfg)
    drift = {k: (saved.get(k), mine[k]) for k in CFG_CRITICAL
             if saved.get(k) != mine[k]}
    if drift:
        raise CheckpointMismatchError(
            "config mismatch (checkpoint vs caller): "
            + ", ".join(f"{k}={a!r} vs {b!r}" for k, (a, b) in drift.items())
        )
    if saved.get("n_cap", mine["n_cap"]) > mine["n_cap"]:
        raise CheckpointMismatchError(
            f"checkpoint capacity n_cap={saved.get('n_cap')} exceeds the "
            f"caller's {mine['n_cap']} (capacity buckets only grow; restore "
            f"with n_cap >= the checkpoint's)"
        )
    if policy is not None and meta.get("policy") != policy:
        raise CheckpointMismatchError(
            f"checkpoint was written under policy {meta.get('policy')!r}, "
            f"caller requested {policy!r} (pass policy=None to adopt the "
            f"checkpoint's)"
        )
    return meta


def restore_index(manager: CheckpointManager, cfg: ANNConfig, *,
                  step: Optional[int] = None, policy: Optional[str] = None,
                  device=None) -> Tuple[int, IndexState, dict]:
    """Restore an ``IndexState`` written by ``save_index`` (of either
    package).  Returns ``(step, state, extra)``; ``extra["index"]`` holds
    the metadata (policy, max_external_id, n_logical, saved config).

    Validation raises ``CheckpointMismatchError``: schema, critical config,
    a capacity above the caller's, policy (when given), every leaf's shape
    and dtype against a template of the manifest's capacity and
    ``n_logical`` (a stacked checkpoint restores as the stacked (L, ...)
    state, as the reference's does).  A smaller capacity is grown into
    ``cfg.n_cap``, so ``grow(restore(save(s)))`` equals
    ``restore(save(grow(s)))`` bitwise.

    ``device``: where the tensors land (default: the card); ``False``
    returns numpy leaves."""
    if step is None:
        step = manager.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {manager.dir}")
    meta = validate_index_manifest(manager.manifest(step), cfg, policy)
    saved_cap = int(meta.get("config", {}).get("n_cap", cfg.n_cap))
    load_cfg = dataclasses.replace(cfg, n_cap=saved_cap)
    template = init_index_state(load_cfg, meta["max_external_id"],
                                device="meta")
    if meta["n_logical"]:
        template = stack_states([template] * meta["n_logical"])
    step, tree, extra = manager.load(step, like=template)
    if saved_cap == cfg.n_cap and device is False:
        return step, tree, extra
    state = restore_onto(tree, device="cpu" if device is False else device)
    if saved_cap != cfg.n_cap:
        state, _ = grow_index(state, load_cfg, cfg.n_cap)
    if device is False:
        state = type(state)(*(_numpy_tree(x) for x in state))
    return step, state, extra


def _numpy_tree(x):
    """A tree of tensors (any device) or numpy arrays with numpy leaves."""
    if x is None or isinstance(x, np.ndarray):
        return x
    if isinstance(x, tuple):
        return type(x)(*(_numpy_tree(c) for c in x))
    return x.cpu().numpy()


# ---------------------------------------------------------------------------
# Supervised streaming: segments under a checkpoint/restart loop
# ---------------------------------------------------------------------------


def run_segments_supervised(
    manager: CheckpointManager,
    state: IndexState,
    cfg: ANNConfig,
    plan: SegmentPlan,
    *,
    policy: str = "ip",
    sequential: bool = False,
    unroll: Optional[int] = None,
    checkpoint_every: int = 4,
    max_restarts: int = 10,
    max_restarts_per_step: int = 3,
    fail_at: Optional[Dict[int, int]] = None,
    crash_in_save: Optional[Dict[int, str]] = None,
    log: Optional[Callable[[str], None]] = None,
):
    """Run a ``SegmentPlan`` to completion under restart supervision.

    The state is checkpointed every ``checkpoint_every`` segments, at the
    end, and once before the first segment (the caller's handle is updated
    in place, so it cannot re-supply the initial state).  Any exception
    restores the latest complete checkpoint onto the state's device and
    replays the plan's tail; the final state is bitwise the uninterrupted
    ``run_segments``'s.

    ``fail_at`` maps segment index -> how many failures to inject just
    before that segment.  ``crash_in_save`` maps checkpoint step -> a
    commit event (``"leaf:<i>"``, ``"manifest"``, ``"rename"``) at which
    that save is killed; a kill before the rename leaves the previous
    complete step as the latest.  ``max_restarts`` bounds all restarts,
    ``max_restarts_per_step`` those of one segment.  Returns ``(state,
    [SegmentResult, ...], info)`` with one result per plan segment."""
    log = log or (lambda _s: None)
    device = state.ext2slot.device
    fail_budget = dict(fail_at or {})
    crash_budget = dict(crash_in_save or {})
    n = len(plan.segments)
    results: list = [None] * n
    restarts = 0
    per_step: Dict[int, int] = {}
    t = 0

    def save(step: int) -> None:
        ev = crash_budget.pop(step, None)
        hook = None
        if ev is not None:
            def hook(event: str, _ev: str = ev, _step: int = step) -> None:
                if event == _ev:
                    raise SimulatedFailure(
                        f"injected kill during save({_step}) at {event!r}"
                    )
        save_index(manager, step, state, cfg, policy=policy, on_event=hook)
        log(f"checkpointed segment {step}")

    save(0)
    while t < n:
        try:
            if fail_budget.get(t, 0) > 0:
                fail_budget[t] -= 1
                raise SimulatedFailure(f"injected failure at segment {t}")
            state, res = segment_step(state, cfg, plan.segments[t],
                                      policy=policy, sequential=sequential,
                                      unroll=unroll)
            results[t] = res
            t += 1
            if t % checkpoint_every == 0 or t == n:
                save(t)
        except Exception as e:  # noqa: BLE001 — the restart loop
            restarts += 1
            per_step[t] = per_step.get(t, 0) + 1
            if restarts > max_restarts:
                raise
            if per_step[t] > max_restarts_per_step:
                log(f"segment {t} failed {per_step[t]} times; giving up")
                raise
            # process death: the in-memory handle may be half-written, so
            # everything comes back from the latest complete checkpoint
            step, state, _ = restore_index(manager, cfg, policy=policy,
                                           device=device)
            log(f"failure at segment {t} ({e}); restored checkpoint "
                f"{step}, replaying {step}..{n}")
            t = step
    return state, results, {"restarts": restarts, "final_segment": t}


__all__ = [
    "CFG_CRITICAL",
    "CheckpointMismatchError",
    "SCHEMA_VERSION",
    "restore_index",
    "run_segments_supervised",
    "save_index",
    "validate_index_manifest",
]
