"""Checkpoint/restart supervision with failure injection
(``repro/ft/supervisor.py``), for trees of PyTorch tensors.

``Supervisor.run`` drives a step function under a restart loop: any
exception (including an injected ``SimulatedFailure``, standing in for a
lost worker) rolls the state back to the last complete checkpoint and
resumes.  A step that is a pure function of ``(state, t)`` makes the resume
bit-exact: the final state equals an uninterrupted run's.  With
``shardings`` (a tree of ``launch.mesh.NamedSharding``) a restored state
is DTensors on those placements, as the reference's lands on its
``NamedSharding``s.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from ..checkpoint import CheckpointManager, restore_onto


class SimulatedFailure(RuntimeError):
    """Injected stand-in for a node loss / preemption."""


@dataclasses.dataclass
class Supervisor:
    """``max_restarts`` caps total restarts over the whole run;
    ``max_restarts_per_step`` caps restarts attributable to ONE step, so a
    deterministic crash at step t raises after N attempts instead of
    burning the global budget that transient failures elsewhere need."""

    manager: CheckpointManager
    checkpoint_every: int = 10
    max_restarts: int = 10
    max_restarts_per_step: int = 5

    def run(
        self,
        init_state: Any,
        step_fn: Callable[[Any, int], Any],
        n_steps: int,
        *,
        shardings: Any = None,
        device=None,
        fail_at: Optional[Dict[int, int]] = None,
        log: Optional[Callable[[str], None]] = None,
    ):
        """Run ``state = step_fn(state, t)`` for t in [0, n_steps) under
        restart supervision; a restored state lands on ``shardings``, else
        on ``device`` (default: the card).  ``fail_at`` maps step -> how
        many times to inject a failure at that step (for tests)."""
        log = log or (lambda s: None)
        fail_budget = dict(fail_at or {})
        state = init_state
        restarts = 0
        per_step: Dict[int, int] = {}
        t = 0
        while t < n_steps:
            try:
                if fail_budget.get(t, 0) > 0:
                    fail_budget[t] -= 1
                    raise SimulatedFailure(f"injected failure at step {t}")
                state = step_fn(state, t)
                t += 1
                if t % self.checkpoint_every == 0 or t == n_steps:
                    self.manager.save(t, state)
                    log(f"checkpointed step {t}")
            except Exception as e:  # noqa: BLE001 — the restart loop
                restarts += 1
                per_step[t] = per_step.get(t, 0) + 1
                if restarts > self.max_restarts:
                    raise
                if per_step[t] > self.max_restarts_per_step:
                    log(f"step {t} failed {per_step[t]} times "
                        f"(deterministic crash?); giving up")
                    raise
                latest = self.manager.latest()
                log(f"failure at step {t} ({e}); restarting from "
                    f"{latest if latest is not None else 'scratch'}")
                if latest is None:
                    state, t = init_state, 0
                else:
                    _, tree, _ = self.manager.load(latest, like=state)
                    state = restore_onto(tree, shardings, device=device)
                    t = latest
        return state, {"restarts": restarts, "final_step": t}
