"""The harness end to end at a tiny size on the CPU's plain engine: correct
answers pass; the control and each fault the cells can have do not."""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_tiny import ROOT, SEED, run_tiny, tiny

from bench import control, manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]
RUNBOOK = "msturing100-hr.runbook"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("trace_on", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_run_is_correct(workload, trace_on):
    res = run_tiny(workload, trace_on=trace_on)
    assert res["correct"], res["checks"]
    m = manifest.load()
    group = m["per_layer"] if trace_on else m["end_to_end"]
    want = {e["name"] for e in group
            if workload in e.get("workloads", [workload])}
    # on the CPU no device trace exists, so its two metrics may be absent
    cpu_absent = {"hop_roofline_pct", "hop_launches_per_batch"}
    assert want - cpu_absent <= set(res["metrics"]) <= want
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0


def test_updates_are_replayed_and_judged():
    res = run_tiny(RUNBOOK)
    assert res["window"]["update_steps"] > 0
    assert res["checks"]["insert_found"]["value"] >= 0.9
    assert res["checks"]["repair_recall_at_10"]["value"] >= 0.9
    assert res["checks"]["bad_ids"]["value"] == 0


def test_control_is_not_correct():
    cfg, tr = tiny(RUNBOOK)
    checks, correct = control.control_run(cfg, tr, SEED, "cpu",
                                          min_batches=12)
    assert not correct
    assert checks["dist_gap"]["value"] > checks["dist_gap"]["limit"]


def _patch_apply_unchanged(monkeypatch):
    """An update step that returns the state unchanged (and acknowledges
    every lane)."""
    import repro_torch.core.index as index_mod
    from repro_torch.core.types import ApplyResult

    def apply(state, cfg, batch, **kw):
        z = torch.zeros_like(batch.ext_id)
        return state, ApplyResult(slot=z, ok=batch.valid.clone(), n_comps=z)

    monkeypatch.setattr(index_mod, "apply", apply)


def _patch_half_batch(monkeypatch):
    """Half of every query batch left out: those rows come back empty."""
    import repro_torch.core.index as index_mod

    orig = index_mod.search

    def search(state, cfg, queries, **kw):
        ext, dists, res = orig(state, cfg, queries, **kw)
        half = ext.shape[0] // 2
        ext = ext.clone()
        dists = dists.clone()
        ext[half:] = -1
        dists[half:] = float("inf")
        return ext, dists, res

    monkeypatch.setattr(index_mod, "search", search)


def _patch_altered_answer(monkeypatch):
    """One answer altered where it is produced: the first id of the first
    query of each batch swapped for another query's."""
    import repro_torch.core.index as index_mod

    orig = index_mod.search

    def search(state, cfg, queries, **kw):
        ext, dists, res = orig(state, cfg, queries, **kw)
        ext = ext.clone()
        ext[0, 0] = ext[-1, -1]
        return ext, dists, res

    monkeypatch.setattr(index_mod, "search", search)


def _patch_delete_ignored(monkeypatch):
    """A delete acknowledged and left undone: the ids stay live."""
    from repro_torch.core.index import StreamingIndex

    monkeypatch.setattr(StreamingIndex, "delete", lambda self, ids: None)


FAULTS = {"state_unchanged": (_patch_apply_unchanged, [RUNBOOK]),
          "delete_ignored": (_patch_delete_ignored, [RUNBOOK]),
          "half_batch": (_patch_half_batch, CELLS),
          "altered_answer": (_patch_altered_answer, CELLS)}


@pytest.mark.parametrize("fault,workload", [
    (f, w) for f, (_, cells) in FAULTS.items() for w in cells])
def test_fault_is_not_correct(fault, workload, monkeypatch):
    FAULTS[fault][0](monkeypatch)
    res = run_tiny(workload)
    assert not res["correct"], res["checks"]


def _run_py(cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", RUNBOOK, "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_py_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_py_refuses_without_the_program(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.requires_cuda
def test_tiny_run_on_the_card(cuda_device):
    m = manifest.load()
    for workload in CELLS:
        for trace_on in (False, True):
            res = run_tiny(workload, trace_on=trace_on, device=cuda_device)
            assert res["correct"], res["checks"]
            assert res["device"]["platform"] == "gpu"
            group = m["per_layer"] if trace_on else m["end_to_end"]
            assert set(res["metrics"]) == {
                e["name"] for e in group
                if workload in e.get("workloads", [workload])}
            assert all(np.isfinite(v["value"])
                       for v in res["metrics"].values())
            if trace_on:
                assert res["device"]["busy_s"] > 0
            roof = res["metrics"].get("hop_roofline_pct")
            if roof is not None:
                assert 0 < roof["value"] <= 100
