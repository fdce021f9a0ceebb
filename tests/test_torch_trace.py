"""``repro_torch.trace``: the spans and the host-synchronisation counter of
the update and search engines.

The CPU tests drive a tiny ``StreamingIndex`` built as the benchmark's
loader builds its index (``batch_updates=True``, past the serial bootstrap,
so inserts and deletes take ``core/batched.py``) through one insert of 10,
one delete of 10 and one query batch, with tracing off and on.

The card case (``python -m pytest -s --noconftest -m requires_cuda
tests/test_torch_trace.py``) holds each request's count to the reports of
``torch.cuda.set_sync_debug_mode("warn")`` made while it ran, plus the
explicit ``torch.cuda.synchronize`` calls, at each benchmark cell's shapes,
and prints both counts.
"""
from __future__ import annotations

import collections
import json
import sys
import tempfile
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import cuda_device  # noqa: F401

from repro_torch import trace
from repro_torch.core import batched
from repro_torch.core.api import clone_state
from repro_torch.core.index import StreamingIndex
from repro_torch.core.types import ANNConfig

ROOT = Path(__file__).resolve().parents[1]
DIM = 16
N_BASE = 160
ROOTS = ("repro_torch.index.insert", "repro_torch.index.delete",
         "repro_torch.index.search")
SPANS = ROOTS + (
    "repro_torch.update.search", "repro_torch.update.write",
    "repro_torch.update.prune", "repro_torch.update.append",
    "repro_torch.update.repair", "repro_torch.search.upload",
    "repro_torch.search.hop_loop", "repro_torch.search.finish",
    "repro_torch.search.download")


@pytest.fixture(autouse=True)
def _tracing_restored():
    """Every test starts and ends with tracing off and an empty table."""
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def _cfg() -> ANNConfig:
    return ANNConfig(dim=DIM, n_cap=512, r=12, l_build=16, l_search=24,
                     l_delete=24, k_delete=12, n_copies=3, alpha=1.2)


def _data() -> np.ndarray:
    return np.random.default_rng(11).standard_normal(
        (N_BASE + 64, DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def base():
    """A handle past the serial bootstrap (2 * l_build live points)."""
    idx = StreamingIndex(_cfg(), batch_updates=True, device="cpu")
    idx.insert(np.arange(N_BASE), _data()[:N_BASE])
    assert idx.n_active > 2 * idx.cfg.l_build
    return idx


def _fresh(base) -> StreamingIndex:
    idx = StreamingIndex(base.cfg, batch_updates=True, device="cpu")
    idx.istate = clone_state(base.istate)
    return idx


def _drive(idx):
    """One insert of 10, one delete of 10, one query batch; returns the
    answers."""
    x = _data()
    idx.insert(np.arange(N_BASE, N_BASE + 10), x[N_BASE:N_BASE + 10])
    idx.delete(np.arange(10))
    return idx.search(x[N_BASE + 20:N_BASE + 52], k=5)


def _traced(base):
    trace.enable(True)
    answers = _drive(_fresh(base))
    trace.enable(False)
    return answers, trace.totals()


@pytest.fixture(scope="module")
def traced_totals(base):
    trace.enable(False)
    trace.reset()
    _, tot = _traced(base)
    trace.reset()
    return tot


def test_off_leaves_no_trace(base):
    _drive(_fresh(base))
    assert trace.totals() == {}
    assert trace.span("a") is trace.span("b") is trace.request("c")


@pytest.mark.parametrize("name", SPANS)
def test_every_span_is_booked(traced_totals, name):
    row = traced_totals[name]
    assert row["calls"] >= 1
    assert 0.0 <= row["self_s"] <= row["incl_s"] + 1e-9
    assert row["host_syncs"] >= 0


@pytest.mark.parametrize("on", [False, True])
def test_phase_seconds_hold_the_phase_spans(base, on):
    """``PHASE_SECONDS`` advances whether or not the program traces, and
    each phase span lies inside its phase's clock."""
    phase = dict(batched.PHASE_SECONDS)
    trace.enable(on)
    _drive(_fresh(base))
    trace.enable(False)
    tot = trace.totals()
    for key in ("search", "write"):
        got = batched.PHASE_SECONDS[key] - phase[key]
        assert got > 0
        if on:
            assert tot[f"repro_torch.update.{key}"]["incl_s"] <= got
        else:
            assert tot == {}


def _profiled(base) -> list:
    """The annotations of one traced drive under a CPU profiler that
    records shapes (so that the annotations' arguments are exported)."""
    from torch.profiler import ProfilerActivity, profile

    trace.enable(True)
    idx = _fresh(base)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        _drive(idx)
    trace.enable(False)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trace.json")
        p.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ann = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"
           and e["name"].startswith("repro_torch.")]
    for e in ann:
        e["t0"] = float(e["ts"])
        e["t1"] = float(e["ts"]) + float(e["dur"])
        e["rid"] = int(e["args"]["Concrete Inputs"][0])
    return ann


def _inside(e, outer) -> bool:
    return outer["t0"] <= e["t0"] and e["t1"] <= outer["t1"]


def test_annotations_nest_and_carry_request_ids(base):
    ann = _profiled(base)
    assert {e["name"] for e in ann} == set(SPANS)
    roots = [e for e in ann if e["name"] in ROOTS]
    assert [e["name"] for e in sorted(roots, key=lambda e: e["t0"])] == \
        list(ROOTS)
    rids = [e["rid"] for e in roots]
    assert len(set(rids)) == len(rids) and min(rids) >= 1
    for e in ann:
        if e in roots:
            continue
        owner = [r for r in roots if _inside(e, r)]
        assert len(owner) == 1, e["name"]
        assert e["rid"] == owner[0]["rid"], e["name"]
    # prune under write under the insert: every insert-side prune lies in
    # a write span, which lies in the insert's root
    ins = next(r for r in roots if r["name"] == ROOTS[0])
    writes = [e for e in ann if e["name"] == "repro_torch.update.write"
              and _inside(e, ins)]
    prunes = [e for e in ann if e["name"] == "repro_torch.update.prune"
              and _inside(e, ins)]
    assert writes and prunes
    assert all(any(_inside(p, w) for w in writes) for p in prunes)


def test_tracing_changes_no_answer_and_no_state(base):
    off = _fresh(base)
    a_off = _drive(off)
    trace.enable(True)
    on = _fresh(base)
    a_on = _drive(on)
    trace.enable(False)
    for x, y in zip(a_off, a_on):
        np.testing.assert_array_equal(x, y)
    for f in off.istate._fields:
        x, y = getattr(off.istate, f), getattr(on.istate, f)
        if f == "graph":
            for g in x._fields:
                gx, gy = getattr(x, g), getattr(y, g)
                if isinstance(gx, torch.Tensor):
                    assert torch.equal(gx, gy), g
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f


def test_host_syncs_repeat_exactly(base):
    """Calls and counts repeat (on the CPU nothing synchronises, so the
    counts are 0; the card case holds them to the sync debug mode)."""
    _, first = _traced(base)
    trace.reset()
    _, second = _traced(base)
    assert {k: (v["calls"], v["host_syncs"]) for k, v in first.items()} == \
        {k: (v["calls"], v["host_syncs"]) for k, v in second.items()}


@pytest.mark.parametrize("module,name", [
    ("repro_torch.core.index", "search"),
    ("repro_torch.core.batched", "PHASE_SECONDS"),
    ("repro_torch.kernels.ops", "launch_counts"),
])
def test_names_the_benchmark_reads_exist(module, name):
    import importlib

    assert hasattr(importlib.import_module(module), name)


def _mode_reports():
    """Two warnings as the sync debug mode words them."""
    for _ in range(2):
        warnings.warn(trace.SYNC_WARNING, UserWarning)


def test_host_sync_counts_against_every_open_span():
    trace.enable(True)
    with trace.request("outer"):
        trace.host_sync()
        with trace.span("inner"):
            _mode_reports()
    trace.host_sync()            # outside every span: in no row
    tot = trace.totals()
    assert tot["outer"]["host_syncs"] == 3
    assert tot["inner"]["host_syncs"] == 2
    tot["outer"]["calls"] = 99   # a copy
    assert trace.totals()["outer"]["calls"] == 1


def test_counting_leaves_other_warnings_and_restores_the_hook():
    shown = warnings.showwarning
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        trace.enable(True)
        with trace.request("outer"):
            _mode_reports()
            warnings.warn("another warning", UserWarning)
        trace.enable(False)
        _mode_reports()          # tracing off: shown, not counted
    assert trace.totals()["outer"]["host_syncs"] == 2
    assert [str(w.message) for w in seen] == \
        ["another warning"] + [trace.SYNC_WARNING] * 2
    assert warnings.showwarning is shown


def test_enable_sets_the_sync_debug_mode_and_restores_it(monkeypatch):
    """Where CUDA is present, tracing turns the mode on and puts the old
    mode back; the mode's own notice, given while it is being turned on,
    is passed on."""
    modes = [0]

    def set_mode(mode):
        warnings.warn("Synchronization debug mode is a prototype feature",
                      UserWarning)
        modes.append({"warn": 1}.get(mode, mode))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        trace.enable(True)
        assert modes[-1] == 1
        trace.enable(False)
    assert modes == [0, 1, 0]
    assert len(seen) == 2 and "prototype" in str(seen[0].message)


# ---------------------------------------------------------------------------
# the card: the counter against the sync debug mode, at the cells' shapes
# ---------------------------------------------------------------------------

CELLS = ("msturing100-hr.runbook", "cohere768-int8-hr.query")


def _cell_index(workload: str, device, n_live: int = 20_000):
    """The cell's configuration (dimension, degree, beams, metric, tier)
    on a starting graph of ``n_live`` points built as the benchmark builds
    it, and the cell's traffic."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench import datagen, graph, harness, loader, manifest

    _, cfg, tr = harness.cell_files(manifest.load(), workload)
    cfg = dict(cfg, n_live=n_live, n_cap=2 * n_live)
    # rows enough for three inserts of 10 and one query batch
    tr = dict(tr, query_pool_batches=-(-40 // int(tr["query_batch"])),
              max_update_steps=0)
    inputs = datagen.make_inputs(cfg, tr, 2 ** 31 + 5, device)
    b = cfg["builder"]
    base = inputs.table[:n_live]
    adj, start = graph.build_graph(
        base, metric=cfg["metric"], r=int(cfg["r"]), alpha=float(cfg["alpha"]),
        knn=int(b["knn"]), in_edges=int(b["in_edges"]),
        long_edges=int(b["long_edges"]), cells=int(b["cells"]),
        gen=datagen.generator(7, device, stream=1))
    state = loader.numpy_state(cfg, base, adj, start,
                               loader.max_external_id(cfg))
    idx = loader.load_index(cfg, state, device)
    return idx, tr, inputs.queries.reshape(-1, int(cfg["dim"])).cpu().numpy()


def _counted(call):
    """``call()``: ``(program syncs by root, the sync debug mode's reports
    by site as the warnings hook saw them, torch.cuda.synchronize calls by
    caller ("explicit", "trace" from repro_torch.trace, "batched" from
    under core/batched.py))``."""
    real = torch.cuda.synchronize
    calls = collections.Counter()
    sites = collections.Counter()
    hook = warnings.showwarning

    def sync(*a, **k):
        f = sys._getframe(1)
        calls["trace" if f.f_globals.get("__name__") == "repro_torch.trace"
              else "explicit"] += 1
        while f is not None:
            if f.f_globals.get("__name__") == "repro_torch.core.batched":
                calls["batched"] += 1
                break
            f = f.f_back
        return real(*a, **k)

    def tee(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(trace.SYNC_WARNING):
            sites[f"{Path(filename).name}:{lineno}"] += 1
        hook(message, category, filename, lineno, file, line)

    before = trace.totals()
    torch.cuda.synchronize()
    torch.cuda.synchronize = sync
    warnings.showwarning = tee
    try:
        call()
    finally:
        torch.cuda.synchronize = real
        warnings.showwarning = hook
    after = trace.totals()
    program = {r: after.get(r, {}).get("host_syncs", 0)
               - before.get(r, {}).get("host_syncs", 0) for r in ROOTS}
    return program, sites, calls


def _mode_reports_synchronize() -> bool:
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return any(str(x.message).startswith(trace.SYNC_WARNING) for x in w)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", CELLS)
def test_host_syncs_match_the_sync_debug_mode(cuda_device, workload):
    idx, tr, queries = _cell_index(workload, cuda_device)
    n = idx.n_active
    k, l, qb = int(tr["k"]), int(tr["l"]), int(tr["query_batch"])

    def ops(i):
        """Pass ``i``: an insert of 10 new ids, a delete of 10 live ones,
        one query batch."""
        new = np.arange(n + 10 * i, n + 10 * i + 10)
        return {
            "repro_torch.index.insert":
                lambda: idx.insert(new, queries[10 * i:10 * i + 10]),
            "repro_torch.index.delete":
                lambda: idx.delete(np.arange(10 * i, 10 * i + 10)),
            "repro_torch.index.search":
                lambda: idx.search(queries[:qb], k=k, l=l),
        }

    # warm: every kernel built and every shape seen once
    trace.enable(False)
    for op in ops(0).values():
        op()
    # the counter marks torch.cuda.synchronize by hand, as the mode does
    # not report it
    assert not _mode_reports_synchronize()

    off_calls = _counted(lambda: [op() for op in ops(1).values()])[2]
    assert off_calls["trace"] == 0

    trace.enable(True)
    rows, wrong, on_batched = {}, [], 0
    for root, op in ops(2).items():
        program, sites, calls = _counted(op)
        n_mode = sum(sites.values())
        expected = n_mode + calls["explicit"]
        rows[root] = {"host_syncs": program[root], "mode": n_mode,
                      "explicit_synchronize": calls["explicit"]}
        if program[root] != expected:
            wrong.append(f"{root}: counted {program[root]}, expected "
                         f"{expected}; mode sites {sorted(sites.items())}")
        assert calls["trace"] == 0
        on_batched += calls["batched"]
    trace.enable(False)
    print(json.dumps({workload: rows}))
    # the phase clock's synchronisations are the same traced or not
    assert on_batched == off_calls["batched"] > 0
    assert not wrong, "\n".join(wrong)
