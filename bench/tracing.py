"""What a ``--trace 1`` run reads inside the program and on the device.

``Observer`` records, from the benchmark's own code around the calls into
each layer: per query batch, the program's ``SearchResult`` counts (hops,
distance computations; read by wrapping the name ``StreamingIndex`` calls,
``repro_torch.core.index.search``) and the kernel launch counters
(``repro_torch.kernels.ops.launch_counts``); over the window, the write
phase's seconds (``repro_torch.core.batched.PHASE_SECONDS``).  A name the
program no longer has leaves its readings empty, and the metrics that need
them are left out.

``profile`` runs a stretch of the traffic under ``torch.profiler`` and
reduces its trace to device intervals, host spans and the breakdown.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Optional

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _launches() -> Optional[dict]:
    try:
        from repro_torch.kernels.ops import launch_counts
    except ImportError:
        return None
    return dict(launch_counts())


class Observer:
    """Counters and spans of a traced run (see the module docstring)."""

    def __init__(self):
        self.queries = []        # one dict per query batch
        self.profiling = False
        self._last = None
        self._index_mod = None
        try:
            import repro_torch.core.index as index_mod
        except ImportError:
            return
        if hasattr(index_mod, "search"):
            self._index_mod = index_mod
            self._orig = index_mod.search
            index_mod.search = self._search

    def _search(self, *args, **kwargs):
        ext, dists, res = self._orig(*args, **kwargs)
        self._last = res
        return ext, dists, res

    def close(self) -> None:
        if self._index_mod is not None:
            self._index_mod.search = self._orig
            self._index_mod = None

    @staticmethod
    def write_seconds() -> Optional[float]:
        try:
            from repro_torch.core.batched import PHASE_SECONDS
        except ImportError:
            return None
        return PHASE_SECONDS.get("write")

    def span(self, name: str):
        if not self.profiling:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    @contextlib.contextmanager
    def query_span(self, phase: str):
        before = _launches()
        self._last = None
        with self.span("bench.query"):
            yield
        after = _launches()
        res = self._last
        rec = {"phase": phase, "hops": None, "comps": None, "n": None,
               "launches": None}
        if res is not None and hasattr(res, "n_hops"):
            rec["hops"] = float(res.n_hops.sum())
            rec["comps"] = float(res.n_comps.sum())
            rec["n"] = int(res.n_hops.numel())
        if before is not None and after is not None:
            rec["launches"] = {k: after[k] - before.get(k, 0) for k in after}
        self.queries.append(rec)


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merge (start, end) rows into disjoint sorted intervals."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [iv[0].copy()]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append(np.array([s, e]))
    return np.array(out)


def _clip_total(iv: np.ndarray, spans: np.ndarray) -> float:
    """Length of the disjoint intervals ``iv`` inside the disjoint
    ``spans``."""
    total = 0.0
    j = 0
    for s, e in spans:
        while j < len(iv) and iv[j, 1] <= s:
            j += 1
        k = j
        while k < len(iv) and iv[k, 0] < e:
            total += min(e, iv[k, 1]) - max(s, iv[k, 0])
            k += 1
    return total


class TraceSummary:
    """The reduction of one profiled stretch; times in seconds."""

    def __init__(self, events: list):
        ann = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "user_annotation"]
        win = [e for e in ann if e["name"] == "bench.window"]
        if not win:
            raise RuntimeError("the trace holds no bench.window span")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS and float(e["ts"]) < w1
               and float(e["ts"]) + float(e["dur"]) > w0]
        iv = np.array([[max(w0, float(e["ts"])),
                        min(w1, float(e["ts"]) + float(e["dur"]))]
                       for e in dev]).reshape(-1, 2)
        self.busy = _union(iv)
        self.busy_s = float((self.busy[:, 1] - self.busy[:, 0]).sum()) * 1e-6
        by_name: dict = {}
        for e in dev:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
        self.device_ops = sorted(((k, v * 1e-6) for k, v in by_name.items()),
                                 key=lambda kv: -kv[1])
        spans: dict = {}
        for e in ann:
            if e["name"].startswith("bench.") and e["name"] != "bench.window":
                spans.setdefault(e["name"], []).append(
                    [float(e["ts"]), float(e["ts"]) + float(e["dur"])])
        self.spans = {k: _union(np.array(v)) for k, v in spans.items()}
        self.span_busy_s = {k: _clip_total(self.busy, v) * 1e-6
                            for k, v in self.spans.items()}
        self.idle_gaps = self._idle_by_host(events, w0, w1)

    def _idle_by_host(self, events, w0, w1) -> list:
        """Idle device time by what the host was doing: the benchmark span
        and the innermost host operation at the middle of each gap."""
        edges = np.concatenate([[w0], self.busy.reshape(-1), [w1]])
        gaps = edges.reshape(-1, 2)
        gaps = gaps[gaps[:, 1] > gaps[:, 0]]
        ops = sorted((e for e in events if e.get("ph") == "X"
                      and e.get("cat") == "cpu_op"),
                     key=lambda e: float(e["ts"]))
        starts = np.array([float(e["ts"]) for e in ops])
        ends = np.array([float(e["ts"]) + float(e["dur"]) for e in ops])
        total: dict = {}
        for s, e in gaps:
            mid = 0.5 * (s + e)
            span = "host"
            for name, iv in self.spans.items():
                i = int(np.searchsorted(iv[:, 0], mid, side="right")) - 1
                if i >= 0 and iv[i, 1] >= mid:
                    span = name
                    break
            op = "python"
            i = int(np.searchsorted(starts, mid, side="right")) - 1
            for j in range(i, max(-1, i - 32), -1):
                if ends[j] >= mid:
                    op = ops[j]["name"]
                    break
            key = f"{span}:{op}"
            total[key] = total.get(key, 0.0) + (e - s) * 1e-6
        return sorted(total.items(), key=lambda kv: -kv[1])

    def idle_pct(self):
        """Percent of the stretch with no device operation; None for an
        empty stretch."""
        if self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> dict:
        return {"device_ops": [[k, v] for k, v in self.device_ops[:10]],
                "idle_gaps": [[k, v] for k, v in self.idle_gaps[:10]]}


def profile(run, device) -> TraceSummary:
    """Run ``run()`` under ``torch.profiler`` inside a ``bench.window``
    span and reduce the trace.  The trace file lives in a temporary
    directory (under ``TMPDIR``) and is removed."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with record_function("bench.window"):
            run()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return TraceSummary(events)
