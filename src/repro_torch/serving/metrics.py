"""Serving metrics (``repro/serving/metrics.py``): per-request lifecycle
timestamps, queue depth, batch fill and latency percentiles.

  * the **enqueue -> dispatch -> complete** timestamps live on each
    ``QueryRequest`` (the batcher stamps admission, the front door stamps
    dispatch and completion); this object aggregates them into wait,
    service and latency distributions;
  * **queue depth** is sampled at every dispatch (the depth left behind);
  * **batch fill** (real lanes over padded lanes) prices the deadline: a
    low fill means mostly-empty buckets, a fill pinned at 1.0 means the
    arrivals saturate ``max_bucket`` and queueing delay builds;
  * latency quantiles are exact empirical percentiles (``percentile``).

``stats()`` returns the reference's flat dict, key for key and value for
value for the same records; ``log_line()`` is the launcher's periodic
line.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


def percentile(xs, q: float) -> float:
    """Exact empirical percentile (linear interpolation); NaN on empty."""
    if len(xs) == 0:
        return float("nan")
    return float(np.percentile(np.asarray(xs, np.float64), q))


@dataclasses.dataclass
class ServingMetrics:
    """Aggregated serving-side accounting for one front door."""

    # per-request samples (seconds)
    latencies: List[float] = dataclasses.field(default_factory=list)
    waits: List[float] = dataclasses.field(default_factory=list)
    # per-dispatch samples
    services: List[float] = dataclasses.field(default_factory=list)
    fills: List[float] = dataclasses.field(default_factory=list)
    depths: List[int] = dataclasses.field(default_factory=list)
    # counters
    n_queries: int = 0
    n_dispatches: int = 0
    n_updates: int = 0          # update batches applied
    n_update_lanes: int = 0     # applied lanes across those batches
    n_publishes: int = 0
    # accumulated service time per phase (seconds)
    search_s: float = 0.0
    update_s: float = 0.0
    publish_s: float = 0.0

    def record_dispatch(self, dispatch, service_s: float,
                        depth_after: int) -> None:
        """Book one completed search batch: its service time, fill and the
        queue depth it left behind, plus every rider's wait and latency."""
        self.n_dispatches += 1
        self.services.append(float(service_s))
        self.search_s += float(service_s)
        self.fills.append(dispatch.fill)
        self.depths.append(int(depth_after))
        for req in dispatch.requests:
            self.n_queries += 1
            self.waits.append(req.wait_s)
            self.latencies.append(req.latency_s)

    def record_update(self, n_lanes: int, service_s: float) -> None:
        self.n_updates += 1
        self.n_update_lanes += int(n_lanes)
        self.update_s += float(service_s)

    def record_publish(self, service_s: float) -> None:
        self.n_publishes += 1
        self.publish_s += float(service_s)

    def stats(self, horizon_s: Optional[float] = None) -> dict:
        """One flat dict of everything (times in ms; rates per second over
        ``horizon_s`` when given, else over summed service time)."""
        lat = np.asarray(self.latencies, np.float64)
        span = horizon_s if horizon_s else (
            self.search_s + self.update_s + self.publish_s
        )
        span = max(span, 1e-9)
        return {
            "n_queries": self.n_queries,
            "n_dispatches": self.n_dispatches,
            "n_updates": self.n_updates,
            "n_publishes": self.n_publishes,
            "p50_ms": percentile(lat, 50) * 1e3,
            "p95_ms": percentile(lat, 95) * 1e3,
            "p99_ms": percentile(lat, 99) * 1e3,
            "mean_ms": float(lat.mean()) * 1e3 if lat.size else float("nan"),
            "mean_wait_ms": (
                float(np.mean(self.waits)) * 1e3 if self.waits
                else float("nan")
            ),
            "mean_service_ms": (
                float(np.mean(self.services)) * 1e3 if self.services
                else float("nan")
            ),
            "qps": self.n_queries / span,
            "updates_per_s": self.n_update_lanes / span,
            "batch_fill": (
                float(np.mean(self.fills)) if self.fills else float("nan")
            ),
            "mean_queue_depth": (
                float(np.mean(self.depths)) if self.depths else 0.0
            ),
            "search_s": self.search_s,
            "update_s": self.update_s,
            "publish_s": self.publish_s,
        }

    def log_line(self, horizon_s: Optional[float] = None) -> str:
        """The periodic serving log line."""
        s = self.stats(horizon_s)
        return (
            f"served q={s['n_queries']} "
            f"p50={s['p50_ms']:.2f}ms p99={s['p99_ms']:.2f}ms "
            f"qps={s['qps']:.0f} upd/s={s['updates_per_s']:.0f} "
            f"fill={s['batch_fill']:.2f} depth={s['mean_queue_depth']:.1f} "
            f"phase[search={s['search_s']*1e3:.0f}ms "
            f"update={s['update_s']*1e3:.0f}ms "
            f"publish={s['publish_s']*1e3:.0f}ms]"
        )


__all__ = ["ServingMetrics", "percentile"]
