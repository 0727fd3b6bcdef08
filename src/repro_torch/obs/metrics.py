"""Unified metrics registry — counters / gauges / fixed-bucket
histograms with labeled series, JSON snapshot/export
(``repro/obs/metrics.py``).

One process-local sink the reporting surfaces feed: the pool's
``stats()`` (``publish_pool_stats``), ``DecodePool``'s ``ServeStats``
(``publish_serve_stats``) and the PPO history records
(``publish_history``).

Design notes:

  * a *series* is (metric name, frozen label set) — the Prometheus data
    model, scoped to one process and exported as JSON rather than
    scraped;
  * histograms have FIXED bucket edges declared at creation (the
    telemetry ``WAIT_EDGES`` discipline): ``observe`` bins one value,
    ``observe_counts`` merges a pre-bucketed count vector (how the
    engines' in-graph histograms land here without re-binning);
  * everything is plain Python + numpy, and thread-safe (one lock per
    registry; the pipelined PPO loop reports from two threads).
"""

from __future__ import annotations

import json
import threading
from typing import Any, Iterable

import numpy as np


def _label_key(labels: dict[str, Any]) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Shared series bookkeeping for one named metric."""

    kind = "metric"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: dict[tuple, Any] = {}
        self._lock = threading.Lock()

    def _labels_of(self, key: tuple) -> dict[str, str]:
        return dict(key)

    def series(self) -> list[dict]:
        with self._lock:
            return [
                {"labels": self._labels_of(k), "value": v}
                for k, v in sorted(self._series.items())
            ]


class Counter(_Metric):
    """Monotonically increasing per-series count."""

    kind = "counter"

    def inc(self, value: float = 1, **labels: Any) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + value

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0)


class Gauge(_Metric):
    """Last-written per-series value."""

    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        with self._lock:
            self._series[_label_key(labels)] = value

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0)


class Histogram(_Metric):
    """Fixed-edge bucket counts: bucket ``b`` counts observations in
    ``[edges[b], edges[b+1])``; the last bucket is open-ended."""

    kind = "histogram"

    def __init__(self, name: str, edges: Iterable[float], help: str = ""):
        super().__init__(name, help)
        self.edges = tuple(float(e) for e in edges)
        if len(self.edges) < 1 or list(self.edges) != sorted(self.edges):
            raise ValueError(f"histogram {name}: edges must be sorted")

    def _new(self) -> np.ndarray:
        return np.zeros(len(self.edges), np.int64)

    def observe(self, value: float, **labels: Any) -> None:
        b = int(np.sum(float(value) >= np.asarray(self.edges[1:]))) \
            if len(self.edges) > 1 else 0
        key = _label_key(labels)
        with self._lock:
            counts = self._series.setdefault(key, self._new())
            counts[b] += 1

    def observe_counts(self, counts: Iterable[int], **labels: Any) -> None:
        """Merge a pre-bucketed count vector (same edges — how the
        engines' in-graph ``wait_hist`` lands without re-binning)."""
        add = np.asarray(list(counts), np.int64)
        if add.shape != (len(self.edges),):
            raise ValueError(
                f"histogram {self.name}: expected {len(self.edges)} "
                f"bucket counts, got {add.shape}"
            )
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.setdefault(
                key, self._new()
            ) + add

    def counts(self, **labels: Any) -> np.ndarray:
        with self._lock:
            return np.array(
                self._series.get(_label_key(labels), self._new())
            )

    def series(self) -> list[dict]:
        with self._lock:
            return [
                {
                    "labels": self._labels_of(k),
                    "value": np.asarray(v).tolist(),
                    "edges": list(self.edges),
                }
                for k, v in sorted(self._series.items())
            ]


class MetricsRegistry:
    """Get-or-create metric registry with one JSON export surface."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, *args, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, *args, **kwargs)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, edges: Iterable[float],
                  help: str = "") -> Histogram:
        h = self._get(Histogram, name, edges, help)
        if tuple(float(e) for e in edges) != h.edges:
            raise ValueError(
                f"histogram {name!r} already registered with edges "
                f"{h.edges}"
            )
        return h

    def snapshot(self) -> dict:
        """One JSON-safe dict of every metric's every series."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {
            m.name: {"type": m.kind, "help": m.help, "series": m.series()}
            for m in sorted(metrics, key=lambda m: m.name)
        }

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")
        return path


# --------------------------------------------------------------------- #
# reporting adapters — the one vocabulary every surface publishes in
# --------------------------------------------------------------------- #
def publish_pool_stats(registry: MetricsRegistry, stats: dict,
                       **labels: Any) -> None:
    """Feed one ``pool.stats()`` snapshot (``obs/telemetry.py``) into the
    registry.  A snapshot is cumulative already, so its counts land as
    gauges: publishing again overwrites rather than double-counts."""
    for k in ("recvs", "served", "stepped", "cost_sum",
              "overdue_admits", "wait_ticks_total"):
        registry.gauge(f"pool_{k}").set(int(stats[k]), **labels)
    registry.gauge("pool_occupancy").set(float(stats["occupancy"]),
                                         **labels)
    registry.histogram(
        "pool_wait_ticks", stats["wait_edges"],
        help="recv-ticks served results waited (fixed WAIT_EDGES)",
    ).observe_counts(np.asarray(stats["wait_hist"]).tolist(), **labels)


def publish_serve_stats(registry: MetricsRegistry, stats: Any,
                        **labels: Any) -> None:
    """Publish a ``DecodePool.ServeStats`` (cumulative counters +
    derived gauges)."""
    registry.counter("decode_requests").inc(stats.requests, **labels)
    registry.counter("decode_tokens").inc(stats.total_tokens, **labels)
    registry.counter("decode_steps").inc(stats.decode_steps, **labels)
    registry.counter("decode_lane_slots").inc(stats.lane_slots, **labels)
    registry.counter("decode_wall_s").inc(stats.wall_s, **labels)
    registry.gauge("decode_utilization").set(stats.utilization, **labels)
    registry.gauge("decode_tokens_per_s").set(stats.tokens_per_s, **labels)


def publish_history(registry: MetricsRegistry, rec: dict,
                    **labels: Any) -> None:
    """Publish one PPO history record (``rl/ppo.py::_record``): scalar
    fields as ``ppo_<key>`` gauges plus an iteration counter."""
    registry.counter("ppo_iterations").inc(1, **labels)
    for k, v in rec.items():
        if isinstance(v, (int, float, np.integer, np.floating)):
            registry.gauge(f"ppo_{k}").set(float(v), **labels)


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "publish_history",
    "publish_pool_stats",
    "publish_serve_stats",
]
