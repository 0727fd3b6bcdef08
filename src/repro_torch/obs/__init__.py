"""Engine observability (``repro/obs``): the ``Telemetry`` counters on
``PoolState`` behind ``pool.stats()``, the metrics registry every
reporting surface publishes to, and fenced trace spans."""

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    publish_history,
    publish_pool_stats,
    publish_serve_stats,
)
from repro_torch.obs.telemetry import (
    WAIT_EDGES,
    Telemetry,
    init_telemetry,
    snapshot_device,
    stats_to_jsonable,
)
from repro_torch.obs.trace import Span, Tracer

__all__ = [
    "WAIT_EDGES", "Counter", "Gauge", "Histogram", "MetricsRegistry", "Span",
    "Telemetry", "Tracer", "init_telemetry", "publish_history",
    "publish_pool_stats", "publish_serve_stats", "snapshot_device",
    "stats_to_jsonable",
]
