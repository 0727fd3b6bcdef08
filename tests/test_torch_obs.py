"""The port's copies of ``obs/metrics.py`` and ``obs/trace.py`` against
the JAX package's: the same calls give the same registry snapshot, and
the tracer's spans, totals and Chrome-trace export behave alike.  The
port's span fence waits for CUDA tensors with ``torch.cuda.synchronize``
and passes CPU tensors and plain values through."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch.obs import metrics, trace  # noqa: E402
from repro_torch.serving.decode_pool import ServeStats  # noqa: E402


def feed(m, stats):
    reg = m.MetricsRegistry()
    reg.counter("c", "help").inc(3, lane="a")
    reg.counter("c").inc(2, lane="a")
    reg.gauge("g").set(1.5)
    h = reg.histogram("h", [0, 1, 4])
    for x in (0, 0.5, 2, 9):
        h.observe(x, kind="x")
    h.observe_counts([1, 0, 2], kind="x")
    m.publish_serve_stats(reg, stats, schedule="fifo")
    return reg


def test_registry_snapshot_matches_repro():
    stats = ServeStats(requests=4, total_tokens=30, decode_steps=9,
                       lane_slots=36, wall_s=0.25)
    assert feed(metrics, stats).snapshot() == feed(jmetrics, stats).snapshot()
    with pytest.raises(TypeError):
        feed(metrics, stats).gauge("c")
    with pytest.raises(ValueError):
        metrics.MetricsRegistry().counter("c").inc(-1)


def test_tracer_spans_fence_and_dump(tmp_path):
    ticks = iter(np.arange(0.0, 10.0, 0.5))
    tr = trace.Tracer(clock=lambda: float(next(ticks)))
    x = torch.ones(3)
    with tr.span("outer", fence={"x": x, "n": 3}):
        with tr.span("inner") as sp:
            assert sp.fence(x) is x
    tr.instant("mark")
    assert tr.totals() == {"inner": 0.5, "outer": 1.5}
    names = [e["name"] for e in tr.events()]
    assert sorted(names) == ["inner", "mark", "outer"]
    path = tr.dump(str(tmp_path / "trace.json"))
    with open(path) as f:
        assert len(json.load(f)["traceEvents"]) == 3
