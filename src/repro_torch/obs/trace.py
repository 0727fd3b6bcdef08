"""Fenced trace spans — a Chrome-trace-event (Perfetto) emitter
(``repro/obs/trace.py``).

CUDA launches are asynchronous: ``time.time()`` around a call that
launches kernels measures the launches, and the device work silently
leaks into whichever span blocks next.  A span closes only after its
outputs are computed on their devices:

    tr = Tracer()
    with tr.span("inference") as sp:
        a, logp, v = sample(params, obs)
        sp.fence((a, logp, v))      # span closes AFTER the compute
    with tr.span("env_step"):
        out = pool.step(a, ids)     # host-blocking: no fence needed

    tr.totals()                     # {"inference": 1.2, ...} seconds
    tr.dump("trace.json")           # open in chrome://tracing / Perfetto

Spans nest (they are plain context managers); every span records one
complete ("ph": "X") Chrome trace event with microsecond timestamps.
Buffers are per-thread (a ``threading.local`` list registered under the
thread id), so the thread/subprocess engines' worker threads can trace
without locking each other on the hot path — the merge happens at
``dump()``/``events()`` time.  ``totals()`` aggregates wall seconds per
span name across all threads: exactly the paper's Fig-4 buckets when
the spans are named ``env_step``/``inference``/``train``/``other``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable

import torch

from repro_torch.utils.tree import tree_leaves_with_path


def _fence(payload: Any) -> None:
    """Block until every tensor in ``payload`` (a tree of tensors,
    ``utils/tree.py``) is computed: one ``torch.cuda.synchronize`` per
    CUDA device the tensors live on.  CPU tensors and other values are
    ready already."""
    devices = {leaf.device for _, leaf in tree_leaves_with_path(payload)
               if leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class Span:
    """One open span.  ``fence(x)`` registers outputs the span must
    block on before closing (the Fig-4 bucket discipline)."""

    __slots__ = ("_payload",)

    def __init__(self) -> None:
        self._payload: Any = None

    def fence(self, payload: Any) -> Any:
        self._payload = payload
        return payload


class _SpanCtx:
    __slots__ = ("_tracer", "_name", "_cat", "_payload", "_span", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 fence: Any) -> None:
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._payload = fence
        self._span: Span | None = None
        self._t0 = 0.0

    def __enter__(self) -> Span:
        self._span = Span()
        self._t0 = self._tracer._clock()
        return self._span

    def __exit__(self, exc_type, exc, tb) -> None:
        payload = self._span._payload
        if payload is None:
            payload = self._payload
        if payload is not None and exc_type is None:
            _fence(payload)
        self._tracer._close(self._name, self._cat, self._t0,
                            self._tracer._clock())


class Tracer:
    """Per-thread span buffers + one merged Chrome-trace export."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._epoch = clock()
        self._lock = threading.Lock()
        self._local = threading.local()
        # tid -> event list; threads only ever append to their own list
        self._buffers: dict[int, list[tuple]] = {}
        self._totals: dict[str, float] = {}

    # ------------------------------------------------------------------ #
    def span(self, name: str, cat: str = "engine",
             fence: Any = None) -> _SpanCtx:
        """Context manager for one fenced span.  ``fence`` (or a later
        ``sp.fence(...)`` call on the yielded handle) supplies the
        outputs to wait for before the span closes; omit it for
        host-blocking work."""
        return _SpanCtx(self, name, cat, fence)

    def _buf(self) -> list[tuple]:
        buf = getattr(self._local, "buf", None)
        if buf is None:
            buf = self._local.buf = []
            with self._lock:
                self._buffers[threading.get_ident()] = buf
        return buf

    def _close(self, name: str, cat: str, t0: float, t1: float) -> None:
        self._buf().append((name, cat, t0, t1, threading.get_ident()))
        with self._lock:
            self._totals[name] = self._totals.get(name, 0.0) + (t1 - t0)

    def instant(self, name: str, cat: str = "engine") -> None:
        """Zero-duration marker event."""
        t = self._clock()
        self._buf().append((name, cat, t, t, threading.get_ident()))

    # ------------------------------------------------------------------ #
    def totals(self) -> dict[str, float]:
        """Aggregate wall seconds per span name (all threads) — the
        Fig-4 profile buckets."""
        with self._lock:
            return dict(self._totals)

    def events(self) -> list[dict]:
        """All spans as Chrome trace events (complete "X" events,
        microsecond timestamps relative to tracer creation)."""
        with self._lock:
            buffers = list(self._buffers.items())
        pid = os.getpid()
        out = []
        for tid, buf in buffers:
            for name, cat, t0, t1, _ in list(buf):
                out.append({
                    "name": name,
                    "cat": cat,
                    "ph": "X",
                    "ts": (t0 - self._epoch) * 1e6,
                    "dur": (t1 - t0) * 1e6,
                    "pid": pid,
                    "tid": tid,
                })
        out.sort(key=lambda e: e["ts"])
        return out

    def dump(self, path: str = "trace.json") -> str:
        """Write the Chrome trace JSON (open in chrome://tracing or
        https://ui.perfetto.dev)."""
        payload = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
        }
        with open(path, "w") as f:
            json.dump(payload, f)
            f.write("\n")
        return path


__all__ = ["Span", "Tracer"]
