"""Host tracing: wall-clock timers and a span API with Chrome/perfetto
export.

Counterpart of ``repro/obs/trace.py``.  Instrumented sites (wave bursts,
migrations, checkpoint save/restore, fault LEAVE/JOIN, ServeEngine
submit/refill) call :func:`span`: a context manager that records a
wall-clock interval into the module-level :data:`tracer` and opens a
``torch.profiler.record_function`` range of the same name, where the
reference opens a ``jax.profiler`` annotation, so the span shows in a
``torch.profiler`` trace beside the kernels it encloses.
:meth:`Tracer.export_chrome_trace` writes the recorded spans in the
Chrome trace-event format that ``chrome://tracing`` and
https://ui.perfetto.dev load.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

import torch


# ------------------------------------------------------------- timers ------
class Timer:
    """Cumulative wall-clock timer: ``start()``/``stop()`` append one
    cost per interval; ``elapsed`` aggregates."""

    def __init__(self, name: str):
        self.name = name
        self.costs: list = []
        self._start: Optional[float] = None

    def start(self, sync_fn=None):
        if sync_fn is not None:
            sync_fn()
        self._start = time.perf_counter()
        return self

    def stop(self, sync_fn=None):
        if self._start is None:
            raise RuntimeError(f"timer {self.name!r} stopped before start")
        if sync_fn is not None:
            sync_fn()
        self.costs.append(time.perf_counter() - self._start)
        self._start = None
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    @property
    def count(self) -> int:
        return len(self.costs)

    def reset(self):
        self.costs = []
        self._start = None

    def elapsed(self, mode: str = "sum") -> float:
        if not self.costs:
            return 0.0
        if mode == "sum":
            return sum(self.costs)
        if mode == "mean":
            return sum(self.costs) / len(self.costs)
        if mode == "min":
            return min(self.costs)
        if mode == "max":
            return max(self.costs)
        if mode == "last":
            return self.costs[-1]
        raise ValueError(f"unknown elapsed mode {mode!r}")


class Timers:
    """Name -> :class:`Timer` registry; ``timers("x").start()``."""

    def __init__(self):
        self._timers: dict = {}

    def __call__(self, name: str) -> Timer:
        if name not in self._timers:
            self._timers[name] = Timer(name)
        return self._timers[name]

    def __contains__(self, name: str) -> bool:
        return name in self._timers

    def names(self) -> list:
        return sorted(self._timers)

    def report(self) -> dict:
        return {n: {"n": len(t.costs), "sum_s": t.elapsed("sum"),
                    "mean_s": t.elapsed("mean")}
                for n, t in sorted(self._timers.items())}


timers = Timers()


# -------------------------------------------------------------- tracer -----
class Tracer:
    """Bounded span recorder with Chrome-trace export.

    Spans nest (the trace viewer stacks same-thread ``X`` events by time
    containment).  The event ring is bounded, so an always-on tracer
    cannot grow without bound.  Each span also opens a
    ``torch.profiler.record_function`` range named ``cat:name``.
    """

    def __init__(self, max_events: int = 65536):
        self._events: deque = deque(maxlen=max_events)
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, cat: str = "repro", **args):
        ts = self._now_us()
        try:
            with torch.profiler.record_function(f"{cat}:{name}"):
                yield self
        finally:
            self._events.append({
                "name": name, "cat": cat, "ph": "X", "ts": ts,
                "dur": self._now_us() - ts, "pid": os.getpid(),
                "tid": threading.get_ident() % (1 << 31),
                "args": {k: _jsonable(v) for k, v in args.items()},
            })

    def events(self) -> list:
        return list(self._events)

    def clear(self):
        self._events.clear()

    def export_chrome_trace(self, path) -> str:
        """Write the recorded spans as Chrome trace-event JSON (loads in
        chrome://tracing and ui.perfetto.dev); returns the path."""
        doc = {"traceEvents": self.events(), "displayTimeUnit": "ms"}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
        return str(path)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        return int(v)
    except Exception:
        return str(v)


tracer = Tracer()


@contextmanager
def span(name: str, cat: str = "repro", **args):
    """Record a span on the module-level :data:`tracer` (the instrumented
    wave, migration, checkpoint, fault and serving sites all funnel
    through here)."""
    with tracer.span(name, cat, **args):
        yield tracer
