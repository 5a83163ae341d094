"""Host tracing: spans on the profiler's clock, with Chrome/perfetto
export.

Counterpart of ``repro/obs/trace.py``.  Two levels of span:

* **Burst-level spans** (:func:`span`): wave bursts, migrations and
  their stages, checkpoint save/restore, fault LEAVE/JOIN, ServeEngine
  submit/refill.  Each is always recorded into the module-level
  :data:`tracer`'s bounded ring.
* **Detail spans** (:meth:`Tracer.detail_span`): the wave engine's
  per-wave stages (``dispatch``, ``exchange``, ``commit``).  With the
  tracer's ``detail`` switch on, one is recorded into the ring like a
  burst-level span.  With the switch off, it is only a profiler range
  while a ``torch.profiler`` records (the profiler's trace holds it, so
  the ring would hold a second copy at a second cost), and otherwise
  the site costs a flag read, builds no args and appends nothing.

Any span opens a profiler range named ``cat:name`` only while a
profiler records, so the span shows in the profiler's trace beside the
kernels it encloses and costs no range otherwise.  The range is the one
``record_function`` makes, entered through the profiler's own C entry
points at about a third of ``record_function``'s host cost.  Every event carries its ``id`` and the ``parent`` id of the
span open around it on the same thread.  A span yields a :class:`Span`
handle whose ``args`` can be set until it closes.

Timestamps are Unix-epoch microseconds, the clock of the profiler's
Chrome trace (its ``ts`` plus ``baseTimeNanoseconds`` / 1,000), taken
from one ``time_ns`` / ``perf_counter_ns`` anchor so that durations stay
monotonic.  :meth:`Tracer.export_chrome_trace` writes relative ``ts`` and
``baseTimeNanoseconds`` as the profiler's file does; exported with the
profiler's base, merging the two files is a concatenation of their
``traceEvents``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager

import torch


def profiler_recording() -> bool:
    """Whether a ``torch.profiler`` (or the autograd profiler) records on
    this process: the profiler state PyTorch's C extension reports."""
    return torch.autograd._profiler_enabled()


class _Range:
    """A profiler range (``user_annotation``, as ``record_function``
    makes) around a ``with`` block."""

    __slots__ = ("name", "handle")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(
            self.name)

    def __exit__(self, *exc):
        torch.autograd._record_function_with_args_exit(self.handle)


class Span:
    """An open span: its ``id`` and the ``args`` it records at close."""

    __slots__ = ("id", "args")

    def __init__(self, sid: int, args: dict):
        self.id, self.args = sid, args

    def set(self, **args) -> None:
        """Record ``args`` when the span closes (later values win)."""
        self.args.update(args)


_OFF = contextlib.nullcontext()

# the process id, read once and again in a forked child: ``os.getpid`` is
# a system call on every read, and under a user-space kernel one took
# hundreds of microseconds while the card was busy
_pid = os.getpid()


def _refresh_pid() -> None:
    global _pid
    _pid = os.getpid()


os.register_at_fork(after_in_child=_refresh_pid)


class Tracer:
    """Bounded span recorder with Chrome-trace export.

    Spans nest (the trace viewer stacks same-thread ``X`` events by time
    containment; ``parent`` names the enclosing span).  The event ring is
    bounded, so an always-on tracer cannot grow without bound.
    ``detail`` is the one switch that records detail spans without a
    profiler (default off).
    """

    def __init__(self, max_events: int = 65536):
        self._events: deque = deque(maxlen=max_events)
        self.detail = False
        self._wall0_ns = time.time_ns()
        self._perf0_ns = time.perf_counter_ns()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _now_us(self) -> float:
        """Unix-epoch microseconds on the tracer's monotonic clock."""
        return (self._wall0_ns + time.perf_counter_ns()
                - self._perf0_ns) / 1e3

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str, cat: str = "repro", **args):
        """Record ``name`` (category ``cat``) around the block; yields its
        :class:`Span`."""
        stack = self._stack()
        sp = Span(next(self._ids), args)
        parent = stack[-1] if stack else None
        stack.append(sp.id)
        ts = self._now_us()
        rf = None
        if profiler_recording():
            rf = _Range(f"{cat}:{name}")
            rf.__enter__()
        try:
            yield sp
        finally:
            if rf is not None:
                rf.__exit__()
            end = self._now_us()
            stack.pop()
            self._events.append({
                "name": name, "cat": cat, "ph": "X", "ts": ts,
                "dur": end - ts, "pid": _pid,
                "tid": threading.get_ident() % (1 << 31),
                "id": sp.id, "parent": parent,
                "args": {k: _jsonable(v) for k, v in sp.args.items()},
            })

    def detail_span(self, name: str, cat: str = "repro"):
        """A detail span: :meth:`span` while ``detail`` is on, else a
        profiler range named ``cat:name`` while a profiler records, else
        a shared no-op context."""
        if self.detail:
            return self.span(name, cat)
        if profiler_recording():
            return _Range(f"{cat}:{name}")
        return _OFF

    def events(self) -> list:
        return list(self._events)

    def clear(self):
        self._events.clear()

    def export_chrome_trace(self, path, base_ns=None) -> str:
        """Write the recorded spans as Chrome trace-event JSON (loads in
        chrome://tracing and ui.perfetto.dev); returns the path.  ``ts``
        is relative to ``baseTimeNanoseconds``: ``base_ns``, or the
        tracer's start rounded down to the second.  Pass a profiler
        trace's ``baseTimeNanoseconds`` to concatenate the two files'
        ``traceEvents`` on one timeline."""
        if base_ns is None:
            base_ns = self._wall0_ns // 10**9 * 10**9
        base_us = base_ns / 1e3
        evs = [{**e, "ts": e["ts"] - base_us} for e in self.events()]
        doc = {"traceEvents": evs, "displayTimeUnit": "ms",
               "baseTimeNanoseconds": int(base_ns)}
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


def span(name: str, cat: str = "repro", **args):
    """A burst-level span on the module-level :data:`tracer` (the wave,
    migration, checkpoint, fault and serving sites all funnel through
    here)."""
    return tracer.span(name, cat, **args)
