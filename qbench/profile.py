"""Reading a ``torch.profiler`` trace of the profiled stretch of a run.

The profiler's Chrome trace is written to a temporary directory (under
``TMPDIR``), read back and deleted.  What is kept, in microseconds of the
trace's own clock:

* device activity: kernels, copies and fills (``kernel``, ``gpu_memcpy``,
  ``gpu_memset``), each with the correlation id of the host call that
  launched it;
* host calls that launch device work (``cuda_runtime``, ``cuda_driver``),
  by correlation id;
* host ranges: ``record_function`` ranges (the port's spans and the
  harness's own) and host operators.

The profiled stretch is the harness's ``qbench:profiled`` range, which
begins and ends with a synchronised device.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import numpy as np

STRETCH = "qbench:profiled"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LABELLED_GAPS = 400          # the longest idle gaps named one by one


def short_name(name: str) -> str:
    """A device operation's name without ``void``, anonymous namespaces
    and its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip()[:96]


class Trace:
    """The parsed trace of one profiled stretch."""

    def __init__(self, events: list):
        self.device = []          # (name, ts, dur, correlation)
        self.launch_ts = {}       # correlation -> host ts of its launch
        self.ranges = []          # (name, ts, dur)
        self.ops = []             # (name, ts, dur)
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, args = ev.get("cat", ""), ev.get("args") or {}
            ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.device.append((ev.get("name", ""), ts, dur,
                                    args.get("correlation")))
            elif cat in LAUNCH_CATS and "correlation" in args:
                self.launch_ts[args["correlation"]] = ts
            elif cat == "user_annotation":
                self.ranges.append((ev.get("name", ""), ts, dur))
            elif cat == "cpu_op":
                self.ops.append((ev.get("name", ""), ts, dur))
        stretch = [r for r in self.ranges if r[0] == STRETCH]
        if stretch:
            self.t0, self.t1 = stretch[0][1], stretch[0][1] + stretch[0][2]
        else:
            self.t0 = min((d[1] for d in self.device), default=0.0)
            self.t1 = max((d[1] + d[2] for d in self.device), default=0.0)

    @property
    def window_s(self) -> float:
        """Length of the profiled stretch, seconds."""
        return (self.t1 - self.t0) * 1e-6

    def _busy_intervals(self) -> list:
        """Merged device intervals inside the stretch."""
        iv = sorted((max(ts, self.t0), min(ts + dur, self.t1))
                    for _, ts, dur, _ in self.device)
        merged = []
        for a, b in iv:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        """Seconds of the stretch in which some device operation ran."""
        return sum(b - a for a, b in self._busy_intervals()) * 1e-6

    def device_us_within(self, range_names) -> tuple:
        """(device microseconds, number of ranges) of the device
        operations launched from inside the host ranges named
        ``range_names``."""
        rs = [(ts, ts + dur) for name, ts, dur in self.ranges
              if name in range_names]
        if not rs:
            return 0.0, 0
        lo = np.array([a for a, _ in rs])
        hi = np.array([b for _, b in rs])
        total = 0.0
        for _, _, dur, corr in self.device:
            t = self.launch_ts.get(corr)
            if t is not None and np.any((lo <= t) & (t <= hi)):
                total += dur
        return total, len(rs)

    def kernel_us(self, kernel: str) -> list:
        """Durations of the device kernels named ``kernel``, in the order
        they ran."""
        return [dur for name, ts, dur, _ in sorted(self.device,
                                                   key=lambda d: d[1])
                if short_name(name) == kernel]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps summed by what the host was doing halfway through each
        (the innermost host range, then the innermost host operator):
        ``{"device_ops": [[name, s], ...], "idle_gaps": [[name, s],
        ...]}``."""
        by_op = defaultdict(float)
        for name, ts, dur, _ in self.device:
            if ts >= self.t0 and ts + dur <= self.t1:
                by_op[short_name(name)] += dur * 1e-6
        busy = self._busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        by_gap = defaultdict(float)
        r_name, r_lo, r_hi = self._arrays(self.ranges)
        o_name, o_lo, o_hi = self._arrays(self.ops)
        for i, (a, b) in enumerate(gaps):
            if i >= LABELLED_GAPS:
                by_gap["shorter gaps"] += (b - a) * 1e-6
                continue
            mid = (a + b) / 2
            label = "/".join(
                x for x in (self._innermost(r_name, r_lo, r_hi, mid),
                            self._innermost(o_name, o_lo, o_hi, mid))
                if x) or "no host range"
            by_gap[label] += (b - a) * 1e-6
        order = lambda d: sorted(([k, v] for k, v in d.items()),
                                 key=lambda kv: -kv[1])[:top]
        return {"device_ops": order(by_op), "idle_gaps": order(by_gap)}

    @staticmethod
    def _arrays(items):
        names = [n for n, _, _ in items]
        lo = np.array([t for _, t, _ in items], dtype=np.float64)
        hi = np.array([t + d for _, t, d in items], dtype=np.float64)
        return names, lo, hi

    @staticmethod
    def _innermost(names, lo, hi, t):
        """The name of the latest-starting range that holds ``t``."""
        if not names:
            return ""
        inside = np.flatnonzero((lo <= t) & (t <= hi))
        if inside.size == 0:
            return ""
        return names[inside[np.argmax(lo[inside])]]


def collect(prof) -> Trace:
    """Parse a finished ``torch.profiler.profile``'s trace."""
    with tempfile.TemporaryDirectory(prefix="qbench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return Trace(events)
