"""Named spans around the wave, burst and migration sites.

Counterpart of ``repro/obs/trace.py:span``.  A span is a
``torch.profiler.record_function`` range, so it shows in a
``torch.profiler`` trace beside the kernels it encloses and costs next
to nothing when no profiler runs.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def span(name: str, cat: str = "repro", **args):
    """Annotate the enclosed work as ``cat:name``; ``args`` are kept in
    the range's name only for the profiler's eye (``k=v`` pairs)."""
    label = name if not args else (
        name + " " + ",".join(f"{k}={v}" for k, v in args.items()))
    with torch.profiler.record_function(f"{cat}:{label}"):
        yield
