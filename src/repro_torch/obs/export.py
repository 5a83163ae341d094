"""Metrics exposition: JSON and Prometheus-text emitters.

Copy of ``repro/obs/export.py``.  Both take the nested snapshot dicts of
:meth:`~repro_torch.serve.engine.ServeEngine.metrics` (or any nested dict
of numbers, lists and sub-dicts) and are pure host-side formatting.

Flattening convention for the Prometheus text format: nested dict keys
extend the metric name with ``_``; list entries and all-digit dict keys
become an ``index="i"`` label (per-tier / per-window gauges); non-numeric
leaves are dropped.
"""
from __future__ import annotations

import json
import re

_NAME_OK = re.compile(r"[^a-zA-Z0-9_]")


def to_json(metrics: dict, *, indent: int = 2) -> str:
    return json.dumps(metrics, indent=indent, sort_keys=True, default=str)


def _sanitize(name: str) -> str:
    return _NAME_OK.sub("_", str(name))


def _fmt(name: str, labels: dict, value) -> str:
    if isinstance(value, bool):
        value = int(value)
    lab = ("{" + ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
           + "}") if labels else ""
    return f"{name}{lab} {value}"


def to_prometheus(metrics: dict, prefix: str = "repro") -> str:
    """Render a nested metrics snapshot as Prometheus text exposition."""
    lines: list = []

    def walk(name: str, labels: dict, v) -> None:
        if isinstance(v, dict):
            for k in sorted(v, key=str):
                ks = str(k)
                if ks.lstrip("-").isdigit():
                    walk(name, {**labels, "index": ks}, v[k])
                else:
                    walk(f"{name}_{_sanitize(ks)}", labels, v[k])
        elif isinstance(v, (list, tuple)):
            for i, item in enumerate(v):
                walk(name, {**labels, "index": str(i)}, item)
        elif isinstance(v, (int, float, bool)):
            lines.append(_fmt(name, labels, v))

    walk(_sanitize(prefix), {}, metrics)
    return "\n".join(lines) + ("\n" if lines else "")
