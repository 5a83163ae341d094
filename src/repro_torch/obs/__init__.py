"""Wavescope for the port: observability of the device wave path.

Counterpart of ``repro/obs``: ``device`` (the metrics ring every wave
writes a row to, with no extra exchange), ``trace`` (timers, spans as
``torch.profiler`` ranges, Chrome/perfetto export), ``recorder`` (the
flight recorder attached to overflow errors) and ``export`` (JSON and
Prometheus text).  CLI: ``python -m repro_torch.obs --smoke``.
"""
from .device import (METRIC_HEAD, MetricsState, drain, init_metrics_state,
                     record_row, row_width)
from .export import to_json, to_prometheus
from .recorder import FlightRecorder
from .trace import Timer, Timers, Tracer, span, timers, tracer

__all__ = ["METRIC_HEAD", "FlightRecorder", "MetricsState", "Timer",
           "Timers", "Tracer", "drain", "init_metrics_state", "record_row",
           "row_width", "span", "timers", "to_json", "to_prometheus",
           "tracer"]
