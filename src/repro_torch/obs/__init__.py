"""Telemetry of the port: span tracing, metric streams, profiler hooks.

The counterpart of ``repro.obs``, with its names.  Every layer is inert
when disabled: with ``metrics=False`` no result field changes and no extra
op runs on the device.

* :mod:`repro_torch.obs.trace` — host span tracing.  ``span("name")``
  context managers feed a process-wide :class:`TraceRecorder` that emits
  Chrome trace-event JSON (``chrome://tracing`` / Perfetto), with the
  fleet's producer thread and the JSONL exporter on their own tracks.
  With no recorder installed a span is two ``perf_counter`` calls.
* :mod:`repro_torch.obs.metrics` — per-frame metric streams.
  ``EngineOptions(metrics=True)`` makes ``simulate`` and
  ``simulate_fleet`` return one :class:`MetricsFrame` row per decision
  (per-server utilization and backlog, admission sheds, per-QoS-class
  satisfaction, the assignment-tier histogram) as a
  :class:`MetricsResult`; the dense fleet computes a window's rows on the
  device and copies them to the host once per window.
* :mod:`repro_torch.obs.export` — :class:`AsyncJsonlWriter`, a background
  JSONL writer.
* :mod:`repro_torch.obs.profiler` — ``torch.profiler`` hooks:
  :func:`profile_trace` captures a device profile of a run;
  :func:`annotate` / :func:`step_annotation` mark scheduler calls, fleet
  windows and the serving path's engine, layers and Mamba-2 passes inside
  any recording ``torch.profiler`` profile (this one or a caller's), and
  are shared no-op context managers when none records.
* :mod:`repro_torch.obs.counters` — process-wide integer counters of the
  serving path and the model kernels (batches, prompt tokens, launches by
  route, builds), always on; imported by path, not exported here.
"""
from .trace import (
    CAT_BUILD,
    CAT_COMPILE,
    CAT_DISPATCH,
    CAT_GEN,
    CAT_IO,
    CAT_METRICS,
    CAT_SCHED,
    Stopwatch,
    TraceRecorder,
    active_recorder,
    instant,
    recording,
    save_chrome_trace,
    span,
    start_trace,
    stop_trace,
    validate_chrome_trace,
)
from .metrics import (
    QOS_ACC_EDGES,
    MetricsFrame,
    MetricsResult,
)
from .export import AsyncJsonlWriter
from .profiler import annotate, profile_trace, profiling_active, step_annotation

__all__ = [
    "CAT_BUILD",
    "CAT_COMPILE",
    "CAT_DISPATCH",
    "CAT_GEN",
    "CAT_IO",
    "CAT_METRICS",
    "CAT_SCHED",
    "Stopwatch",
    "TraceRecorder",
    "active_recorder",
    "instant",
    "recording",
    "save_chrome_trace",
    "span",
    "start_trace",
    "stop_trace",
    "validate_chrome_trace",
    "QOS_ACC_EDGES",
    "MetricsFrame",
    "MetricsResult",
    "AsyncJsonlWriter",
    "annotate",
    "profile_trace",
    "profiling_active",
    "step_annotation",
]
