"""The port's telemetry plane (counterpart of ``repro/obs``), three layers:

* :mod:`repro_torch.obs.metrics` — the typed metrics registry with the
  fixed label taxonomy, the :class:`RingLog` bounded evidence container,
  and the pull-based ``publish_*`` adapters that scrape every
  subsystem's counters into one ``snapshot()``.
* :mod:`repro_torch.obs.trace` — ring-buffered nested span tracing over
  the staged emission and the serving plane, Chrome-trace/Perfetto
  export, one ``None`` check when disabled.
* :mod:`repro_torch.obs.baseline` — the perf-regression gate comparing
  two ``BENCH_*.json`` artifacts with per-metric tolerance bands.

The names re-exported here are the reference's, so instrumentation
sites and entry points write ``obs.enable()`` / ``obs.enabled()`` /
``obs.span`` without caring which layer owns the global.
"""
from repro_torch.obs.trace import (KINDS, Span, TraceRecorder, begin,
                                   capture, complete, containing, disable,
                                   enable, enabled, end, recorder, span,
                                   well_formed)
from repro_torch.obs.metrics import (LABEL_KEYS, Counter, Gauge, Histogram,
                                     MetricsRegistry, RingLog, collect,
                                     publish_chaos, publish_emission_stats,
                                     publish_group, publish_pipeline,
                                     publish_poll_stats, publish_supervisor)
from repro_torch.obs.baseline import (Delta, DiffReport, Tolerance,
                                      default_tolerance, diff, diff_files,
                                      load_rows, row_key)

__all__ = [
    # trace
    "KINDS", "Span", "TraceRecorder", "begin", "capture", "complete",
    "containing", "disable", "enable", "enabled", "end", "recorder",
    "span", "well_formed",
    # metrics
    "LABEL_KEYS", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "RingLog", "collect", "publish_chaos", "publish_emission_stats",
    "publish_group", "publish_pipeline", "publish_poll_stats",
    "publish_supervisor",
    # baseline
    "Delta", "DiffReport", "Tolerance", "default_tolerance", "diff",
    "diff_files", "load_rows", "row_key",
]
