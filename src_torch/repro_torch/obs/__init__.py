"""repro_torch.obs — telemetry: device round metrics, host span tracing
and serving SLO metrics.

* device round metrics — ``repro_torch.solve(..., metrics=True)``
  records a per-round :mod:`~repro_torch.obs.device` entry into
  ``MTLResult.extras["metrics"]``, leaving ``W`` and the ledger
  bit-identical;
* host span tracing — :func:`trace_span` / :func:`emit_event`, exported
  as JSONL and Chrome ``trace.json`` (:mod:`~repro_torch.obs.tracing`);
* serving SLO metrics — latency histograms, counters and staleness
  gauges in a shared :class:`MetricsRegistry`
  (:mod:`~repro_torch.obs.metrics`).

``python -m repro_torch.obs summarize RUN_DIR`` renders a run directory;
``python -m repro_torch.obs smoke --out RUN_DIR`` runs the instrumented
tiny solve, serve and streaming path.
"""
from .device import OBS_KEY, RoundMetricsSink, obs_init, obs_round  # noqa: F401
from .metrics import (  # noqa: F401
    Counter, Gauge, LatencyHistogram, MetricsRegistry, bucket_edges,
    default_registry, device_bucket_counts,
)
from .tracing import (  # noqa: F401
    Tracer, configure, default_tracer, emit_event, export_chrome_trace,
    profiler_session, read_events_jsonl, trace_span,
)

__all__ = [
    "OBS_KEY", "RoundMetricsSink", "obs_init", "obs_round",
    "Counter", "Gauge", "LatencyHistogram", "MetricsRegistry",
    "bucket_edges", "default_registry", "device_bucket_counts",
    "Tracer", "configure", "default_tracer", "emit_event",
    "export_chrome_trace", "profiler_session", "read_events_jsonl",
    "trace_span",
]
