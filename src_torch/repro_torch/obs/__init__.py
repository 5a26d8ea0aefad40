"""repro_torch.obs — serving SLO metrics and host span tracing."""
from .metrics import (  # noqa: F401
    Counter, Gauge, LatencyHistogram, MetricsRegistry, bucket_edges,
    default_registry, device_bucket_counts,
)
from .tracing import (  # noqa: F401
    Tracer, configure, default_tracer, emit_event, export_chrome_trace,
    profiler_session, trace_span,
)

__all__ = [
    "Counter", "Gauge", "LatencyHistogram", "MetricsRegistry",
    "bucket_edges", "default_registry", "device_bucket_counts",
    "Tracer", "configure", "default_tracer", "emit_event",
    "export_chrome_trace", "profiler_session", "trace_span",
]
