"""repro_torch.obs — the port's telemetry: metrics registry, span tracing,
cost hooks; the counterpart of `repro.obs`, with the same names.

Stdlib only, and importing nothing else of the port, so every layer can
depend on it without cycles. ``clock`` (`time.perf_counter`) is the one
sanctioned monotonic clock: code of the port outside this package times
through it (or through the span/metrics API), never through a raw
`time.perf_counter()` (the `repro.analysis` TEL001 rule).
"""
from repro_torch.obs.metrics import (
    DEFAULT_COUNT_BUCKETS,
    DEFAULT_TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import (Span, Tracer, clock, current, finish,
                                   render_tree, span, start)
from repro_torch.obs.cost import ViewCostRecorder

__all__ = [
    "DEFAULT_COUNT_BUCKETS",
    "DEFAULT_TIME_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "ViewCostRecorder",
    "clock",
    "current",
    "finish",
    "render_tree",
    "span",
    "start",
]
