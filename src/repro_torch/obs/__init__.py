"""repro_torch.obs — zero-dependency observability: metrics, traces, scraping.

Port of ``repro.obs`` (stdlib only, the same metric names and formats):

* :data:`REGISTRY` — process-wide metrics registry (counters / gauges /
  fixed-bucket histograms with labels). ``GraphSession`` runs, the block
  fetcher, the packed chunk streamer and the ``.dsss`` store's
  self-healing reads publish into it at the same lines that charge
  ``Meters``, so registry deltas across a run recombine field for field
  with ``Result.meters``. Rendered as Prometheus text exposition by
  :meth:`MetricsRegistry.render`; ``REPRO_OBS=0`` disables everything.
* :data:`TRACER` — bounded ring recorder of structured spans (staging,
  each sweep with its physical byte deltas, each run), exportable as
  Chrome/Perfetto ``trace_event`` JSON. Off by default; enable it
  process-wide with :func:`enable_tracing`, or per run with the
  :class:`TraceSpec` plan knob.
* :class:`TelemetryServer` — stdlib HTTP endpoint serving ``/metrics``
  and ``/healthz``.
* ``python -m repro_torch.obs export-trace spans.jsonl -o trace.json`` —
  offline converter from raw span dumps to Perfetto-loadable JSON.
"""
from repro_torch.obs.http import TelemetryServer
from repro_torch.obs.registry import (
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    HistogramValue,
    MetricsRegistry,
    REGISTRY,
    parse_prometheus,
)
from repro_torch.obs.trace import (
    Span,
    TraceSpec,
    Tracer,
    TRACER,
    disable_tracing,
    enable_tracing,
)

__all__ = [
    "DEFAULT_LATENCY_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "HistogramValue",
    "MetricsRegistry",
    "REGISTRY",
    "Span",
    "TelemetryServer",
    "TraceSpec",
    "Tracer",
    "TRACER",
    "disable_tracing",
    "enable_tracing",
    "parse_prometheus",
]
