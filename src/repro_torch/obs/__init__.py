"""Serving-wide observability: tracing, metrics, exporters (the
reference's ``repro.obs``).

* :mod:`repro_torch.obs.tracer` — typed lifecycle events, the port's
  host spans and the no-op :data:`NULL_TRACER` the hot path defaults to;
* :mod:`repro_torch.obs.metrics` — counters, gauges, fixed-bucket
  histograms, the shared :func:`pctl` quantile helper and the
  metric-name contracts;
* :mod:`repro_torch.obs.export` — Perfetto JSON, JSONL save/replay and
  :func:`trace_report` phase attribution.
"""
from repro_torch.obs.export import (export_perfetto, load_jsonl, save_jsonl,
                                    trace_report)
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     ROUTER_METRIC_CONTRACT,
                                     SCHEDULER_METRIC_CONTRACT, pctl,
                                     serving_registry)
from repro_torch.obs.tracer import (EVENT_KINDS, NULL_TRACER, SPAN_KINDS,
                                    NullTracer, TraceEvent, Tracer)

__all__ = [
    "EVENT_KINDS", "SPAN_KINDS", "NULL_TRACER", "NullTracer", "TraceEvent",
    "Tracer",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS",
    "SCHEDULER_METRIC_CONTRACT", "ROUTER_METRIC_CONTRACT", "pctl",
    "serving_registry", "export_perfetto", "save_jsonl", "load_jsonl",
    "trace_report",
]
