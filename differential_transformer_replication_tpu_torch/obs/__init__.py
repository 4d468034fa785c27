"""Telemetry of the port (copies of the JAX package's obs/ modules,
stdlib only except ``introspect``):

- :mod:`obs.registry` — a thread-safe metrics registry
  (Counter/Gauge/Histogram with labels) and its Prometheus text
  exposition; the trainer serves it from a sidecar port
  (``--metrics-port``), the serving server at ``GET /metrics``,
- :mod:`obs.http` — the stdlib HTTP exporter of that sidecar,
- :mod:`obs.spans` — the host span tracer (Chrome trace-event JSON:
  data wait, dispatch, blocking, eval, checkpoint snapshots in the
  trainer; schedule, prefill, decode, sample, emit in the serving
  engine),
- :mod:`obs.trace` — request trace contexts (``trace_id`` /
  ``span_id``) carried as a W3C ``traceparent`` field and stamped onto
  the serving engine's spans and instants,
- :mod:`obs.events` — the structured JSONL event log (request
  received / finished / failed, drained) with size rotation,
- :mod:`obs.slo` — availability and latency objectives evaluated
  against the registry, re-exposed as ``slo_*`` burn-rate gauges,
- :mod:`obs.quality` — quantile sketches of the served tokens'
  entropy and margin, their PSI drift against a recorded fingerprint,
- :mod:`obs.introspect` — per-layer lambda and per-group param norms
  from a train state, logged at every eval (``tools/lambda_report.py``),
  and the serving params' lambdas for ``serving_lambda_mean``.
"""

from differential_transformer_replication_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    LATENCY_BUCKETS_S,
    Registry,
    parse_exposition,
    set_build_info,
)
from differential_transformer_replication_tpu_torch.obs.spans import (
    NOOP_TRACER,
    SpanTracer,
)
from differential_transformer_replication_tpu_torch.obs.events import (
    EventLog,
    NOOP_EVENTS,
    open_event_log,
)
from differential_transformer_replication_tpu_torch.obs.trace import (
    TraceContext,
    parse_traceparent,
)
from differential_transformer_replication_tpu_torch.obs.slo import (
    AvailabilityObjective,
    LatencyObjective,
    SLOMonitor,
)
from differential_transformer_replication_tpu_torch.obs.quality import (
    QualityMonitor,
    QuantileSketch,
)
from differential_transformer_replication_tpu_torch.obs.http import (
    start_metrics_server,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS_S",
    "Registry",
    "parse_exposition",
    "set_build_info",
    "SpanTracer",
    "NOOP_TRACER",
    "EventLog",
    "NOOP_EVENTS",
    "open_event_log",
    "TraceContext",
    "parse_traceparent",
    "AvailabilityObjective",
    "LatencyObjective",
    "SLOMonitor",
    "QualityMonitor",
    "QuantileSketch",
    "start_metrics_server",
]
