"""Telemetry of the port's trainer (copies of the JAX package's obs/
modules the trainer uses, stdlib only except ``introspect``):

- :mod:`obs.registry` — a thread-safe metrics registry
  (Counter/Gauge/Histogram with labels) and its Prometheus text
  exposition; the trainer serves it from a sidecar port
  (``--metrics-port``),
- :mod:`obs.http` — the stdlib HTTP exporter of that sidecar,
- :mod:`obs.spans` — the host span tracer (Chrome trace-event JSON:
  data wait, dispatch, blocking, eval, checkpoint snapshots),
- :mod:`obs.introspect` — per-layer lambda and per-group param norms
  from a train state, logged at every eval (``tools/lambda_report.py``).

The request traces and the event log (``obs/trace.py``,
``obs/events.py``) serve the serving path and come with its subsystems
(ROADMAP Queue A: serving subsystems).
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
    "start_metrics_server",
]
