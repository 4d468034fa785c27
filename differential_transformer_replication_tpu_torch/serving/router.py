"""Health-aware multi-replica serving router.

A single server has per-instance resilience — typed retriable errors
with Retry-After, ``/health``/``/ready``, graceful drain, ``/metrics``
gauges — but one engine crash or restart is still a full outage for
its traffic. This module composes N replicas into one fleet-level
endpoint:

- **Replica registry + active probing** — each replica is probed at
  ``GET /ready`` (state: up / draining / not_ready) and scored from its
  ``GET /metrics`` gauges (queue depth, slot occupancy, KV
  utilization). Failing replicas are probed on an exponential backoff
  and EJECTED after ``RouterConfig.eject_after`` consecutive transport
  failures; re-admission is slow (``readmit_after`` consecutive good
  probes) so a flapping host cannot oscillate into rotation.
- **Power-of-two-choices picking** — two random eligible replicas,
  lower load score wins. The score blends the probe-stale passive
  metrics with the router's own live in-flight count, so balance holds
  even between probes.
- **Failover on typed errors** — a retriable reply (503 queue_full /
  shutting_down / engine_crash, or an unreachable replica) is retried
  on a DIFFERENT replica under a total per-request deadline budget;
  non-recoverable codes (504 deadline, timeout, engine_failed) pass
  through untouched. Honored Retry-After values are capped
  (``retry_after_cap_s``) — another replica can usually serve NOW.
- **Hedging (optional)** — a request stuck past a p99-derived latency
  budget fires a second attempt on another replica; first reply wins.
- **Session affinity** — requests carrying ``session_id`` stick to one
  replica (prefix-cache locality) and
  re-pin elsewhere when the pinned replica dies.
- **Router-level degradation** — zero eligible replicas means a fast
  503 ``no_replica`` with Retry-After, not a hang; the router's own
  ``/health``, ``/ready`` and ``/metrics`` (per-replica request/error/
  ejection counters, pick latency, hedge counters via obs/registry.py)
  make the fleet observable as one unit.
- **Request tracing** — every request gets a trace context
  (client ``traceparent`` or minted here, obs/trace.py), re-injected
  per attempt so each replica's spans parent to the exact forward hop
  that caused them; the router's own ``pick``/``forward``/``retry``/
  ``hedge`` spans (``--trace-path``) stitch with replica traces into
  one timeline via tools/trace_stitch.py, and every reply — success
  or failure — echoes ``trace_id``.
- **Fleet aggregation** — ``GET /fleet/metrics`` re-serves the
  replicas' last-probed ``/metrics`` bodies as ONE exposition
  (counters/histograms summed, gauges labeled per replica,
  :func:`aggregate_fleet_metrics`) plus the router's own registry and
  per-replica up/down gauges: one scrape target for the whole fleet,
  and the natural input for ``tools/slo_report.py --url``.
- **Structured events** — ejection/re-admission and request
  finished/failed/retried/hedged/shed land in a JSONL event log
  (``--event-log``, obs/events.py), each request event carrying its
  ``trace_id``.

Drain-aware by construction: a replica answering ``/ready`` 503 with
status ``draining`` (what SIGTERM triggers, serving/server.py) is
removed from rotation WITHOUT being ejected — no connection ever
breaks, which is what makes serving/fleet.py's rolling restarts
zero-loss.

Pure stdlib, no torch import — the router must keep routing while the
device runtimes it fronts are the things crashing. Successful replies
gain ``replica`` / ``attempts`` / ``hedged`` fields so every response
is attributable (tools/serve_bench.py's per-replica breakdown keys off
them).

Run standalone::

    python -m differential_transformer_replication_tpu_torch.serving.router \
        --target http://127.0.0.1:8101 --target http://127.0.0.1:8102 \
        --port 8000

or let ``serving/fleet.py`` launch replicas + router together.

A copy of the JAX package's ``serving/router.py``: the same state
machine, picker, failover and hedging, migrate and replay rungs, wire
format, metric families, event kinds, fault points and CLI flags, with
its imports re-pointed to the port. It fronts either package's
replicas, and the JAX package's router fronts the port's.
"""

from __future__ import annotations

import json
import random
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from differential_transformer_replication_tpu_torch.config import RouterConfig
from differential_transformer_replication_tpu_torch.obs.events import (
    NOOP_EVENTS,
)
from differential_transformer_replication_tpu_torch.obs.registry import (
    CONTENT_TYPE as METRICS_CONTENT_TYPE,
    Registry,
    _escape_label_value,
    _fmt_value,
    parse_exposition,
    set_build_info,
)
from differential_transformer_replication_tpu_torch.obs.spans import NOOP_TRACER
from differential_transformer_replication_tpu_torch.obs.trace import (
    child_span_args,
    from_payload as trace_from_payload,
    instant_args,
)
from differential_transformer_replication_tpu_torch.serving.admission import (
    AdmissionController,
)
from differential_transformer_replication_tpu_torch.serving.migrate import (
    ReplayJournal,
)
from differential_transformer_replication_tpu_torch.serving.retry import (
    backoff_delay,
    http_post_json_with_retries,
)
from differential_transformer_replication_tpu_torch.utils import faults

# Replica lifecycle states. UP is the only state the picker considers.
UP = "up"                  # last probe: reachable and ready
NOT_READY = "not_ready"    # reachable, /ready 503 (e.g. restarting)
DRAINING = "draining"      # reachable, /ready 503 with status=draining
EJECTED = "ejected"        # eject_after consecutive transport failures
UNKNOWN = "unknown"        # never successfully probed yet

# Reply codes the router retries on a different replica. Anything else
# on a 503 that is not explicitly non-retriable (unknown proxies) is
# also retried — mirrors serving/retry.py's stance.
NON_RETRIABLE_503_CODES = ("timeout", "engine_failed")

# /metrics gauge names (serving/engine.py) -> Replica score fields.
_SCORE_METRICS = {
    "serving_queue_depth": "queue_depth",
    "serving_slot_occupancy": "slot_occupancy",
    "serving_slots": "slots",
    "serving_kv_utilization": "kv_utilization",
}


def parse_replica_scores(text: str) -> Dict[str, float]:
    """Extract the load-score gauges from a Prometheus text exposition.
    Unknown/malformed lines are skipped — a replica with a bigger
    registry (or none of these gauges) still probes fine."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 2:
            continue
        key = _SCORE_METRICS.get(parts[0])
        if key is not None:
            try:
                out[key] = float(parts[1])
            except ValueError:
                pass
    return out


def _histogram_base(name: str, types: Dict[str, str]) -> Optional[str]:
    """The histogram family a ``*_bucket``/``*_sum``/``*_count`` sample
    belongs to, or None for a plain sample name."""
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            base = name[: -len(suffix)]
            if types.get(base) == "histogram":
                return base
    return None


def aggregate_fleet_metrics(bodies: Dict[str, str],
                            own: str = "") -> str:
    """Merge N replicas' ``/metrics`` bodies (plus the router's
    ``own``) into ONE fleet exposition — the single scrape target
    ``GET /fleet/metrics`` serves:

    - **counters and histograms are summed** across replicas by
      identical label set (histogram buckets are cumulative counters,
      so per-``le`` sums stay a valid histogram) — fleet throughput is
      the sum of replica throughputs;
    - **gauges keep per-replica identity**: each sample gains a
      ``replica="host:port"`` label (summing slot occupancies would
      hide exactly the imbalance a fleet scrape exists to show), which
      also keeps per-replica ``build_info``/``process_start_time``
      distinguishable — and is exactly what the model-quality plane
      rides: ``serving_quality_drift`` / ``serving_lambda_mean`` /
      ``serving_constraint_validity_rate`` (obs/quality.py) arrive
      per-replica with zero router changes, so the canary judge
      (the JAX package's tools/autoscaler.py) reads one arm's drift without the control
      arm diluting it;
    - the router's ``own`` metrics pass through unmodified, merged
      under the same TYPE declarations so shared names (``build_info``)
      render once.

    Unknown or malformed samples are skipped; replicas with disjoint
    metric sets union cleanly. Pure function — tests drive it with
    canned bodies and the oracle exposition parser."""
    kinds: Dict[str, str] = {}
    # sample name -> ordered {(label tuple) -> value}; summed flag per
    # name decides merge semantics
    values: "OrderedDict[str, OrderedDict]" = OrderedDict()

    def _add(sample_name: str, labels: Dict[str, str], value: float,
             summed: bool) -> None:
        per = values.setdefault(sample_name, OrderedDict())
        key = tuple(sorted(labels.items()))
        if summed and key in per:
            per[key] += value
        else:
            per[key] = value

    def _ingest(text: str, replica: Optional[str]) -> None:
        types, samples = parse_exposition(text)
        for name, kind in types.items():
            kinds.setdefault(name, kind)
        for sample_name, labels, value in samples:
            base = _histogram_base(sample_name, types)
            family = base or sample_name
            kind = types.get(family, "untyped")
            if replica is None:
                _add(sample_name, labels, value, summed=False)
            elif kind in ("counter", "histogram"):
                _add(sample_name, labels, value, summed=True)
            else:  # gauge/untyped: keep replica identity
                _add(sample_name, {**labels, "replica": replica},
                     value, summed=False)

    if own:
        _ingest(own, None)
    for replica_name, text in bodies.items():
        _ingest(text, replica_name)

    out: List[str] = []
    seen_types = set()
    for sample_name in sorted(values):
        base = _histogram_base(sample_name, kinds)
        family = base or sample_name
        if family not in seen_types:
            seen_types.add(family)
            out.append(
                f"# TYPE {family} {kinds.get(family, 'untyped')}"
            )
        for key, value in values[sample_name].items():
            lbl = (
                "{" + ",".join(
                    f'{k}="{_escape_label_value(v)}"' for k, v in key
                ) + "}"
                if key else ""
            )
            out.append(f"{sample_name}{lbl} {_fmt_value(value)}")
    return "\n".join(out) + "\n" if out else ""


class Replica:
    """One backend's registry entry: URL, health state machine, passive
    load scores, and router-side in-flight count. All mutation happens
    under ``self.lock``; the state machine itself is pure bookkeeping
    (``note_*`` methods) so tests drive it without HTTP."""

    def __init__(self, url: str, cfg: RouterConfig):
        self.url = url.rstrip("/")
        # label/attribution name: host:port reads better than a full URL
        split = urllib.parse.urlsplit(self.url)
        self.name = split.netloc or self.url
        self.cfg = cfg
        self.lock = threading.Lock()
        self.state = UNKNOWN
        self.status = "unknown"    # replica-reported status string
        self.consec_fail = 0       # consecutive transport failures
        self.consec_ok = 0         # consecutive good probes (re-admission)
        self.ejections = 0
        self.inflight = 0          # router-side live requests
        self.queue_depth = 0.0
        self.slot_occupancy = 0.0
        self.slots = 1.0
        self.kv_utilization = 0.0
        self.next_probe_t = 0.0    # monotonic ts of the next due probe
        self.probe_backoff = cfg.probe_backoff_s
        self.probing = False       # an async probe is in flight
        self.last_probe_ok_t: Optional[float] = None
        # last successfully fetched /metrics body (text exposition) —
        # what GET /fleet/metrics aggregates; kept across not-ready
        # windows so a draining replica's counters stay visible —
        # plus the monotonic stamp of WHEN it was fetched: the fleet
        # aggregation excludes bodies older than
        # RouterConfig.metrics_max_age_s and publishes every age as a
        # fleet_scrape_age_seconds gauge (None = never fetched by the
        # prober; a body injected without a stamp aggregates as legacy)
        self.metrics_text: str = ""
        self.metrics_t: Optional[float] = None

    def eligible(self) -> bool:
        with self.lock:
            return self.state == UP

    def score(self) -> float:
        """Load score for power-of-two-choices (lower = less loaded)."""
        cfg = self.cfg
        with self.lock:
            slots = max(1.0, self.slots)
            return (
                cfg.queue_weight * self.queue_depth / slots
                + cfg.slot_weight * self.slot_occupancy / slots
                + cfg.kv_weight * self.kv_utilization
                + self.inflight / slots
            )

    # -- health state machine -----------------------------------------

    def note_probe_success(self, ready: bool, status: str,
                           scores: Dict[str, float], now: float) -> None:
        """A probe REACHED the replica (whatever it answered)."""
        with self.lock:
            self.consec_fail = 0
            self.probe_backoff = self.cfg.probe_backoff_s
            self.next_probe_t = now + self.cfg.probe_interval_s
            self.last_probe_ok_t = now
            self.status = status
            for key, value in scores.items():
                setattr(self, key, value)
            if not ready:
                # reachable but refusing traffic: connection-free
                # removal (drain / restart), NOT an ejection — and it
                # resets the re-admission streak. An EJECTED replica
                # STAYS ejected (a booting relaunch answering
                # "restarting" must not launder away the slow
                # re-admission requirement)
                self.consec_ok = 0
                if self.state != EJECTED:
                    self.state = (
                        DRAINING if status == "draining" else NOT_READY
                    )
                return
            self.consec_ok += 1
            if self.state == EJECTED:
                # slow re-admission: one good probe is not enough
                if self.consec_ok >= self.cfg.readmit_after:
                    self.state = UP
                return
            self.state = UP

    def note_failure(self, now: float) -> bool:
        """A probe or forwarded request could not reach the replica.
        Returns True when this failure newly ejected it."""
        with self.lock:
            self.consec_ok = 0
            self.consec_fail += 1
            self.next_probe_t = now + self.probe_backoff
            self.probe_backoff = min(
                self.probe_backoff * 2, self.cfg.probe_backoff_max_s
            )
            if (self.consec_fail >= self.cfg.eject_after
                    and self.state != EJECTED):
                self.state = EJECTED
                self.ejections += 1
                return True
            return False

    def note_request_success(self) -> None:
        """A forwarded request got an HTTP answer: the transport works,
        whatever the status code said. Does NOT touch probe state —
        only probes can re-admit an ejected replica (slow re-admission
        stays meaningful under live traffic)."""
        with self.lock:
            if self.state != EJECTED:
                self.consec_fail = 0

    def snapshot(self) -> dict:
        """Point-in-time view for the router's /health JSON."""
        with self.lock:
            return {
                "url": self.url,
                "name": self.name,
                "state": self.state,
                "status": self.status,
                "inflight": self.inflight,
                "consec_fail": self.consec_fail,
                "ejections": self.ejections,
                "queue_depth": self.queue_depth,
                "slot_occupancy": self.slot_occupancy,
                "slots": self.slots,
                "kv_utilization": self.kv_utilization,
            }


class Router:
    """The fleet front: replica registry + prober + picker + failover.

    ``start()`` runs one synchronous probe pass (so the router knows its
    fleet before the first request) and then probes from a background
    thread; ``close()`` stops it. ``handle_generate`` is the whole
    request path — :func:`serve_router` is just HTTP plumbing around
    it. ``probe_fn``/``forward_fn``/``sleep``/``rng`` are injectable
    for tests.
    """

    def __init__(self, targets: Sequence[str],
                 cfg: Optional[RouterConfig] = None,
                 registry: Optional[Registry] = None,
                 rng: Optional[random.Random] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 tracer=None, events=None):
        if not targets:
            raise ValueError("router needs at least one replica URL")
        self.cfg = cfg or RouterConfig()
        self.replicas = [Replica(t, self.cfg) for t in targets]
        if len({r.url for r in self.replicas}) != len(self.replicas):
            raise ValueError(f"duplicate replica URLs in {list(targets)}")
        self.registry = registry or Registry()
        # cross-process observability: span tracer for
        # pick/forward/retry/hedge (obs/spans.py; stitchable with the
        # replicas' traces via tools/trace_stitch.py) and a structured
        # JSONL event log (obs/events.py). Both default to no-ops.
        self.tracer = tracer or NOOP_TRACER
        self.events = events or NOOP_EVENTS
        set_build_info(self.registry, role="router")
        self._rng = rng or random.Random()
        self._rng_lock = threading.Lock()
        self._sleep = sleep
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        # session affinity: session_id -> Replica, LRU-capped at
        # cfg.affinity_max_sessions (unique sessions are unbounded over
        # a router's lifetime; pins are cheap to lose)
        self._affinity: "OrderedDict[str, Replica]" = OrderedDict()
        self._aff_lock = threading.Lock()
        # latency reservoir feeding the p99-derived hedge budget
        self._lat_lock = threading.Lock()
        self._latencies: deque = deque(maxlen=512)
        # fleet membership changes (scale_up/scale_down, an autoscaler)
        # serialize through this lock; readers see atomic whole-list
        # replacement, never an in-place mutation
        self._replicas_lock = threading.Lock()
        # canaried rollout: at most one designated canary replica takes
        # a fixed fraction of non-sticky traffic (set_canary)
        self._canary_lock = threading.Lock()
        self._canary_url: Optional[str] = None
        self._canary_fraction = 0.0
        # predictive admission (serving/admission.py): honest
        # Retry-After from fleet capacity + measured service rate, fed
        # by the probe loop's /metrics scrapes
        self.admission: Optional[AdmissionController] = (
            AdmissionController(self.cfg, registry=self.registry)
            if self.cfg.admission_predictive else None
        )
        # resume-by-replay (serving/migrate.py): bounded per-inflight
        # journal of emitted tokens, harvested from each replica's
        # GET /inflight by the probe loop; on a retriable replica death
        # the request replays prompt+journal on a peer bit-exactly
        self.journal = ReplayJournal(
            max_tokens=self.cfg.replay_journal_max_tokens,
            max_finished=self.cfg.replay_journal_max_finished,
        )

        reg = self.registry
        self._req_counter = reg.counter(
            "router_requests_total",
            "Requests forwarded to a replica (attempts, incl. hedges).",
            labelnames=("replica",),
        )
        self._err_counter = reg.counter(
            "router_replica_errors_total",
            "Non-200 replica replies and transport failures, by code.",
            labelnames=("replica", "code"),
        )
        self._retry_counter = reg.counter(
            "router_retries_total",
            "Failovers: attempts re-sent to a different replica.",
        )
        self._hedge_counter = reg.counter(
            "router_hedges_total",
            "Hedged second attempts fired for slow requests.",
        )
        self._hedge_win_counter = reg.counter(
            "router_hedge_wins_total",
            "Requests whose winning reply came from the hedge.",
        )
        self._eject_counter = reg.counter(
            "router_ejections_total",
            "Replica ejections after consecutive transport failures.",
            labelnames=("replica",),
        )
        self._shed_counter = reg.counter(
            "router_shed_total",
            "Requests shed at the router (no eligible replica).",
        )
        self._admission_shed_counter = reg.counter(
            "router_admission_shed_total",
            "Requests shed proactively by predictive admission "
            "(predicted wait past the class bound), by priority.",
            labelnames=("priority",),
        )
        self._move_counter = reg.counter(
            "router_session_moves_total",
            "Sticky sessions re-pinned because their replica died.",
        )
        self._migration_counter = reg.counter(
            "router_migrations_total",
            "Fallback-ladder rungs taken for in-flight failover, by "
            "outcome: migrated (live state moved to a peer), replayed "
            "(prompt+journal resubmitted bit-exactly), migrate_failed "
            "(a migration rung failed and the ladder fell through).",
            labelnames=("outcome",),
        )
        self._journal_bytes_gauge = reg.gauge(
            "router_replay_journal_bytes",
            "Bytes of emitted tokens held in the replay journal.",
        )
        self._drain_hist = reg.histogram(
            "router_drain_seconds",
            "Wall-clock of one replica drain via live migration "
            "(migrate_out) — independent of max_new_tokens by design.",
        )
        self._pick_hist = reg.histogram(
            "router_pick_seconds",
            "Latency of one replica pick (registry scan + scoring).",
        )
        self._eligible_gauge = reg.gauge(
            "router_replicas_eligible",
            "Replicas currently in rotation (state=up).",
        )
        self._replicas_gauge = reg.gauge(
            "router_replicas", "Configured replica count."
        )
        self._replicas_gauge.set(len(self.replicas))

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "Router":
        """Probe every replica once (concurrently — one slow replica
        must not delay knowing about the others), then keep probing
        from a daemon thread."""
        now = time.monotonic()
        initial = [
            threading.Thread(target=self.probe, args=(r, now),
                             daemon=True)
            for r in self.replicas
        ]
        for t in initial:
            t.start()
        for t in initial:
            t.join(self.cfg.probe_timeout_s * 2 + 1.0)
        # start()/close() are owner-lifecycle calls (single-threaded by
        # contract); _probe_thread is never touched from request paths
        self._probe_thread = threading.Thread(  # graftlint: threadsafe (lifecycle)
            target=self._probe_loop, name="router-prober", daemon=True
        )
        self._probe_thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(5.0)
            self._probe_thread = None  # graftlint: threadsafe (lifecycle)
        # land buffered telemetry; closing is the creator's call (the
        # CLI closes in its finally, atexit is the safety net)
        self.tracer.flush()
        self.events.flush()

    # -- fleet membership (scale_up/scale_down, an autoscaler) ---------

    def add_replica(self, url: str) -> "Replica":
        """Register a new replica (scale-up) and probe it immediately.
        The whole list is REPLACED atomically, so pickers and the
        probe loop racing this call see either the old or the new
        fleet, never a half-built one."""
        with self._replicas_lock:
            current = self.replicas
            if any(r.url == url.rstrip("/") for r in current):
                raise ValueError(f"replica {url} already registered")
            replica = Replica(url, self.cfg)
            self.replicas = current + [replica]
            self._replicas_gauge.set(len(self.replicas))
        self.events.emit("replica_added", replica=replica.name)
        self.probe(replica)
        return replica

    def remove_replica(self, url: str) -> Optional["Replica"]:
        """Deregister a replica (scale-down, AFTER its drain): drops
        it from rotation, from the canary designation, and from the
        admission controller's capacity model; its affinity pins
        re-pin on the next request. Returns the removed entry (None
        when the URL was never registered)."""
        url = url.rstrip("/")
        with self._replicas_lock:
            current = self.replicas
            removed = next((r for r in current if r.url == url), None)
            if removed is None:
                return None
            if len(current) == 1:
                raise ValueError(
                    "cannot remove the last replica from the router"
                )
            self.replicas = [r for r in current if r.url != url]
            self._replicas_gauge.set(len(self.replicas))
        with self._canary_lock:
            if self._canary_url == url:
                self._canary_url = None
                self._canary_fraction = 0.0
        with self._aff_lock:
            stale = [
                sid for sid, rep in self._affinity.items()
                if rep is removed
            ]
            for sid in stale:
                del self._affinity[sid]
        if self.admission is not None:
            self.admission.forget_replica(removed.name)
        self.events.emit("replica_removed", replica=removed.name)
        self.eligible_count()
        return removed

    def set_canary(self, url: Optional[str],
                   fraction: float = 0.0) -> None:
        """Designate (or clear, url=None) the canary replica: it
        receives ``fraction`` of non-sticky picks and is EXCLUDED from
        the ordinary p2c pool and from new affinity pins, so its
        traffic share is the configured fraction, not fraction + its
        p2c share. Sticky sessions already pinned to it keep their
        pin (prefix locality); failover may still land on it when
        nothing else is eligible (serving beats shedding)."""
        if url is not None:
            url = url.rstrip("/")
            if not any(r.url == url for r in self.replicas):
                raise ValueError(f"unknown canary url {url}")
            if not 0.0 < fraction < 1.0:
                raise ValueError(
                    f"canary fraction must be in (0, 1), got {fraction}"
                )
        with self._canary_lock:
            self._canary_url = url
            self._canary_fraction = fraction if url is not None else 0.0
        self.events.emit(
            "canary_traffic_split",
            canary=url, fraction=fraction if url is not None else 0.0,
        )

    def canary(self) -> Tuple[Optional[str], float]:
        with self._canary_lock:
            return self._canary_url, self._canary_fraction

    # -- probing -------------------------------------------------------

    def _http_get(self, url: str, timeout: float) -> Tuple[int, bytes]:
        """GET returning (status, body) — reachable 503s are ANSWERS
        here, not exceptions; transport errors propagate."""
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read() or b""

    def probe(self, replica: Replica, now: Optional[float] = None) -> None:
        """One probe: /ready for state, /metrics (best-effort) for load
        scores AND the raw exposition body the fleet aggregation
        re-serves. Transport failures drive the ejection state machine;
        ejection and (slow) re-admission land structured events."""
        t = self.cfg.probe_timeout_s
        prev_state = replica.state
        try:
            faults.check("router_probe_fail")
            status_code, body = self._http_get(
                replica.url + "/ready", timeout=t
            )
            try:
                payload = json.loads(body or b"{}")
            except ValueError:
                payload = {}
            ready = status_code == 200 and bool(payload.get("ready", True))
            status = str(payload.get("status", "unknown"))
            scores: Dict[str, float] = {}
            if ready:
                try:
                    code, text = self._http_get(
                        replica.url + "/metrics", timeout=t
                    )
                    if code == 200 and not faults.consume(
                        "router_stale_metrics"
                    ):
                        # (the fault point models a prober that stops
                        # refreshing: body, stamp AND scores all stay
                        # frozen at their last values — scrape-age
                        # stamping is what must surface it)
                        decoded = text.decode("utf-8", "replace")
                        scores = parse_replica_scores(decoded)
                        with replica.lock:
                            replica.metrics_text = decoded
                            replica.metrics_t = (
                                time.monotonic() if now is None else now
                            )
                        if self.admission is not None:
                            self.admission.observe_replica(
                                replica.name, decoded
                            )
                except OSError:
                    pass  # scores are advisory; /ready is the contract
                try:
                    # replay-journal harvest: each in-flight request's
                    # emitted-token prefix. Best-effort and lag-safe —
                    # a stale prefix only means a few tokens get
                    # re-generated bit-exactly on replay
                    code, text = self._http_get(
                        replica.url + "/inflight", timeout=t
                    )
                    if code == 200:
                        for ent in json.loads(
                            text or b"{}"
                        ).get("inflight", []):
                            jid = ent.get("journal_id")
                            if jid:
                                self.journal.update(
                                    str(jid),
                                    [int(x)
                                     for x in ent.get("tokens") or []],
                                )
                        self._journal_bytes_gauge.set(
                            self.journal.stats()["bytes"]
                        )
                except (OSError, ValueError):
                    pass  # pre-migration replicas have no /inflight
            replica.note_probe_success(
                ready, status, scores,
                now=time.monotonic() if now is None else now,
            )
            if prev_state == EJECTED and replica.state == UP:
                self.events.emit("replica_readmitted",
                                 replica=replica.name)
        except Exception:
            # unreachable (or an injected probe failure): one strike
            newly_ejected = replica.note_failure(
                time.monotonic() if now is None else now
            )
            if newly_ejected:
                self._eject_counter.inc(replica=replica.name)
                self.events.emit("replica_ejected", replica=replica.name,
                                 consec_fail=replica.consec_fail,
                                 via="probe")
                print(f"[router] replica {replica.name} ejected after "
                      f"{replica.consec_fail} consecutive failures",
                      file=sys.stderr)
        self.eligible_count()  # refresh the eligibility gauge

    def _probe_and_release(self, replica: Replica) -> None:
        try:
            self.probe(replica)
        finally:
            with replica.lock:
                replica.probing = False

    def _probe_loop(self) -> None:
        """Dispatch due probes, each on its own short-lived thread — a
        blackholed replica blocking its full probe timeout must not
        stall health detection (ejection, re-admission) for the rest
        of the fleet. At most one probe per replica is in flight."""
        while not self._stop.is_set():
            now = time.monotonic()
            next_due = now + self.cfg.probe_interval_s
            for r in self.replicas:
                with r.lock:
                    due = r.next_probe_t <= now and not r.probing
                    if due:
                        r.probing = True
                    elif not r.probing:
                        next_due = min(next_due, r.next_probe_t)
                if due:
                    threading.Thread(
                        target=self._probe_and_release, args=(r,),
                        daemon=True,
                    ).start()
            # wake for the earliest due probe; floor keeps a busy loop
            # impossible, cap keeps shutdown and new faults responsive
            self._stop.wait(min(max(next_due - time.monotonic(), 0.01),
                                0.25))

    # -- picking -------------------------------------------------------

    def pick(self, session_id: Optional[str] = None,
             exclude: Sequence[str] = ()) -> Optional[Replica]:
        """Choose a replica: sticky session first (if its pin is still
        eligible), else power-of-two-choices by load score. Returns
        None when nothing is eligible. ``exclude`` lists replica URLs
        already tried by this request (failover must move)."""
        t0 = time.perf_counter()
        try:
            faults.check("router_pick_raise")
            eligible = [
                r for r in self.replicas
                if r.eligible() and r.url not in exclude
            ]
            # canary split: the canary is EXCLUDED from the ordinary
            # pool (its share is exactly the configured fraction, not
            # fraction + a p2c share) unless it is the only eligible
            # replica — serving beats shedding
            canary_url, canary_frac = self.canary()
            canary = None
            pool = eligible
            if canary_url is not None:
                canary = next(
                    (r for r in eligible if r.url == canary_url), None
                )
                if canary is not None:
                    rest = [r for r in eligible if r.url != canary_url]
                    if rest:
                        pool = rest
            if session_id is not None and self.cfg.affinity:
                with self._aff_lock:
                    pinned = self._affinity.get(session_id)
                    if pinned is not None:
                        self._affinity.move_to_end(session_id)
                pinned_alive = pinned is not None and pinned.eligible()
                if pinned_alive and pinned.url not in exclude:
                    return pinned
                if not eligible:
                    return None
                # new pins come from the non-canary pool: a canary must
                # not accrete sticky sessions it keeps after promotion
                # judgment ends (or drags through rollback)
                choice = self._p2c(pool)
                if pinned_alive:
                    # the pin is healthy but excluded by THIS request's
                    # failover (a transient queue_full, say): serve
                    # elsewhere without re-pinning — one backpressure
                    # blip must not permanently forfeit the session's
                    # prefix-cache locality
                    return choice
                with self._aff_lock:
                    self._affinity[session_id] = choice
                    self._affinity.move_to_end(session_id)
                    while (len(self._affinity)
                           > self.cfg.affinity_max_sessions):
                        self._affinity.popitem(last=False)
                if pinned is not None:
                    self._move_counter.inc()  # pinned replica died
                return choice
            if not eligible:
                return None
            if canary is not None and pool is not eligible:
                with self._rng_lock:
                    roll = self._rng.random()
                if roll < canary_frac:
                    return canary
            return self._p2c(pool)
        finally:
            self._pick_hist.observe(time.perf_counter() - t0)

    def _p2c(self, eligible: List[Replica]) -> Replica:
        if len(eligible) == 1:
            return eligible[0]
        with self._rng_lock:
            a, b = self._rng.sample(eligible, 2)
        return a if a.score() <= b.score() else b

    # -- live migration / resume-by-replay (serving/migrate.py) --------

    def repin(self, session_id: str, url: str) -> bool:
        """Immediately re-pin a sticky session to the replica at
        ``url``. Before migration the affinity map only re-pinned when
        the pinned replica DIED; a migrated session's prefix-cache
        locality now lives at the destination, so the pin must follow
        the moved state right away — not after another failure."""
        url = url.rstrip("/")
        rep = next((r for r in self.replicas if r.url == url), None)
        if rep is None:
            return False
        with self._aff_lock:
            if self._affinity.get(session_id) is rep:
                self._affinity.move_to_end(session_id)
                return True
            self._affinity[session_id] = rep
            self._affinity.move_to_end(session_id)
            while len(self._affinity) > self.cfg.affinity_max_sessions:
                self._affinity.popitem(last=False)
        self._move_counter.inc()
        self.events.emit("session_repinned", session_id=session_id,
                         replica=rep.name, via="migration")
        return True

    def _await_migrated(self, dest_url: str, migrate_id: str,
                        timeout: float, ctx=None) -> Tuple[int, dict]:
        """Pick up a migrated continuation at the destination replica:
        POST /migrate/await blocks until the imported request finishes
        and answers in the exact /generate reply shape (COMPLETE token
        list — no stitching needed)."""
        payload: dict = {"migrate_id": migrate_id, "timeout": timeout}
        if ctx is not None:
            payload["traceparent"] = ctx.child().to_traceparent()
        try:
            req = urllib.request.Request(
                dest_url + "/migrate/await",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=timeout + 5.0) as r:
                body = json.load(r)
                if not isinstance(body, dict):
                    raise ValueError(f"non-object reply: {body!r}")
                return r.status, body
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read() or b"{}")
            except (ValueError, OSError):
                return e.code, {}
        except (urllib.error.URLError, TimeoutError, ConnectionError,
                OSError, ValueError) as e:
            return -1, {
                "error": f"migrated continuation at {dest_url} "
                         f"unreachable: {e!r}",
                "code": "replica_unreachable",
            }

    @staticmethod
    def _replay_finish_reason(tokens: List[int], payload: dict,
                              remaining: int) -> Optional[str]:
        """Whether the journaled prefix ALREADY completes the request
        (the source died between finishing and replying) — replaying a
        finished generation would decode extra tokens past the stop."""
        if remaining <= 0:
            return "length"
        eos = payload.get("eos_token_id")
        if eos is not None and tokens and tokens[-1] == int(eos):
            return "eos"
        for seq in payload.get("stop") or ():
            seq = [int(tok) for tok in seq]
            if seq and tokens[-len(seq):] == seq:
                return "stop_sequence"
        return None

    def migrate_out(self, url: str) -> dict:
        """Drain a replica by MIGRATING its in-flight requests to the
        least-loaded eligible peer (the tentpole of zero-loss rolling
        restarts: drain time becomes the page-transfer time, not
        max_new_tokens' worth of decoding). Enumerates the source's
        ``GET /inflight`` and POSTs ``/migrate/export`` per request;
        each successful export flips that request's blocked /generate
        into the ``migrated`` reply, which :meth:`handle_generate`
        follows to the destination. Failed exports are counted and left
        to the replay rung — the request is never harmed. Returns the
        per-outcome counts plus ``drain_seconds`` (also observed into
        ``router_drain_seconds``)."""
        url = url.rstrip("/")
        t0 = time.monotonic()
        counts = {"migrated": 0, "finished": 0, "failed": 0}
        budget = self.cfg.migrate_budget_s
        if budget <= 0:
            return {**counts, "drain_seconds": 0.0,
                    "outcome": "migration_disabled"}
        try:
            code, text = self._http_get(
                url + "/inflight", timeout=self.cfg.probe_timeout_s
            )
            entries = (
                json.loads(text or b"{}").get("inflight", [])
                if code == 200 else []
            )
        except (OSError, ValueError):
            entries = []
        for ent in entries:
            rid = ent.get("request_id")
            if rid is None:
                continue
            if not ent.get("tokens"):
                # queued / still prefilling: nothing device-side worth
                # shipping — the replay rung resubmits it wholesale
                # when the source drains
                continue
            peers = [
                r for r in self.replicas
                if r.url != url and r.eligible()
            ]
            if not peers:
                counts["failed"] += 1
                continue
            dest = min(peers, key=lambda r: r.score())
            migrate_id = uuid.uuid4().hex
            try:
                status, body, _ = http_post_json_with_retries(
                    url + "/migrate/export",
                    {"request_id": int(rid), "dest": dest.url,
                     "migrate_id": migrate_id, "budget_s": budget},
                    timeout=budget + 10.0, max_retries=0,
                    deadline_s=budget + 10.0,
                )
            except Exception:
                status, body = -1, {}
            if status == 200 and body.get("outcome") == "migrated":
                counts["migrated"] += 1
            elif status == 200:
                counts["finished"] += 1  # completed before the export
            else:
                counts["failed"] += 1
                self.events.emit(
                    "migrate_export_failed", replica=url,
                    request_id=rid,
                    code=(body or {}).get("code"),
                )
        dt = time.monotonic() - t0
        self._drain_hist.observe(dt)
        self.events.emit("replica_drained", replica=url,
                         drain_seconds=round(dt, 3), **counts)
        return {**counts, "drain_seconds": dt}

    # -- forwarding ----------------------------------------------------

    def _forward(self, replica: Replica, payload: dict, timeout: float,
                 timeout_is_deadline: bool = False, ctx=None,
                 ) -> Tuple[int, dict, Optional[float]]:
        """POST one attempt to one replica. Returns ``(status, body,
        retry_after)``; transport failures come back as status ``-1``
        with a typed body (and count toward the replica's ejection
        streak) instead of raising — the failover loop treats them like
        a retriable 503 from a replica that told us nothing.

        ``ctx`` is the request's TraceContext: each attempt derives a
        child hop, injects it as the outgoing ``traceparent`` (the
        replica's spans parent to THIS attempt, so a retried request's
        two attempts stay distinguishable in the stitched timeline),
        and wraps the attempt in a ``forward`` span.

        ``timeout_is_deadline`` marks a timeout clamped to the
        request's remaining deadline budget: hitting it means the
        REQUEST ran out of time while the replica worked, so it maps
        to a non-retriable 504 ``deadline`` and the replica takes no
        ejection strike — three slow requests must not eject a healthy
        replica."""
        span_args = {"replica": replica.name}
        if ctx is not None:
            fwd = ctx.child()
            payload = dict(payload)
            payload["traceparent"] = fwd.to_traceparent()
            span_args.update(trace_id=ctx.trace_id, span_id=fwd.span_id,
                             parent_id=ctx.span_id)
        with replica.lock:
            replica.inflight += 1
        self._req_counter.inc(replica=replica.name)
        t0 = time.perf_counter()
        try:
            with self.tracer.span("forward", **span_args):
                faults.stall("router_replica_hang")
                req = urllib.request.Request(
                    replica.url + "/generate",
                    data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=timeout) as r:
                    body = json.load(r)
                    if not isinstance(body, dict):
                        raise ValueError(f"non-object reply: {body!r}")
                    replica.note_request_success()
                    with self._lat_lock:
                        self._latencies.append(time.perf_counter() - t0)
                    return r.status, body, None
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read() or b"{}")
            except (ValueError, OSError):
                body = {}
            replica.note_request_success()  # transport worked
            self._err_counter.inc(
                replica=replica.name,
                code=str(body.get("code", e.code)),
            )
            retry_after = None
            ra = e.headers.get("Retry-After")
            if ra is not None:
                try:
                    retry_after = float(ra)
                except ValueError:
                    pass
            return e.code, body, retry_after
        except (urllib.error.URLError, TimeoutError, ConnectionError,
                OSError, ValueError) as e:
            timed_out = isinstance(e, TimeoutError) or isinstance(
                getattr(e, "reason", None), TimeoutError
            )
            if timed_out and timeout_is_deadline:
                self._err_counter.inc(
                    replica=replica.name, code="deadline"
                )
                return 504, {
                    "error": f"request deadline expired after "
                             f"{timeout:.3f}s waiting on replica "
                             f"{replica.name}",
                    "code": "deadline",
                }, None
            # ValueError = truncated/garbage reply body — a replica
            # SIGKILLed mid-response looks like this, and it must fail
            # over like any other transport death, not surface a 500
            if replica.note_failure(time.monotonic()):
                self._eject_counter.inc(replica=replica.name)
                self.events.emit("replica_ejected",
                                 replica=replica.name, via="request",
                                 error=repr(e))
                print(f"[router] replica {replica.name} ejected "
                      f"(request transport failure: {e!r})",
                      file=sys.stderr)
            self._err_counter.inc(
                replica=replica.name, code="unreachable"
            )
            return -1, {
                "error": f"replica {replica.name} unreachable: {e!r}",
                "code": "replica_unreachable",
            }, None
        finally:
            with replica.lock:
                replica.inflight -= 1

    def _hedge_budget(self) -> Optional[float]:
        """Seconds to wait before hedging, derived from observed p99
        latency; None = hedging off."""
        if self.cfg.hedge_factor <= 0:
            return None
        with self._lat_lock:
            xs = sorted(self._latencies)
        if not xs:
            return max(self.cfg.hedge_min_s, 0.0)
        p99 = xs[min(len(xs) - 1, int(0.99 * len(xs)))]
        return max(self.cfg.hedge_min_s, self.cfg.hedge_factor * p99)

    def _attempt(self, replica: Replica, payload: dict, timeout: float,
                 exclude: Sequence[str],
                 timeout_is_deadline: bool = False, ctx=None):
        """One failover attempt, with an optional hedged twin. Returns
        ``(status, body, retry_after, replica, hedged)`` where
        ``replica`` is the one whose reply was used."""
        budget = self._hedge_budget()
        if budget is None:
            status, body, ra = self._forward(
                replica, payload, timeout, timeout_is_deadline, ctx=ctx
            )
            return status, body, ra, replica, False

        cond = threading.Condition()
        results: List[Tuple[int, dict, Optional[float], Replica]] = []
        expected = [1]

        def run(rep: Replica) -> None:
            out = self._forward(rep, payload, timeout,
                                timeout_is_deadline, ctx=ctx)
            with cond:
                results.append((*out, rep))
                cond.notify_all()

        threading.Thread(target=run, args=(replica,), daemon=True).start()
        hedged = False
        end = time.monotonic() + timeout + 1.0
        with cond:
            if not results:
                cond.wait(budget)
            if not results:
                # primary is slow: fire the hedge on a different replica
                other = self.pick(
                    exclude=tuple(exclude) + (replica.url,)
                )
                if other is not None:
                    hedged = True
                    self._hedge_counter.inc()
                    self.tracer.instant(
                        "hedge", primary=replica.name,
                        hedge=other.name,
                        **(instant_args(ctx) if ctx is not None else {}),
                    )
                    self.events.emit(
                        "request_hedged", primary=replica.name,
                        hedge=other.name,
                        trace_id=(
                            ctx.trace_id if ctx is not None else None
                        ),
                    )
                    threading.Thread(
                        target=run, args=(other,), daemon=True
                    ).start()
                    expected[0] = 2
            while True:
                if any(s == 200 for s, _, _, _ in results):
                    break
                if len(results) >= expected[0]:
                    break
                left = end - time.monotonic()
                if left <= 0 or not cond.wait(min(left, 1.0)):
                    if time.monotonic() >= end:
                        break
            done = list(results)
        for status, body, ra, rep in done:
            if status == 200:
                if hedged and rep is not replica:
                    self._hedge_win_counter.inc()
                return status, body, ra, rep, hedged
        if done:
            # no winner: report the primary's failure when it answered,
            # else whatever the hedge saw
            for status, body, ra, rep in done:
                if rep is replica:
                    return status, body, ra, rep, hedged
            status, body, ra, rep = done[0]
            return status, body, ra, rep, hedged
        return -1, {
            "error": f"replica {replica.name} did not answer in time",
            "code": "replica_unreachable",
        }, None, replica, hedged

    def _pick_for_attempt(self, session_id: Optional[str],
                          tried: Sequence[str],
                          end: Optional[float]) -> Optional[Replica]:
        """Pick with graceful degradation: prefer an un-tried eligible
        replica; fall back to RE-trying one that recovered (a rebooted
        replica beats a guaranteed failure); and when nothing at all is
        eligible, wait up to ``wait_for_replica_s`` (bounded by the
        request deadline) — that bridges the sub-second windows of a
        rolling restart where one replica is draining and the other is
        mid-re-admission."""
        wait_end = time.monotonic() + self.cfg.wait_for_replica_s
        if end is not None:
            wait_end = min(wait_end, end)
        while True:
            replica = self.pick(session_id=session_id, exclude=tried)
            if replica is None and tried:
                replica = self.pick(session_id=session_id)
            if replica is not None:
                return replica
            if time.monotonic() >= wait_end:
                return None
            self._sleep(min(
                0.05, max(0.001, wait_end - time.monotonic())
            ))

    # -- the request path ----------------------------------------------

    def _shed_retry_after(self, priority: str = "normal") -> float:
        """Retry-After seconds for a shed reply: the admission
        controller's honest fleet-capacity prediction when predictive
        admission is on, else the static configured default."""
        if self.admission is not None:
            return self.admission.retry_after_s(priority)
        return self.cfg.shed_retry_after_s

    def handle_generate(self, payload: dict) -> Tuple[int, dict, dict]:
        """Route one /generate request; returns ``(status, body,
        headers)``. Implements admission shedding, failover across
        distinct replicas under the deadline budget, Retry-After
        capping, affinity, and response attribution. Every request
        gets a trace context — client-supplied ``traceparent`` or
        minted here — propagated to the replica on each attempt and
        echoed as ``trace_id`` in every reply, success or failure."""
        ctx = trace_from_payload(payload)
        session_id = payload.get("session_id")
        if session_id is not None:
            session_id = str(session_id)
        budget = self.cfg.default_deadline_s
        try:
            client_deadline = float(payload.get("deadline_s") or 0.0)
        except (TypeError, ValueError):
            client_deadline = 0.0
        if client_deadline > 0:
            budget = (
                min(budget, client_deadline) if budget > 0
                else client_deadline
            )
        end = time.monotonic() + budget if budget > 0 else None
        priority = str(payload.get("priority") or "normal")
        if self.admission is not None:
            # proactive predictive shed: when the fleet's measured
            # service rate says this class's backlog will not clear
            # within its bound, refuse NOW with the honest wait instead
            # of burning failover attempts and the client's deadline
            decision = self.admission.admit(priority)
            if not decision.admitted:
                self._shed_counter.inc()
                self._admission_shed_counter.inc(priority=priority)
                self.events.emit(
                    "request_shed", trace_id=ctx.trace_id,
                    reason=decision.reason, priority=priority,
                    predicted_wait_s=decision.predicted_wait_s,
                )
                return 503, {
                    "error": "admission shed: " + decision.reason,
                    "code": "admission_shed",
                    "trace_id": ctx.trace_id,
                }, {"Retry-After": _fmt_secs(decision.retry_after_s)}
        shed_headers = {
            "Retry-After": _fmt_secs(self._shed_retry_after(priority))
        }
        # resume-by-replay bookkeeping: every routed request carries a
        # journal id the replica echoes in GET /inflight, so the probe
        # loop can harvest its emitted tokens. Replay needs token-level
        # prompts (text prompts stay on the plain-retry rung). Each
        # replay ATTEMPT gets a FRESH id: a replayed submission's
        # /inflight tokens are continuation-only, and harvesting them
        # under the old id would mis-position them in the journal.
        raw_prompt = payload.get("prompt_ids")
        orig_prompt = (
            [int(t) for t in raw_prompt] if raw_prompt is not None else None
        )
        jid = uuid.uuid4().hex
        payload = dict(payload)
        payload["journal_id"] = jid
        self.journal.begin(jid)
        try:
            remaining_max = int(payload.get("max_new_tokens", 16))
        except (TypeError, ValueError):
            remaining_max = 16
        cur_prompt = orig_prompt
        replay_prefix: List[int] = []
        tried: List[str] = []
        last: Optional[Tuple[int, dict, dict]] = None
        attempt = 0

        def _done(status: int, body: dict, headers: dict):
            self.journal.finish(jid)
            self._journal_bytes_gauge.set(self.journal.stats()["bytes"])
            body.setdefault("trace_id", ctx.trace_id)
            self.events.emit(
                "request_finished" if status == 200 else "request_failed",
                status=status, trace_id=ctx.trace_id, attempts=attempt,
                replica=body.get("replica"), code=body.get("code"),
            )
            return status, body, headers

        try:
            while True:
                with self.tracer.span("pick", attempt=attempt,
                                      **child_span_args(ctx)):
                    replica = self._pick_for_attempt(session_id, tried, end)
                if replica is None:
                    if last is not None:
                        return _done(*last)
                    # nothing eligible within the wait budget: shed typed
                    self._shed_counter.inc()
                    self.events.emit("request_shed", trace_id=ctx.trace_id)
                    return _done(503, {
                        "error": "no replica available "
                                 "(all ejected, draining, or not ready)",
                        "code": "no_replica",
                    }, shed_headers)
                timeout = 600.0
                timeout_is_deadline = False
                if end is not None:
                    timeout = max(0.05, end - time.monotonic())
                    timeout_is_deadline = True
                status, body, retry_after, used, hedged = self._attempt(
                    replica, payload, timeout, tried, timeout_is_deadline,
                    ctx=ctx,
                )
                attempt += 1
                if status == 200 and body.get("code") == "migrated":
                    # the source drained and live-migrated this request
                    # mid-decode: follow the continuation to the
                    # destination and collect the COMPLETE reply there.
                    # The destination can itself drain while decoding the
                    # imported continuation (one-at-a-time rolling restarts
                    # with migrate-out pre-drain do this naturally), in
                    # which case /migrate/await answers ANOTHER forwarding
                    # pointer — follow the chain hop-bounded; ONLY a 200
                    # without code=="migrated" is a real reply, anything
                    # else drops to the replay rung below.
                    dest = str(body.get("dest") or "").rstrip("/")
                    mid = str(body.get("migrate_id") or "")
                    no_pointer = {
                        "error": "migrated reply carried no destination",
                        "code": "migrate_bad_pointer",
                    }
                    astatus, abody = -1, dict(no_pointer)
                    hops = 0
                    while dest and mid:
                        hops += 1
                        if hops > self.cfg.migrate_max_hops:
                            astatus, abody = -1, {
                                "error": "migration chain exceeded "
                                         f"{self.cfg.migrate_max_hops} hops",
                                "code": "migrate_hop_limit",
                            }
                            break
                        if session_id is not None:
                            # affinity must follow the moved state
                            # immediately — every hop, not just the first
                            self.repin(session_id, dest)
                        await_t = 600.0
                        if end is not None:
                            await_t = max(0.05, end - time.monotonic())
                        astatus, abody = self._await_migrated(
                            dest, mid, await_t, ctx=ctx
                        )
                        if not (astatus == 200
                                and abody.get("code") == "migrated"):
                            break
                        self.events.emit(
                            "migrate_chained", trace_id=ctx.trace_id,
                            hop=hops, source=dest,
                            dest=str(abody.get("dest") or ""),
                        )
                        dest = str(abody.get("dest") or "").rstrip("/")
                        mid = str(abody.get("migrate_id") or "")
                        astatus, abody = -1, dict(no_pointer)
                    if astatus == 200:
                        self._migration_counter.inc(outcome="migrated")
                        if replay_prefix:
                            abody["tokens"] = (
                                replay_prefix + list(abody.get("tokens") or [])
                            )
                            abody["prompt_ids"] = orig_prompt
                        drep = next(
                            (r for r in self.replicas if r.url == dest), None
                        )
                        abody["replica"] = (
                            drep.name if drep is not None else dest
                        )
                        abody["attempts"] = attempt
                        abody["hedged"] = hedged
                        abody["migrated"] = True
                        return _done(200, abody, {})
                    # destination lost the continuation (crash between
                    # import and finish): typed, counted, and dropped into
                    # the normal retriable ladder — the replay rung below
                    # reconstructs from the journal
                    self._migration_counter.inc(outcome="migrate_failed")
                    status, body, retry_after = 503, {
                        "error": f"migrated continuation lost at {dest}: "
                                 + str(abody.get("error")
                                       or abody.get("code") or astatus),
                        "code": "migrate_await_failed",
                    }, None
                elif status == 200:
                    if replay_prefix:
                        # this attempt decoded only the tail; splice the
                        # journaled prefix back and restore the original
                        # prompt so the client sees one seamless reply
                        body["tokens"] = (
                            replay_prefix + list(body.get("tokens") or [])
                        )
                        body["prompt_ids"] = orig_prompt
                        body["replayed"] = True
                        self._migration_counter.inc(outcome="replayed")
                    body["replica"] = used.name
                    body["attempts"] = attempt
                    body["hedged"] = hedged
                    return _done(200, body, {})
                retriable = status == -1 or (
                    status == 503
                    and body.get("code") not in NON_RETRIABLE_503_CODES
                )
                if not retriable:
                    # non-recoverable (504 deadline, timeout,
                    # engine_failed, 4xx/5xx): pass through, attributed
                    body.setdefault("replica", used.name)
                    return _done(status, body, {})
                tried.append(replica.url)
                if used is not replica and used.url not in tried:
                    tried.append(used.url)  # a failed hedge also counts
                if orig_prompt is not None:
                    toks = self.journal.tokens(jid)
                    if toks:
                        # resume-by-replay: the dead attempt already
                        # emitted these tokens; resubmit prompt+prefix as
                        # a prefill with key_offset carrying the key-chain
                        # position, so the peer's continuation is
                        # bit-identical — no page transfer, no lost work
                        replay_prefix = replay_prefix + toks
                        remaining_max = max(0, remaining_max - len(toks))
                        reason = self._replay_finish_reason(
                            replay_prefix, payload, remaining_max
                        )
                        if reason is not None:
                            # the source died AFTER finishing the
                            # generation but before replying: the journal
                            # holds the complete answer — synthesize it
                            self._migration_counter.inc(outcome="replayed")
                            return _done(200, {
                                "request_id": -1,
                                "prompt_ids": orig_prompt,
                                "tokens": replay_prefix,
                                "finish_reason": reason,
                                "ttft_ms": 0.0,
                                "replayed": True,
                                "attempts": attempt,
                                "hedged": hedged,
                            }, {})
                        cur_prompt = list(cur_prompt) + toks
                        self.journal.finish(jid)
                        jid = uuid.uuid4().hex
                        self.journal.begin(jid)
                        payload = dict(payload)
                        payload["prompt_ids"] = cur_prompt
                        payload["key_offset"] = len(replay_prefix)
                        payload["max_new_tokens"] = max(1, remaining_max)
                        payload["journal_id"] = jid
                        self.events.emit(
                            "request_replayed", trace_id=ctx.trace_id,
                            journaled=len(toks),
                            total_prefix=len(replay_prefix),
                        )
                capped_ra = None
                if retry_after is not None:
                    capped_ra = min(retry_after, self.cfg.retry_after_cap_s)
                headers = {
                    "Retry-After": _fmt_secs(
                        capped_ra if capped_ra is not None
                        else self._shed_retry_after(priority)
                    )
                }
                last = (503 if status == -1 else status, body, headers)
                if attempt >= self.cfg.max_attempts:
                    return _done(*last)
                delay = backoff_delay(
                    attempt - 1, base=self.cfg.retry_base_s,
                    cap=self.cfg.retry_cap_s, retry_after=capped_ra,
                    rng=self._rng,
                )
                if end is not None and time.monotonic() + delay >= end:
                    # deadline would expire mid-backoff: surface the last
                    # typed failure instead of manufacturing a 504
                    return _done(*last)
                self._retry_counter.inc()
                self.tracer.instant(
                    "retry", attempt=attempt, failed=used.name,
                    code=str(body.get("code", status)), **instant_args(ctx),
                )
                self.events.emit(
                    "request_retried", trace_id=ctx.trace_id,
                    attempt=attempt, failed=used.name,
                    code=body.get("code"),
                )
                self._sleep(delay)
        finally:
            # EVERY exit path retires the live journal entry —
            # including an unexpected exception that bypasses
            # _done (do_POST's catch-all 500 path). finish() is
            # idempotent, so _done's accounting stays the happy
            # path and this is a no-op there; without it a
            # crashed attempt leaks its entry into _live forever
            # (ReplayJournal only evicts finished entries).
            self.journal.finish(jid)
            self._journal_bytes_gauge.set(
                self.journal.stats()["bytes"]
            )

    # -- fleet observability -------------------------------------------

    def eligible_count(self) -> int:
        n = sum(1 for r in self.replicas if r.eligible())
        self._eligible_gauge.set(n)
        return n

    def health(self) -> dict:
        return {
            "ok": self.eligible_count() > 0,
            "eligible": self.eligible_count(),
            "replicas": [r.snapshot() for r in self.replicas],
        }

    def fleet_metrics(self, now: Optional[float] = None) -> str:
        """One exposition for the whole fleet (``GET /fleet/metrics``):
        the replicas' last-probed ``/metrics`` bodies summed/labeled
        (see :func:`aggregate_fleet_metrics`) plus the router's own
        registry, plus a synthesized ``fleet_replica_up`` gauge from
        the health state machine — so one scrape answers both "how
        much work is the fleet doing" and "who is in rotation".

        Staleness is bounded and ADVERTISED: every probe-stamped body
        carries a ``fleet_scrape_age_seconds{replica=...}`` gauge, and
        bodies older than ``cfg.metrics_max_age_s`` (a blackholed or
        wedged replica whose last scrape is ancient) are EXCLUDED from
        the aggregate rather than silently served as current — a
        consumer judging SLO burn must see the replica as missing, not
        as healthy-at-its-last-good-moment. Bodies with no stamp
        (installed out-of-band, age unknowable) stay included for
        back-compat."""
        bodies: Dict[str, str] = {}
        up_lines = ["# TYPE fleet_replica_up gauge"]
        age_lines = ["# TYPE fleet_scrape_age_seconds gauge"]
        max_age = self.cfg.metrics_max_age_s
        now = time.monotonic() if now is None else now
        for r in self.replicas:
            with r.lock:
                text = r.metrics_text
                state = r.state
                stamped_t = r.metrics_t
            age = None if stamped_t is None else max(0.0, now - stamped_t)
            if age is not None:
                age_lines.append(
                    f'fleet_scrape_age_seconds{{replica="{r.name}"}}'
                    f" {age:.3f}"
                )
            if text and (age is None or max_age <= 0 or age <= max_age):
                bodies[r.name] = text
            up_lines.append(
                f'fleet_replica_up{{replica="{r.name}",'
                f'state="{state}"}} {1 if state == UP else 0}'
            )
        own = (
            self.registry.render()
            + "\n".join(up_lines) + "\n"
            + ("\n".join(age_lines) + "\n" if len(age_lines) > 1 else "")
        )
        return aggregate_fleet_metrics(bodies, own=own)


def _fmt_secs(secs: float) -> str:
    """Retry-After header value: integer seconds, floored at 1 (the
    header is delta-seconds; 0 invites an instant re-pile-on)."""
    return str(max(1, int(secs)))


def _make_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict,
                   headers: Optional[dict] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/metrics", "/fleet/metrics"):
                # /metrics = the router's own registry; /fleet/metrics
                # = one scrape target for the whole fleet (per-replica
                # bodies summed/labeled from the probe loop's parses)
                text = (
                    router.registry.render() if self.path == "/metrics"
                    else router.fleet_metrics()
                )
                body = text.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", METRICS_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/health":
                self._reply(200, router.health())
            elif self.path == "/ready":
                n = router.eligible_count()
                if n > 0:
                    self._reply(200, {"ready": True, "eligible": n})
                else:
                    self._reply(
                        503, {"ready": False, "eligible": 0},
                        headers={"Retry-After": _fmt_secs(
                            router.cfg.shed_retry_after_s
                        )},
                    )
            else:
                self._reply(404, {"error": f"unknown path {self.path}",
                                  "code": "bad_request"})

        def do_POST(self):
            if self.path not in ("/generate", "/drain"):
                self._reply(404, {"error": f"unknown path {self.path}",
                                  "code": "bad_request"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("request body must be a JSON object")
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e), "code": "bad_request"})
                return
            if self.path == "/drain":
                # migrate a replica's in-flight requests to peers —
                # serving/fleet.py calls this before a rolling restart
                url = str(payload.get("replica") or "").rstrip("/")
                if not url:
                    self._reply(400, {"error": "missing 'replica' url",
                                      "code": "bad_request"})
                    return
                try:
                    self._reply(200, router.migrate_out(url))
                except Exception as e:
                    self._reply(500, {"error": f"drain error: {e!r}",
                                      "code": "internal"})
                return
            try:
                status, body, headers = router.handle_generate(payload)
            except Exception as e:  # router bug: typed 500, keep serving
                self._reply(500, {"error": f"router error: {e!r}",
                                  "code": "internal"})
                return
            self._reply(status, body, headers)

        def log_message(self, *a):  # quiet by default
            pass

    return Handler


def serve_router(router: Router, host: str = "127.0.0.1",
                 port: int = 8000) -> ThreadingHTTPServer:
    """Build the router's HTTP server (not yet serving; call
    serve_forever())."""
    return ThreadingHTTPServer((host, port), _make_handler(router))


def main() -> None:
    """CLI: route traffic over already-running replicas (serving/fleet.py
    launches replicas AND a router in one command)."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--target", action="append", required=True,
                   help="replica base URL (repeat per replica), e.g. "
                        "http://127.0.0.1:8101")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--probe-interval", type=float, default=0.5)
    p.add_argument("--eject-after", type=int, default=3)
    p.add_argument("--readmit-after", type=int, default=2)
    p.add_argument("--max-attempts", type=int, default=3)
    p.add_argument("--deadline", type=float, default=120.0,
                   help="total per-request budget in seconds (0 = none)")
    p.add_argument("--hedge-factor", type=float, default=0.0,
                   help="hedge a request stuck past this multiple of "
                        "observed p99 latency (0 = hedging off)")
    p.add_argument("--hedge-min", type=float, default=0.25)
    p.add_argument("--trace-path", default=None,
                   help="write a Chrome-trace-event JSON of "
                        "pick/forward/retry/hedge spans (stitch with "
                        "replica traces via tools/trace_stitch.py)")
    p.add_argument("--event-log", default=None,
                   help="append structured JSONL events (request "
                        "finished/failed/retried, replica ejection/"
                        "re-admission; obs/events.py)")
    args = p.parse_args()

    cfg = RouterConfig(
        probe_interval_s=args.probe_interval,
        eject_after=args.eject_after,
        readmit_after=args.readmit_after,
        max_attempts=args.max_attempts,
        default_deadline_s=args.deadline,
        hedge_factor=args.hedge_factor,
        hedge_min_s=args.hedge_min,
    )
    tracer = None
    if args.trace_path:
        from differential_transformer_replication_tpu_torch.obs.spans import (
            SpanTracer,
        )

        tracer = SpanTracer(args.trace_path, process_name="router")
    events = None
    if args.event_log:
        from differential_transformer_replication_tpu_torch.obs.events import (
            EventLog,
        )

        events = EventLog(args.event_log, process="router")
    router = Router(args.target, cfg, tracer=tracer,
                    events=events).start()
    httpd = serve_router(router, args.host, args.port)
    print(f"[router] fronting {len(router.replicas)} replicas — "
          f"POST http://{args.host}:{args.port}/generate, fleet state "
          f"at GET http://{args.host}:{args.port}/health, one-scrape "
          f"fleet metrics at GET /fleet/metrics")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        router.close()
        if tracer is not None:
            tracer.close()
        if events is not None:
            events.close()


if __name__ == "__main__":
    main()
