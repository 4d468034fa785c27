"""Predictive admission: honest Retry-After from fleet-wide capacity.

The router's original shed paths answered backpressure with a STATIC
``Retry-After`` (``RouterConfig.shed_retry_after_s``) — a constant that
is honest only by accident. A saturated fleet that will take 20 s to
drain its backlog telling clients "retry in 1 s" manufactures a retry
storm; one that will recover in 200 ms telling them "retry in 30 s"
manufactures an outage. This module computes the truthful number from
two quantities the fleet already measures (the Kwon et al. 2023 stance
— admission must key on TRUE capacity, not per-replica queue bounds):

- **backlog ahead of this request** — requests already running (slot
  occupancy, fleet-wide) plus requests queued in priority classes at
  or above the new request's class (``serving_queue_depth_by_class``;
  the priority scheduler admits strictly by effective rank, so a batch
  request waits behind every queued high/normal request but a high
  request only waits behind other highs);
- **measured service rate** — an EWMA of fleet-wide request
  completions per second, read as deltas of the replicas'
  ``serving_requests_completed_total`` counters between probes
  (restart-safe: a counter that goes backwards contributes zero, not a
  negative rate).

``predicted wait = backlog_ahead / service_rate`` — per priority
class, fleet-wide. The router uses it two ways:

1. every shed (``no_replica``, exhausted failover, proactive) carries
   ``Retry-After = clamp(predicted wait)`` instead of the static
   default;
2. with ``admission_wait_bound_s > 0``, requests whose predicted wait
   exceeds their class bound (high 2x, normal 1x, batch 0.5x — batch
   sheds first, high last) are shed AT ADMISSION with that honest
   header, before they burn a failover attempt on a fleet that cannot
   serve them in time.

The controller is fed by the router's existing probe loop
(:meth:`observe_replica` with each replica's scraped ``/metrics``
body) — no new network traffic. Pure stdlib, no torch: the math
functions are module-level and the whole state machine runs on
injected clocks/expositions in tests/test_torch_admission.py.

A copy of the JAX package's ``serving/admission.py``: the same math,
class multipliers, gauges and rulings, so both routers shed alike on
the same expositions.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from differential_transformer_replication_tpu_torch.config import RouterConfig
from differential_transformer_replication_tpu_torch.obs.registry import (
    parse_exposition,
)
from differential_transformer_replication_tpu_torch.serving.request import (
    PRIORITY_CLASSES,
    PRIORITY_RANK,
)

# Proactive-shed bound multipliers: a class's tolerated predicted wait
# is admission_wait_bound_s * this. Batch tolerates half the base bound
# (sheds first), high twice it (sheds last) — the same ordering the
# engine's priority scheduler enforces once a request is admitted.
CLASS_WAIT_MULT = {"high": 2.0, "normal": 1.0, "batch": 0.5}


# -- the pure math (the test suite's Retry-After oracle drives these) ---


def backlog_ahead(queued_by_class: Dict[str, float], running: float,
                  priority: str) -> float:
    """Requests a NEW ``priority``-class arrival waits behind: everything
    already running plus every queued request in a class of equal or
    higher priority (lower rank). Unknown classes rank as "normal"."""
    rank = PRIORITY_RANK.get(priority, PRIORITY_RANK["normal"])
    queued = sum(
        max(0.0, count) for cls, count in queued_by_class.items()
        if PRIORITY_RANK.get(cls, PRIORITY_RANK["normal"]) <= rank
    )
    return max(0.0, running) + queued


def predicted_wait_s(backlog: float,
                     service_rate: Optional[float]) -> Optional[float]:
    """Seconds until the fleet has worked off ``backlog`` requests at
    the measured rate; None when no rate has been measured yet (no
    traffic history is not the same as infinite capacity)."""
    if service_rate is None or service_rate <= 0:
        return None
    return max(0.0, backlog) / service_rate


def honest_retry_after(wait_s: Optional[float], fallback_s: float,
                       cap_s: float) -> float:
    """The Retry-After value for a shed: the predicted wait, floored at
    1 s (the header is delta-seconds; 0 invites an instant re-pile-on)
    and capped (a deep backlog must read "come back soon and re-ask",
    not "come back in an hour"). Falls back to the static default when
    no wait could be predicted."""
    if wait_s is None:
        return max(1.0, fallback_s)
    return max(1.0, min(wait_s, cap_s))


@dataclass
class AdmissionDecision:
    """One admission ruling: ``admitted`` False means shed NOW with
    ``retry_after_s`` (honest), for ``reason``."""

    admitted: bool
    retry_after_s: float
    predicted_wait_s: Optional[float]
    reason: str = ""


class _RateEWMA:
    """EWMA of a rate sampled from an event accumulator at irregular
    intervals: alpha adapts to the gap (halflife semantics), so a
    slow probe cadence does not under-weight fresh evidence."""

    def __init__(self, halflife_s: float):
        self.halflife_s = max(1e-6, halflife_s)
        self.value: Optional[float] = None
        self._last_t: Optional[float] = None
        self._last_acc = 0.0

    def sample(self, acc: float, now: float) -> Optional[float]:
        if self._last_t is None:
            self._last_t, self._last_acc = now, acc
            return self.value
        dt = now - self._last_t
        if dt < 0.05:  # too close to measure a rate
            return self.value
        rate = max(0.0, acc - self._last_acc) / dt
        self._last_t, self._last_acc = now, acc
        alpha = 1.0 - 0.5 ** (dt / self.halflife_s)
        self.value = (
            rate if self.value is None
            else self.value + alpha * (rate - self.value)
        )
        return self.value


class AdmissionController:
    """Fleet-capacity admission state fed by the router's probe loop.

    ``observe_replica(name, exposition, now)`` ingests one replica's
    freshly scraped ``/metrics`` body (queue depths per class, slot
    occupancy, completion counter); ``retry_after_s``/``admit`` answer
    from the aggregate. All clocks are injectable and every ruling is
    derived from the pure functions above, so decisions replay
    bit-identically from recorded expositions."""

    def __init__(self, cfg: RouterConfig, registry=None,
                 now_fn: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self._now = now_fn
        self._lock = threading.Lock()
        # per-replica parsed state: name -> dict(queued_by_class,
        # running, completed_total)
        self._replicas: Dict[str, dict] = {}
        self._completed_acc = 0.0  # fleet completions, restart-safe
        self._rate = _RateEWMA(cfg.admission_rate_halflife_s)
        self._wait_gauge = None
        self._rate_gauge = None
        if registry is not None:
            self._wait_gauge = registry.gauge(
                "admission_predicted_wait_seconds",
                "Predicted wait for a NEW request of this priority "
                "class (fleet backlog ahead of it / measured service "
                "rate).",
                labelnames=("priority",),
            )
            self._rate_gauge = registry.gauge(
                "admission_service_rate",
                "Measured fleet service rate (completed requests/sec, "
                "EWMA over probe-window counter deltas).",
            )

    # -- ingest (router probe loop) ------------------------------------

    def observe_replica(self, name: str, exposition: str,
                        now: Optional[float] = None) -> None:
        """Ingest one replica's freshly scraped /metrics body."""
        now = self._now() if now is None else now
        _, samples = parse_exposition(exposition)
        queued_by_class: Dict[str, float] = {}
        queue_total = 0.0
        running = 0.0
        completed = 0.0
        for sample_name, labels, value in samples:
            if sample_name == "serving_queue_depth_by_class":
                cls = labels.get("priority", "normal")
                queued_by_class[cls] = (
                    queued_by_class.get(cls, 0.0) + value
                )
            elif sample_name == "serving_queue_depth":
                queue_total += value
            elif sample_name == "serving_slot_occupancy":
                running += value
            elif sample_name == "serving_requests_completed_total":
                completed += value
        if not queued_by_class and queue_total > 0:
            # a replica without per-class depth gauges (older build):
            # count its whole queue as "normal"
            queued_by_class["normal"] = queue_total
        with self._lock:
            prev = self._replicas.get(name)
            if prev is not None:
                # restart-safe: a counter that went backwards (replica
                # relaunch) contributes zero this window, not negative
                self._completed_acc += max(
                    0.0, completed - prev["completed_total"]
                )
            self._replicas[name] = {
                "queued_by_class": queued_by_class,
                "running": running,
                "completed_total": completed,
            }
            rate = self._rate.sample(self._completed_acc, now)
            if self._rate_gauge is not None and rate is not None:
                self._rate_gauge.set(rate)
            if self._wait_gauge is not None:
                for cls in PRIORITY_CLASSES:
                    wait = self._predicted_wait_locked(cls)
                    if wait is not None:
                        self._wait_gauge.set(wait, priority=cls)

    def forget_replica(self, name: str) -> None:
        """Drop a scaled-away/removed replica's contribution (its
        counters leave the rate accumulator's baseline too)."""
        with self._lock:
            self._replicas.pop(name, None)

    # -- the rulings ---------------------------------------------------

    def _aggregate_locked(self) -> tuple:
        queued: Dict[str, float] = {}
        running = 0.0
        for state in self._replicas.values():
            running += state["running"]
            for cls, count in state["queued_by_class"].items():
                queued[cls] = queued.get(cls, 0.0) + count
        return queued, running

    def _predicted_wait_locked(self, priority: str) -> Optional[float]:
        queued, running = self._aggregate_locked()
        return predicted_wait_s(
            backlog_ahead(queued, running, priority), self._rate.value
        )

    def service_rate(self) -> Optional[float]:
        with self._lock:
            return self._rate.value

    def predicted_wait(self, priority: str = "normal") -> Optional[float]:
        with self._lock:
            return self._predicted_wait_locked(priority)

    def retry_after_s(self, priority: str = "normal") -> float:
        """The honest Retry-After for shedding a ``priority`` request
        right now (static fallback until a rate is measured)."""
        return honest_retry_after(
            self.predicted_wait(priority),
            fallback_s=self.cfg.shed_retry_after_s,
            cap_s=self.cfg.admission_max_retry_after_s,
        )

    def admit(self, priority: str = "normal") -> AdmissionDecision:
        """Proactive ruling for one arriving request. Only sheds when
        ``admission_wait_bound_s`` is set AND the predicted wait for
        this class exceeds its bound — an unmeasured fleet admits."""
        wait = self.predicted_wait(priority)
        bound = self.cfg.admission_wait_bound_s
        if bound > 0 and wait is not None:
            limit = bound * CLASS_WAIT_MULT.get(priority, 1.0)
            if wait > limit:
                return AdmissionDecision(
                    admitted=False,
                    retry_after_s=honest_retry_after(
                        wait, self.cfg.shed_retry_after_s,
                        self.cfg.admission_max_retry_after_s,
                    ),
                    predicted_wait_s=wait,
                    reason=(
                        f"predicted wait {wait:.2f}s exceeds the "
                        f"{priority}-class bound {limit:.2f}s"
                    ),
                )
        return AdmissionDecision(
            admitted=True,
            retry_after_s=honest_retry_after(
                wait, self.cfg.shed_retry_after_s,
                self.cfg.admission_max_retry_after_s,
            ),
            predicted_wait_s=wait,
        )
