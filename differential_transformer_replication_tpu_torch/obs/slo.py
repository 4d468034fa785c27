"""SLO objectives and burn rates computed from registry histograms.

The metrics layer (obs/registry.py) answers "what happened"; this
module answers the operator question a fleet is actually run by: "are
we meeting our objectives, and how fast are we burning the error
budget?" — the standard SRE framing:

- a **latency objective** says "``target`` of requests complete under
  ``threshold_s``" (e.g. 99% of TTFTs under 500 ms). The error ratio
  is the fraction of observations ABOVE the threshold, read from the
  cumulative histogram the engine already populates;
- an **availability objective** says "``target`` of requests succeed",
  with good/bad drawn from outcome counters;
- the **burn rate** is ``error_ratio / (1 - target)``: 1.0 means the
  budget is being spent exactly as provisioned; >1 means the service
  will blow its objective (Google SRE workbook's multi-window alerts
  gate on exactly this number).

:class:`SLOMonitor` evaluates objectives against a live registry and
re-exposes the results AS gauges (``slo_burn_rate`` /
``slo_error_ratio`` / ``slo_target``) in the same registry, so every
scrape of ``/metrics`` (or the router's ``/fleet/metrics``) carries
the judgment alongside the raw data, and ``tools/slo_report.py
--check`` can gate CI on it. Counters and histograms are cumulative,
so the monitor reports both the lifetime burn and the burn over the
window since its previous evaluation (the signal that catches a
regression mid-run).

Bucket-boundary honesty: a histogram only knows bucket edges, so the
error ratio counts as GOOD only observations provably at or under the
largest bucket bound <= ``threshold_s`` — a threshold between edges
rounds conservatively (reports at-least-this-much burn, never less).
Stdlib only, no jax.

A copy of the JAX package's ``obs/slo.py``: the same objectives,
burn-rate math and ``slo_*`` gauges over the port's registry.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_right
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from differential_transformer_replication_tpu_torch.obs.registry import (
    Registry,
)


@dataclass(frozen=True)
class LatencyObjective:
    """``target`` fraction of ``histogram`` observations <= ``threshold_s``."""

    name: str            # objective label, e.g. "ttft"
    histogram: str       # registry histogram name
    threshold_s: float   # latency bound (aligns best with a bucket edge)
    target: float        # e.g. 0.99
    # label selector for a labeled histogram child, e.g.
    # (("priority", "high"),) to read one priority class's ladder from
    # serving_class_ttft_seconds. Empty = the unlabeled histogram.
    labels: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"target must be in (0, 1), got {self.target}"
            )
        if self.threshold_s <= 0:
            raise ValueError(
                f"threshold_s must be > 0, got {self.threshold_s}"
            )


@dataclass(frozen=True)
class AvailabilityObjective:
    """``target`` fraction of outcomes in ``good`` vs ``good``+``bad``
    counters (unlabeled registry counters, summed per side)."""

    name: str
    good: Tuple[str, ...]
    bad: Tuple[str, ...]
    target: float = 0.999

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"target must be in (0, 1), got {self.target}"
            )


# -- the pure math (hand-checkable; tests/test_trace.py drives it) ------


def good_count_under(bounds: Sequence[float],
                     cumulative: Sequence[float],
                     threshold_s: float) -> float:
    """Observations provably <= ``threshold_s``: the cumulative count
    at the largest bucket bound <= the threshold (0 when the threshold
    sits below every bound — nothing is provably fast enough)."""
    i = bisect_right(list(bounds), threshold_s)
    return float(cumulative[i - 1]) if i > 0 else 0.0


def latency_error_ratio(bounds: Sequence[float],
                        cumulative: Sequence[float],
                        count: float,
                        threshold_s: float) -> Optional[float]:
    """Fraction of observations above the threshold; None when the
    histogram is empty (no traffic is not the same as perfect)."""
    if count <= 0:
        return None
    good = good_count_under(bounds, cumulative, threshold_s)
    return max(0.0, (count - good) / count)


def burn_rate(error_ratio: Optional[float],
              target: float) -> Optional[float]:
    """``error_ratio / (1 - target)``; None rides through."""
    if error_ratio is None:
        return None
    budget = 1.0 - target
    if budget <= 0:
        return math.inf if error_ratio > 0 else 0.0
    return error_ratio / budget


def histogram_from_samples(samples, name: str,
                           match: Optional[Dict[str, str]] = None):
    """Rebuild ``(bounds, cumulative, count)`` for one histogram from
    parsed exposition samples (obs/registry.py:parse_exposition) — the
    scrape-side twin of ``Histogram.snapshot`` that
    tools/slo_report.py uses on a saved or fetched /metrics body.
    Samples surviving the ``match`` filter are SUMMED per bucket bound
    across label children, so a labeled histogram (or a fleet body
    whose gauged buckets carry per-replica labels) aggregates to one
    valid histogram instead of interleaving children's ladders —
    sound because cumulative bucket counts are themselves counters."""
    by_bound: Dict[float, float] = {}
    count = 0.0
    for n, labels, value in samples:
        extra = dict(labels)
        le = extra.pop("le", None)
        if match and any(extra.get(k) != v for k, v in match.items()):
            continue
        if n == f"{name}_bucket" and le is not None:
            bound = math.inf if le == "+Inf" else float(le)
            by_bound[bound] = by_bound.get(bound, 0.0) + value
        elif n == f"{name}_count":
            count += value
    bounds = sorted(b for b in by_bound if not math.isinf(b))
    cumulative = [by_bound[b] for b in bounds]
    return bounds, cumulative, count


# -- the live monitor ---------------------------------------------------


@dataclass
class _Window:
    """Previous-evaluation snapshot for windowed burn."""

    good: float = 0.0
    count: float = 0.0


class SLOMonitor:
    """Evaluate objectives against a registry; see module docstring.

    The monitor reads AND writes one registry: objective inputs come
    from the instrumented histograms/counters, results land in
    ``slo_*`` gauges labeled by objective. ``evaluate()`` is cheap
    (a few snapshots) — the serving server runs it on every /metrics
    scrape so the gauges are always current at scrape time.
    """

    def __init__(self, registry: Registry,
                 latency: Sequence[LatencyObjective] = (),
                 availability: Sequence[AvailabilityObjective] = ()):
        self.registry = registry
        self.latency = tuple(latency)
        self.availability = tuple(availability)
        names = [o.name for o in self.latency + self.availability]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names in {names}")
        self._windows: Dict[str, _Window] = {
            name: _Window() for name in names
        }
        # evaluate() runs from ThreadingHTTPServer handler threads
        # (every /metrics scrape): the window read-modify-write and the
        # paired gauge publishes must not interleave between two
        # concurrent scrapers
        self._lock = threading.Lock()
        reg = registry
        self._target_gauge = reg.gauge(
            "slo_target",
            "Configured objective target (fraction good).",
            labelnames=("objective",),
        )
        self._threshold_gauge = reg.gauge(
            "slo_latency_threshold_seconds",
            "Configured latency bound per latency objective.",
            labelnames=("objective",),
        )
        self._error_gauge = reg.gauge(
            "slo_error_ratio",
            "Observed lifetime fraction of objective violations.",
            labelnames=("objective",),
        )
        self._burn_gauge = reg.gauge(
            "slo_burn_rate",
            "Lifetime error-budget burn rate (error_ratio / budget; "
            ">1 = the objective is being missed).",
            labelnames=("objective",),
        )
        self._burn_window_gauge = reg.gauge(
            "slo_burn_rate_window",
            "Burn rate over the window since the previous evaluation "
            "(the fast regression signal).",
            labelnames=("objective",),
        )
        for o in self.latency:
            self._target_gauge.set(o.target, objective=o.name)
            self._threshold_gauge.set(o.threshold_s, objective=o.name)
        for o in self.availability:
            self._target_gauge.set(o.target, objective=o.name)

    def _publish(self, name: str, target: float,
                 good: float, count: float) -> dict:
        err = None if count <= 0 else max(0.0, (count - good) / count)
        w = self._windows[name]
        d_count = count - w.count
        d_good = good - w.good
        w_err = (
            None if d_count <= 0
            else max(0.0, (d_count - d_good) / d_count)
        )
        self._windows[name] = _Window(good=good, count=count)
        out = {
            "target": target,
            "count": count,
            "error_ratio": err,
            "burn_rate": burn_rate(err, target),
            "window_count": max(0.0, d_count),
            "window_error_ratio": w_err,
            "window_burn_rate": burn_rate(w_err, target),
        }
        if err is not None:
            self._error_gauge.set(err, objective=name)
            self._burn_gauge.set(out["burn_rate"], objective=name)
        if w_err is not None:
            self._burn_window_gauge.set(
                out["window_burn_rate"], objective=name
            )
        return out

    def evaluate(self) -> Dict[str, dict]:
        """Compute every objective, refresh the ``slo_*`` gauges, and
        return ``{objective: {error_ratio, burn_rate, ...}}``.
        Serialized: concurrent scrapers each get a consistent window
        instead of double-counting (or zero-counting) one interval."""
        with self._lock:
            out: Dict[str, dict] = {}
            for o in self.latency:
                # a labeled objective must re-fetch the histogram with
                # the SAME labelnames tuple it was registered under
                # (the registry enforces one tuple per name forever)
                hist = self.registry.histogram(
                    o.histogram,
                    labelnames=tuple(k for k, _ in o.labels),
                )
                snap = hist.snapshot(**dict(o.labels))
                bounds, cumulative = snap["buckets"], snap["cumulative"]
                good = good_count_under(bounds, cumulative,
                                        o.threshold_s)
                out[o.name] = self._publish(
                    o.name, o.target, good, float(snap["count"])
                )
                out[o.name]["threshold_s"] = o.threshold_s
            for o in self.availability:
                good = sum(
                    self.registry.counter(n).value for n in o.good
                )
                bad = sum(
                    self.registry.counter(n).value for n in o.bad
                )
                out[o.name] = self._publish(
                    o.name, o.target, good, good + bad
                )
            return out


def default_serving_objectives(
    ttft_threshold_s: float = 1.0,
    itl_threshold_s: float = 0.25,
    latency_target: float = 0.99,
    availability_target: float = 0.999,
    priority_classes: Sequence[str] = ("high", "normal", "batch"),
) -> Tuple[List[LatencyObjective], List[AvailabilityObjective]]:
    """The serving stack's stock objectives over the engine's existing
    metrics (serving/engine.py names), used by the server CLI knobs.

    Beyond the aggregate ttft/itl objectives, one TTFT and one ITL
    objective per priority class rides along (over the engine's
    ``serving_class_*`` histograms), so burn rates are visible
    per-class: under KV pressure the whole point of the priority
    scheduler is that "high" keeps its budget while "batch" burns.
    Classes with no traffic report no error ratio (None), so unused
    classes never alarm. Pass ``priority_classes=()`` to disable."""
    latency = [
        LatencyObjective("ttft", "serving_ttft_seconds",
                         ttft_threshold_s, latency_target),
        LatencyObjective("itl", "serving_itl_seconds",
                         itl_threshold_s, latency_target),
    ]
    for cls in priority_classes:
        latency.append(LatencyObjective(
            f"ttft_{cls}", "serving_class_ttft_seconds",
            ttft_threshold_s, latency_target,
            labels=(("priority", cls),),
        ))
        latency.append(LatencyObjective(
            f"itl_{cls}", "serving_class_itl_seconds",
            itl_threshold_s, latency_target,
            labels=(("priority", cls),),
        ))
    availability = [
        AvailabilityObjective(
            "availability",
            good=("serving_requests_completed_total",),
            bad=("serving_requests_rejected_total",
                 "serving_requests_deadline_expired_total"),
            target=availability_target,
        ),
    ]
    return latency, availability
