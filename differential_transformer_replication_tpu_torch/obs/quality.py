"""Model-quality observability: fingerprints + drift scores.

Every observability layer before this one watches *time* (latency
histograms, SLO burn, device profiles). This module watches *tokens*:
the per-token quality signals the jitted decode step already computes
(sampled-distribution entropy, top-1 logit margin — models/decode.py:
quality_vector) are folded into fixed-bin quantile sketches, and a
sketch recorded from a known-good window becomes a reference
**fingerprint** that live traffic is compared against with a
PSI-style drift score (``serving_quality_drift`` on /metrics).

Why PSI (population stability index) and not a mean delta: a broken
int8 scale or a collapsed λ schedule shifts the SHAPE of the entropy/
margin distributions long before it moves their means — PSI over
fixed bins (``sum((p-q) * ln(p/q))`` with smoothing) is the standard
credit-risk/ML-monitoring statistic for exactly that, is O(bins) to
compare, and needs no raw-sample retention. Conventional reading:
< 0.1 stable, 0.1-0.25 drifting, > 0.25 shifted — the default canary
budget (AutoscalerConfig.canary_max_drift) sits at the upper knee.

Degradation contract ("no signal", never a crash): non-finite
observations are SKIPPED at ``add``, a sketch with fewer than
``MIN_DRIFT_COUNT`` live observations scores 0.0, and a missing
reference scores 0.0 — a NaN-poisoned quality tail (``quality_nan``
fault) degrades telemetry to silence while decode keeps stepping.

Stdlib only — no jax, no numpy — so the control plane
(tools/autoscaler.py, tools/slo_report.py) and tests can import it
without device initialization, same posture as obs/registry.py.

A copy of the JAX package's ``obs/quality.py``: the same sketches, PSI
and fingerprint JSON, so a fingerprint recorded by either package loads
in the other.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional, Sequence

# Fixed bin ladders. Entropy of a categorical over V tokens lives in
# [0, ln V] — ~11 nats covers V = 60k; margins are logit differences,
# a few nats for a confident model, tens for a peaked one. Fixed (not
# data-derived) edges keep reference and live sketches comparable
# across processes and releases without negotiating bins.
ENTROPY_BINS = (0.05, 0.1, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5,
                3.0, 4.0, 5.0, 6.0, 8.0, 11.0)
MARGIN_BINS = (0.05, 0.125, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0,
               4.0, 6.0, 8.0, 12.0, 16.0, 24.0)

# Below this many live observations a drift score is noise, not
# signal: PSI with heavy smoothing on a handful of tokens swings past
# any sane budget. The judge treats "too thin" as 0.0 (no signal).
MIN_DRIFT_COUNT = 32

# Laplace-style smoothing mass per bin when comparing sketches: keeps
# ln(p/q) finite when a bin is empty on one side.
_PSI_EPS = 1e-4

FINGERPRINT_RECORD = "quality_fingerprint"


class QuantileSketch:
    """Fixed-bin histogram sketch of one quality signal.

    ``bins`` are upper bounds of the first ``len(bins)`` buckets; one
    overflow bucket rides at the end (counts length ``len(bins)+1``).
    Non-finite values are dropped at ``add`` — "no signal" — so a NaN
    entropy can never poison a fingerprint or a drift score.
    """

    __slots__ = ("bins", "counts", "total", "_sum")

    def __init__(self, bins: Sequence[float]):
        bins = tuple(float(b) for b in bins)
        if list(bins) != sorted(bins) or len(set(bins)) != len(bins):
            raise ValueError(f"bins must be strictly increasing: {bins}")
        self.bins = bins
        self.counts = [0] * (len(bins) + 1)
        self.total = 0
        self._sum = 0.0

    def add(self, value: float) -> bool:
        """Fold one observation in; returns False (skipped) for
        non-finite values."""
        try:
            v = float(value)
        except (TypeError, ValueError):
            return False
        if not math.isfinite(v):
            return False
        lo, hi = 0, len(self.bins)
        while lo < hi:  # first bound >= v (bisect, stdlib-only)
            mid = (lo + hi) // 2
            if self.bins[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1
        self.total += 1
        self._sum += v
        return True

    def mean(self) -> Optional[float]:
        return self._sum / self.total if self.total else None

    def probs(self) -> list:
        """Smoothed bucket probabilities (sum to 1, never zero)."""
        n = len(self.counts)
        denom = self.total + n * _PSI_EPS
        return [(c + _PSI_EPS) / denom for c in self.counts]

    def to_dict(self) -> dict:
        return {
            "bins": list(self.bins),
            "counts": list(self.counts),
            "sum": self._sum,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "QuantileSketch":
        sk = cls(d["bins"])
        counts = [int(c) for c in d.get("counts", [])]
        if len(counts) != len(sk.counts):
            raise ValueError(
                f"sketch counts length {len(counts)} does not match "
                f"{len(sk.bins)} bins"
            )
        sk.counts = counts
        sk.total = sum(counts)
        sk._sum = float(d.get("sum", 0.0))
        return sk


def psi(reference: QuantileSketch, live: QuantileSketch) -> float:
    """Population stability index between two same-bin sketches.

    0.0 = identical shapes; conventional thresholds in the module
    docstring. Raises on mismatched bin ladders (a fingerprint from a
    different release of the ladder must fail loudly, not compare
    garbage bins)."""
    if reference.bins != live.bins:
        raise ValueError(
            "sketch bin ladders differ: "
            f"{reference.bins} vs {live.bins}"
        )
    score = 0.0
    for p, q in zip(live.probs(), reference.probs()):
        score += (p - q) * math.log(p / q)
    return score


def drift_score(reference: Optional[dict], live: Dict[str, QuantileSketch],
                min_count: int = MIN_DRIFT_COUNT) -> float:
    """Max PSI across the signals both sides carry; 0.0 when there is
    no reference or the live evidence is too thin ("no signal" is not
    drift). ``reference`` is a fingerprint dict (:func:`fingerprint` /
    :func:`load_fingerprint`)."""
    if not reference:
        return 0.0
    worst = 0.0
    for name, sk in live.items():
        ref = reference.get("sketches", {}).get(name)
        if ref is None or sk.total < min_count:
            continue
        try:
            worst = max(worst, psi(QuantileSketch.from_dict(ref), sk))
        except ValueError:
            # incompatible ladder: report maximal drift rather than
            # silently passing a fingerprint that cannot be compared
            return float(math.inf)
    return worst


def fingerprint(sketches: Dict[str, QuantileSketch],
                meta: Optional[dict] = None) -> dict:
    """Serializable reference fingerprint from live sketches."""
    rec = {
        "record": FINGERPRINT_RECORD,
        "sketches": {k: sk.to_dict() for k, sk in sketches.items()},
    }
    if meta:
        rec["meta"] = dict(meta)
    return rec


def save_fingerprint(path: str, rec: dict) -> None:
    """Atomic single-JSON write (tmp + rename), so a crash mid-record
    never leaves a torn reference for the fleet to judge against."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(rec, fh)
    os.replace(tmp, path)


def load_fingerprint(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        rec = json.load(fh)
    if rec.get("record") != FINGERPRINT_RECORD:
        raise ValueError(
            f"{path} is not a quality fingerprint "
            f"(record={rec.get('record')!r})"
        )
    return rec


class QualityMonitor:
    """Live entropy/margin sketches + drift vs an optional reference.

    The engine owns one of these when quality telemetry is on: every
    emitted token's finite signals fold in via :meth:`observe`, the
    gauge-refresh path reads :meth:`drift`, and ``--quality-record``
    snapshots :meth:`fingerprint` at drain. Host-side and unlocked —
    all calls happen on the engine thread, like the StatsMap."""

    def __init__(self, reference: Optional[dict] = None):
        self.reference = reference
        self.entropy = QuantileSketch(ENTROPY_BINS)
        self.margin = QuantileSketch(MARGIN_BINS)
        self.skipped = 0  # non-finite observations ("no signal")

    def observe(self, entropy: float, margin: float) -> None:
        if not self.entropy.add(entropy):
            self.skipped += 1
        if not self.margin.add(margin):
            self.skipped += 1

    def drift(self) -> float:
        return drift_score(
            self.reference,
            {"entropy": self.entropy, "margin": self.margin},
        )

    def fingerprint(self, meta: Optional[dict] = None) -> dict:
        return fingerprint(
            {"entropy": self.entropy, "margin": self.margin}, meta=meta
        )

    def stats(self) -> dict:
        """One flat host-side view (serve_bench / engine.quality_row)."""
        return {
            "entropy_mean": self.entropy.mean(),
            "margin_mean": self.margin.mean(),
            "tokens_observed": self.entropy.total,
            "no_signal_observations": self.skipped,
            "drift": self.drift(),
        }


def quality_row(monitor: QualityMonitor, iteration: int,
                lambdas: Optional[dict] = None) -> dict:
    """One ``{"record": "quality"}`` JSONL row — the serving twin of
    the trainer's introspection records. λ keys reuse the
    ``lambda_l<k>`` / ``lambda_l<k>_t<j>`` schema (obs/introspect.py)
    so tools/lambda_report.py --serving renders fleet rows beside
    training ones, and tools/metrics_report.py summarizes/gates the
    drift column."""
    row = {"record": "quality", "iter": int(iteration)}
    for k, v in monitor.stats().items():
        row[k] = round(v, 6) if isinstance(v, float) else v
    for k, v in (lambdas or {}).items():
        row[k] = round(float(v), 6)
    return row


# import-friendly alias: serving/engine.py has a ``quality_row`` METHOD
# on the engine, so it imports the free function under this name
build_quality_row = quality_row
