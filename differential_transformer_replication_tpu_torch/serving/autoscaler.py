"""Autonomous fleet control plane: SLO-driven autoscaling + canaried
rollout with auto-rollback, over the port's fleet and router.

The port's twin of the repo's ``tools/autoscaler.py`` (which steers a
fleet of the JAX package's server), as serving/fleet.py is the twin of
``tools/fleet.py``: the same ``Signals``, ``SignalExtractor``,
``Autoscaler`` state machine, ``replay``, ``FleetActuator``,
``window_stats``, ``judge_canary``, ``CanaryController`` and ``main``
flags, with the same decision, reason and event strings, metric
families and record rows, steering serving/fleet.py replicas of the
port's server behind serving/router.py. It closes the loop over the
router's ``/fleet/metrics`` aggregation, SLO burn math (obs/slo.py),
the fleet's drain-aware restart machinery, and perf gating:

- **autoscaling** — poll the fleet exposition each tick, compute the
  WINDOWED burn rate of the TTFT/ITL objectives (deltas between
  polls, same math as obs/slo.py's ``slo_burn_rate_window``) plus a
  utilization score (queue depth per slot, slot occupancy, KV-page
  and host-tier pressure). Sustained burn > ``scale_up_burn`` or
  utilization above ``util_high`` scales up; sustained calm scales
  down by DRAINING the least-loaded replica (zero-loss, via
  serving/fleet.py's drain path, live-migrating its decodes first).
  Hysteresis (``*_sustain`` consecutive ticks), per-direction
  cooldowns, and min/max bounds make a noisy or oscillating signal
  (the ``scale_flap`` fault point, fired in :meth:`Autoscaler.tick`)
  unable to flap the fleet.
- **canaried rollout** — relaunch ONE replica on a new
  checkpoint/config (``Fleet.relaunch_replica``), split a configured
  traffic fraction to it (``Router.set_canary``), judge the window
  with the same burn math slo_report uses and the same regression
  slack perf_gate uses (``gate_key`` on windowed p95 TTFT, canary vs
  control), then promote or roll back to the exact previous argv/env
  — unattended. When the fleet runs ``--quality-telemetry`` the judge
  gains a MODEL-QUALITY axis (obs/quality.py): a canary whose
  ``serving_quality_drift`` exceeds ``canary_max_drift`` or whose
  constraint validity falls ``canary_max_validity_delta`` below
  control rolls back even when every latency gate passes.

Every decision is a typed, reasoned JSONL event (obs/events.py) and a
registry metric (``autoscaler_*``). Decisions are BIT-REPRODUCIBLE:
``tick()`` records the extracted signals per tick (``--record``), and
``--replay`` feeds them back through the same pure ``decide()`` state
machine with the recorded clock — byte-identical decisions, no fleet
required; a record of either package replays through the other. The
poller tolerates router restarts and probe blackholes (a failed poll is
a "hold" tick, not a crash), and stale replica bodies
(``fleet_scrape_age_seconds`` beyond ``stale_after_s``) are treated as
missing, not as healthy-at-their-last-scrape.

CLI::

    # fleet + router + autoscaler in one process tree (replicas on
    # cuda unless the args after -- say --device cpu):
    python -m differential_transformer_replication_tpu_torch.serving.autoscaler \
        --replicas 1 --max-replicas 2 --router-port 8000 \
        --record scaler.jsonl -- --device cpu
    # offline: re-derive every decision from a recorded signal trace:
    python -m differential_transformer_replication_tpu_torch.serving.autoscaler \
        --replay scaler.jsonl

No torch or numpy import — the control plane must stay alive when the
runtime it steers is the thing misbehaving. The two judges it borrows,
perf_gate's :func:`gate_key` and slo_report's :func:`check`, are copies
of the repo's ``tools/perf_gate.py`` and ``tools/slo_report.py``
functions, so this module imports nothing from ``tools/``.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import signal as _signal
import sys
import threading
import time
import urllib.request
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from differential_transformer_replication_tpu_torch.config import (
    AutoscalerConfig,
)
from differential_transformer_replication_tpu_torch.obs.events import (
    open_event_log,
)
from differential_transformer_replication_tpu_torch.obs.registry import (
    parse_exposition,
)
from differential_transformer_replication_tpu_torch.obs.slo import (
    burn_rate,
    good_count_under,
    histogram_from_samples,
)
from differential_transformer_replication_tpu_torch.utils import faults


# -- the judges: copies of tools/perf_gate.py and tools/slo_report.py ----
# perf_gate's baseline math and per-key gate (MAD_SIGMA through lookup,
# then gate_key) and slo_report's burn-gate check, verbatim, so the
# canary judge rules exactly as the tools do without importing tools/.


# MAD -> sigma for normally distributed noise; the standard consistency
# constant, spelled out so the gate formula is reproducible by hand.
MAD_SIGMA = 1.4826

# Direction inference tokenizes the key path on ./_ so "tokens_per_sec"
# (higher-better) never trips on the "s"/"ms" latency hints.
_LOWER_BETTER_TOKENS = frozenset((
    "ms", "s", "itl", "ttft", "latency", "busy", "time", "seconds",
    "stall", "blocked", "wait",
))


def median(xs: List[float]) -> float:
    ys = sorted(xs)
    n = len(ys)
    mid = n // 2
    return ys[mid] if n % 2 else (ys[mid - 1] + ys[mid]) / 2.0


def mad(xs: List[float], center: Optional[float] = None) -> float:
    """Median absolute deviation — the robust noise scale (one outlier
    round cannot widen the gate the way a stddev would)."""
    if center is None:
        center = median(xs)
    return median([abs(x - center) for x in xs])


def baseline_stats(history: List[float]) -> Tuple[float, float]:
    """(median, mad) of a trailing window — THE baseline math, the one
    perf_gate and bench_trend share, so the canary judge rules on a
    trajectory as they do."""
    m = median(history)
    return m, mad(history, m)


def parse_key_spec(spec: str) -> Tuple[str, str, str]:
    """``"itl_ms.p95:lower"`` -> (path, direction, display name)."""
    if ":" in spec:
        path, direction = spec.rsplit(":", 1)
        if direction not in ("higher", "lower"):
            raise ValueError(
                f"key direction must be 'higher' or 'lower', got "
                f"{direction!r} in {spec!r}"
            )
    else:
        path = spec
        tokens = re.split(r"[._]", path.lower())
        direction = (
            "lower"
            if any(t in _LOWER_BETTER_TOKENS for t in tokens)
            else "higher"
        )
    return path, direction, spec


def lookup(doc: dict, path: str):
    """Dotted-path descent; None when any hop is absent or non-numeric."""
    cur = doc
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    if isinstance(cur, bool) or not isinstance(cur, (int, float)):
        return None
    return float(cur)


def gate_key(samples: List[dict], spec: str, window: int,
             max_regress: float, mad_factor: float,
             min_history: int) -> dict:
    """Judge one key over the trajectory; the per-key summary entry."""
    path, direction, name = parse_key_spec(spec)
    series = [
        (i, v) for i, v in
        ((i, lookup(d, path)) for i, d in enumerate(samples))
        if v is not None
    ]
    out: dict = {"key": name, "path": path, "direction": direction,
                 "n": len(series)}
    if len(series) < min_history:
        out["status"] = "insufficient_history"
        out["min_history"] = min_history
        return out
    values = [v for _, v in series]
    newest = values[-1]
    history = values[:-1][-window:]
    if not history:
        # --min-history 1 with a single sample: nothing to compare
        # against is insufficient history, not a crash
        out["status"] = "insufficient_history"
        out["min_history"] = max(min_history, 2)
        return out
    base, noise = baseline_stats(history)
    slack = max(max_regress * abs(base), mad_factor * MAD_SIGMA * noise)
    delta = (newest - base) if direction == "higher" else (base - newest)
    regressed = delta < -slack
    out.update({
        "status": "regressed" if regressed else "ok",
        "newest": newest,
        "baseline_median": round(base, 6),
        "baseline_mad": round(noise, 6),
        "allowed_slack": round(slack, 6),
        "delta_vs_baseline": round(newest - base, 6),
        "window_n": len(history),
    })
    return out


def check(objectives: dict, args) -> list:
    """Gate violations; empty = inside every error budget."""
    bad = []
    stale = objectives.get("stale_replicas")
    if stale:
        bad.append(
            "stale replica metrics (scrape age > "
            f"{getattr(args, 'max_scrape_age', 0.0)}s): "
            + ", ".join(stale)
        )
    for name, o in objectives.items():
        if not isinstance(o, dict) or "burn_rate" not in o:
            continue
        burn = o["burn_rate"]
        if burn is None:
            if args.require_traffic:
                bad.append(f"objective {name}: no observations")
            continue
        if burn > args.max_burn:
            bad.append(
                f"objective {name}: burn rate {round(burn, 3)} > "
                f"{args.max_burn} (error ratio "
                f"{round(o['error_ratio'], 5)} vs target {o['target']})"
            )
    # quality drift gate (--max-drift; getattr because the autoscaler's
    # _GateArgs shim predates the flag and sets only max_burn)
    max_drift = getattr(args, "max_drift", None)
    quality = objectives.get("quality")
    if max_drift and isinstance(quality, dict):
        d = quality.get("drift_max")
        if d is not None and not math.isnan(d) and d > max_drift:
            bad.append(
                f"quality drift {round(d, 4)} > {max_drift} (PSI vs "
                "reference fingerprint; see obs/quality.py)"
            )
    return bad


# -- signal extraction ---------------------------------------------------


@dataclass
class Signals:
    """One tick's control inputs, extracted from a fleet exposition.
    Everything ``decide()`` consumes lives here (and only here), so a
    recorded row replays to an identical decision."""

    ok: bool                          # the poll itself succeeded
    burn: Optional[float] = None      # worst windowed TTFT/ITL burn
    util: float = 0.0                 # max utilization score, 0..1
    queue_depth: float = 0.0          # fleet-wide waiting requests
    replicas_up: int = 0              # fleet_replica_up == 1 count
    stale_replicas: int = 0           # bodies older than stale_after_s

    def to_row(self) -> dict:
        return {
            "ok": self.ok, "burn": self.burn, "util": self.util,
            "queue_depth": self.queue_depth,
            "replicas_up": self.replicas_up,
            "stale_replicas": self.stale_replicas,
        }

    @classmethod
    def from_row(cls, row: dict) -> "Signals":
        return cls(
            ok=bool(row.get("ok", False)),
            burn=row.get("burn"),
            util=float(row.get("util", 0.0)),
            queue_depth=float(row.get("queue_depth", 0.0)),
            replicas_up=int(row.get("replicas_up", 0)),
            stale_replicas=int(row.get("stale_replicas", 0)),
        )


# per-replica gauges folded into the utilization score; each maps to a
# 0..1 pressure number in _replica_utils
_UTIL_GAUGES = (
    "serving_queue_depth", "serving_slots", "serving_slot_occupancy",
    "serving_kv_utilization", "serving_kv_pages_total",
    "serving_kv_pages_free", "serving_host_tier_budget_bytes",
    "serving_host_tier_bytes",
)


def _replica_utils(m: Dict[str, float]) -> List[float]:
    """One replica's pressure scores (each 0..1) from its gauges."""
    utils: List[float] = []
    slots = m.get("serving_slots", 0.0)
    if slots > 0:
        utils.append(
            min(1.0, m.get("serving_slot_occupancy", 0.0) / slots)
        )
        # queue pressure saturates once a full slot-pool's worth waits
        utils.append(
            min(1.0, m.get("serving_queue_depth", 0.0) / slots)
        )
    if "serving_kv_utilization" in m:
        utils.append(min(1.0, m["serving_kv_utilization"]))
    pages = m.get("serving_kv_pages_total", 0.0)
    if pages > 0:
        utils.append(min(1.0, max(
            0.0, 1.0 - m.get("serving_kv_pages_free", 0.0) / pages
        )))
    budget = m.get("serving_host_tier_budget_bytes", 0.0)
    if budget > 0:
        utils.append(min(
            1.0, m.get("serving_host_tier_bytes", 0.0) / budget
        ))
    return utils


class SignalExtractor:
    """Turns successive ``/fleet/metrics`` bodies into :class:`Signals`.

    Stateful only for the WINDOWED burn (previous good/count per
    objective — the same delta the SLOMonitor's
    ``slo_burn_rate_window`` gauge takes); everything else is read
    fresh per poll. Stale replicas (scrape age beyond
    ``stale_after_s``) are dropped from the utilization/up counts —
    the router already drops their bodies from the histogram
    aggregate past its own ``metrics_max_age_s`` bound."""

    def __init__(self, cfg: AutoscalerConfig):
        self.cfg = cfg
        self._prev: Dict[str, Tuple[float, float]] = {}

    def extract(self, text: str) -> Signals:
        _, samples = parse_exposition(text)
        burns: List[float] = []
        for name, hist, threshold in (
            ("ttft", "serving_ttft_seconds", self.cfg.ttft_threshold_s),
            ("itl", "serving_itl_seconds", self.cfg.itl_threshold_s),
        ):
            bounds, cumulative, count = histogram_from_samples(
                samples, hist
            )
            good = good_count_under(bounds, cumulative, threshold)
            p_good, p_count = self._prev.get(name, (0.0, 0.0))
            # a shrinking fleet (replica removed from the aggregate)
            # makes the cumulative counts step backwards: reset the
            # window rather than reporting negative traffic
            d_count = count - p_count
            d_good = good - p_good
            self._prev[name] = (good, count)
            if d_count > 0 and d_good >= 0:
                err = max(0.0, (d_count - d_good) / d_count)
                b = burn_rate(err, self.cfg.slo_target)
                if b is not None:
                    burns.append(b)
        per: Dict[str, Dict[str, float]] = {}
        ages: Dict[str, float] = {}
        up = 0
        for n, labels, v in samples:
            rep = labels.get("replica")
            if n == "fleet_scrape_age_seconds" and rep:
                ages[rep] = v
            elif n == "fleet_replica_up" and v >= 1:
                up += 1
            elif n in _UTIL_GAUGES and rep:
                per.setdefault(rep, {})[n] = v
        stale = {
            rep for rep, age in ages.items()
            if self.cfg.stale_after_s > 0 and age > self.cfg.stale_after_s
        }
        utils: List[float] = []
        queue = 0.0
        for rep, m in per.items():
            if rep in stale:
                continue  # missing, not healthy-at-its-last-scrape
            utils.extend(_replica_utils(m))
            queue += max(0.0, m.get("serving_queue_depth", 0.0))
        return Signals(
            ok=True,
            burn=max(burns) if burns else None,
            util=max(utils) if utils else 0.0,
            queue_depth=queue,
            replicas_up=up,
            stale_replicas=len(stale),
        )


# -- the decision state machine ------------------------------------------


@dataclass
class Decision:
    """One tick's ruling; ``target`` is the replica count AFTER it."""

    tick: int
    action: str                # "up" | "down" | "hold"
    reason: str
    target: int
    burn: Optional[float]
    util: float

    def to_row(self) -> dict:
        return {
            "tick": self.tick, "action": self.action,
            "reason": self.reason, "target": self.target,
            "burn": self.burn, "util": self.util,
        }


class Autoscaler:
    """Hysteresis/cooldown scaling state machine + its control loop.

    ``decide(signals, now)`` is PURE given the instance state (no
    clock reads, no I/O, no randomness), which is what makes recorded
    traces replay bit-identically. ``tick()`` wraps it with the
    impure parts: polling, fault injection, events, metrics,
    recording, and actuation."""

    def __init__(self, cfg: AutoscalerConfig,
                 poll: Optional[Callable[[], str]] = None,
                 actuator=None,
                 registry=None,
                 events=None,
                 now_fn: Callable[[], float] = time.monotonic,
                 record_path: Optional[str] = None,
                 initial_replicas: Optional[int] = None):
        self.cfg = cfg
        self.poll = poll
        self.actuator = actuator
        self.events = events if events is not None else open_event_log(
            None, process="autoscaler"
        )
        self._now = now_fn
        self._record_path = record_path
        self._record_fh = None
        self.extractor = SignalExtractor(cfg)
        self.current = (
            initial_replicas if initial_replicas is not None
            else (actuator.replicas() if actuator is not None
                  else cfg.min_replicas)
        )
        self._tick = 0
        self._consec_high = 0
        self._consec_low = 0
        self._last_action_t: Optional[float] = None
        self._last_action: str = ""
        self._poll_failures = 0
        self._target_gauge = None
        if registry is not None:
            self._target_gauge = registry.gauge(
                "autoscaler_replicas_target",
                "Replica count the autoscaler is steering toward.",
            )
            self._burn_gauge = registry.gauge(
                "autoscaler_burn_observed",
                "Windowed SLO burn the last decision keyed on.",
            )
            self._util_gauge = registry.gauge(
                "autoscaler_util_observed",
                "Utilization score the last decision keyed on.",
            )
            self._decision_counter = registry.counter(
                "autoscaler_decisions_total",
                "Scaling decisions by action.",
                labelnames=("action",),
            )
            self._target_gauge.set(self.current)

    # -- the pure ruling ----------------------------------------------

    def decide(self, sig: Signals, now: float) -> Decision:
        tick = self._tick
        self._tick += 1
        cfg = self.cfg
        if not sig.ok:
            # a blackholed/restarting router is a HOLD, not a crash —
            # and not evidence in either direction, so the hysteresis
            # streaks freeze instead of resetting
            self._poll_failures += 1
            return Decision(
                tick, "hold",
                f"poll failed ({self._poll_failures} consecutive); "
                "holding at last-known state",
                self.current, None, 0.0,
            )
        self._poll_failures = 0
        burn, util = sig.burn, sig.util
        high = (burn is not None and burn > cfg.scale_up_burn) \
            or util > cfg.util_high
        low = (burn is None or burn < cfg.scale_down_burn) \
            and util < cfg.util_low
        self._consec_high = self._consec_high + 1 if high else 0
        self._consec_low = self._consec_low + 1 if low else 0
        since = (
            None if self._last_action_t is None
            else now - self._last_action_t
        )

        def _fmt(v):
            return "none" if v is None else f"{v:.3f}"

        basis = (f"burn={_fmt(burn)} util={util:.3f} "
                 f"queue={sig.queue_depth:.0f} "
                 f"stale={sig.stale_replicas}")
        action, reason = "hold", f"steady ({basis})"
        if high and self._consec_high >= cfg.scale_up_sustain:
            if self.current >= cfg.max_replicas:
                reason = f"pressure sustained but at max_replicas " \
                         f"({cfg.max_replicas}); {basis}"
            elif since is not None and since < cfg.cooldown_up_s:
                reason = (f"pressure sustained but in cooldown "
                          f"({since:.1f}s < {cfg.cooldown_up_s}s "
                          f"since {self._last_action}); {basis}")
            else:
                action = "up"
                reason = (f"{self._consec_high} consecutive ticks over "
                          f"burn>{cfg.scale_up_burn} or "
                          f"util>{cfg.util_high}; {basis}")
        elif low and self._consec_low >= cfg.scale_down_sustain:
            if self.current <= cfg.min_replicas:
                reason = f"calm sustained but at min_replicas " \
                         f"({cfg.min_replicas}); {basis}"
            elif since is not None and since < cfg.cooldown_down_s:
                reason = (f"calm sustained but in cooldown "
                          f"({since:.1f}s < {cfg.cooldown_down_s}s "
                          f"since {self._last_action}); {basis}")
            else:
                action = "down"
                reason = (f"{self._consec_low} consecutive ticks under "
                          f"burn<{cfg.scale_down_burn} and "
                          f"util<{cfg.util_low}; {basis}")
        if action != "hold":
            self.current += 1 if action == "up" else -1
            self._consec_high = 0
            self._consec_low = 0
            self._last_action_t = now
            self._last_action = f"scale_{action}"
        return Decision(tick, action, reason, self.current, burn, util)

    # -- the impure loop ----------------------------------------------

    def _record(self, now: float, sig: Signals,
                decision: Decision) -> None:
        if self._record_path is None:
            return
        if self._record_fh is None:
            self._record_fh = open(self._record_path, "a",
                                   encoding="utf-8")
        self._record_fh.write(json.dumps({
            "tick": decision.tick, "now": now,
            "signals": sig.to_row(), "decision": decision.to_row(),
        }) + "\n")
        self._record_fh.flush()

    def tick(self) -> Decision:
        now = self._now()
        poll_error = None
        if self.poll is None:
            sig = Signals(ok=False)
            poll_error = "no poll source configured"
        else:
            try:
                sig = self.extractor.extract(self.poll())
            except Exception as e:  # router restart / blackhole / 5xx
                sig = Signals(ok=False)
                poll_error = repr(e)
        # scale_flap@A-B: an oscillating capacity signal INJECTED at
        # the signal layer (tick parity flips saturated<->idle), so the
        # recorded trace carries the flap and hysteresis must absorb
        # it; decide() itself stays fault-free and pure
        if sig.ok and faults.scale_flap_at(self._tick):
            if self._tick % 2 == 0:
                sig.burn, sig.util = 99.0, 1.0
            else:
                sig.burn, sig.util = 0.0, 0.0
        decision = self.decide(sig, now)
        self.events.emit(
            "autoscaler_decision", tick=decision.tick,
            action=decision.action, reason=decision.reason,
            target=decision.target, burn=decision.burn,
            util=decision.util, queue_depth=sig.queue_depth,
            stale_replicas=sig.stale_replicas,
            replicas_up=sig.replicas_up,
            **({"poll_error": poll_error} if poll_error else {}),
        )
        if self._target_gauge is not None:
            self._target_gauge.set(decision.target)
            if decision.burn is not None:
                self._burn_gauge.set(decision.burn)
            self._util_gauge.set(decision.util)
            self._decision_counter.inc(action=decision.action)
        self._record(now, sig, decision)
        if decision.action != "hold" and self.actuator is not None:
            try:
                if decision.action == "up":
                    self.actuator.scale_up()
                else:
                    self.actuator.scale_down()
                self.events.emit(
                    "autoscaler_scaled", action=decision.action,
                    replicas=decision.target,
                )
            except Exception as e:
                # actuation failed (mid-scale SIGKILL, drain refusal):
                # put the target back so the state machine re-earns the
                # decision instead of believing a scale that never took
                self.current = (
                    self.current - 1 if decision.action == "up"
                    else self.current + 1
                )
                self.events.emit(
                    "autoscaler_scale_failed", action=decision.action,
                    error=repr(e), replicas=self.current,
                )
        return decision

    def run(self, stop: threading.Event) -> None:
        while not stop.is_set():
            self.tick()
            stop.wait(self.cfg.poll_interval_s)

    def close(self) -> None:
        if self._record_fh is not None:
            self._record_fh.close()
            self._record_fh = None


def replay(rows: Sequence[dict], cfg: AutoscalerConfig,
           initial_replicas: Optional[int] = None) -> List[Decision]:
    """Re-derive every decision from a recorded signal trace — same
    state machine, recorded clock, no fleet. Byte-identical output is
    the reproducibility contract tests/test_torch_autoscaler.py pins
    (against the JAX package's tool as well)."""
    scaler = Autoscaler(cfg, initial_replicas=initial_replicas)
    return [
        scaler.decide(Signals.from_row(row.get("signals", {})),
                      float(row.get("now", 0.0)))
        for row in rows
    ]


# -- actuation over a live fleet + in-process router ---------------------


class FleetActuator:
    """Applies scale decisions to a serving/fleet.py ``Fleet`` fronted by
    an in-process ``Router`` (the integrated-CLI topology)."""

    def __init__(self, fleet, router):
        self.fleet = fleet
        self.router = router

    def replicas(self) -> int:
        return len(self.fleet.replicas)

    def scale_up(self, n: int = 1) -> List[str]:
        urls = self.fleet.scale_up(n)
        for u in urls:
            self.router.add_replica(u)
        return urls

    def scale_down(self) -> str:
        # least-loaded victim by the ROUTER's load score (never the
        # canary mid-judgment): live-migrate its ACTIVE decodes to the
        # surviving peers (router.migrate_out — drain time is page
        # transfer, not max_new_tokens), then drain it out through the
        # fleet's zero-loss path and drop it from rotation + admission
        canary_url, _ = self.router.canary()
        scores = {r.url: r.score() for r in self.router.replicas}
        kwargs = {
            "score_of": lambda u: None if u == canary_url
            else scores.get(u),
        }
        pre_drain = getattr(self.router, "migrate_out", None)
        if pre_drain is not None:
            kwargs["pre_drain"] = pre_drain
        url = self.fleet.scale_down(**kwargs)
        self.router.remove_replica(url)
        return url


# -- canaried rollout ----------------------------------------------------


def histogram_quantile(bounds: Sequence[float],
                       cumulative: Sequence[float], count: float,
                       q: float) -> Optional[float]:
    """Smallest bucket bound covering quantile ``q`` of a (windowed)
    histogram; ``inf`` when it falls in the overflow bucket, None when
    the histogram is empty. Upper-bound honest: the true quantile is
    <= the returned edge."""
    if count <= 0:
        return None
    target = q * count
    for b, c in zip(bounds, cumulative):
        if c >= target:
            return b
    return math.inf


def _sum_samples(samples, name: str) -> Optional[float]:
    """Sum of all samples with this exact name (label children and
    per-replica gauged samples collapse); None when absent."""
    vals = [v for n, _, v in samples if n == name]
    return sum(vals) if vals else None


def _gauge_values(samples, name: str) -> List[float]:
    return [v for n, _, v in samples if n == name]


def window_stats(pairs: Sequence[Tuple[str, str]],
                 ttft_threshold_s: float, slo_target: float) -> dict:
    """TTFT + quality stats over a canary window from (before, after)
    exposition snapshots of one or more replicas: delta the cumulative
    buckets per bound (restart-safe: a counter that stepped backwards
    clamps to zero), sum across replicas, then judge the window alone.

    Quality keys (obs/quality.py; all None when the replicas do not
    run ``--quality-telemetry``): ``entropy_mean`` / ``margin_mean``
    are windowed means from the serving_token_entropy /
    serving_logit_margin histograms' ``_sum``/``_count`` deltas;
    ``drift`` is the WORST (max) finite ``serving_quality_drift``
    gauge in the after bodies (gauges are levels, not counters — the
    after snapshot IS the window's verdict); ``validity`` is the
    worst (min) ``serving_constraint_validity_rate``."""
    by_bound: Dict[float, float] = {}
    total = 0.0
    q_sums = {"entropy": [0.0, 0.0], "margin": [0.0, 0.0]}
    drift: Optional[float] = None
    validity: Optional[float] = None
    for before, after in pairs:
        _, s0 = parse_exposition(before or "")
        _, s1 = parse_exposition(after or "")
        b0, c0, n0 = histogram_from_samples(s0, "serving_ttft_seconds")
        b1, c1, n1 = histogram_from_samples(s1, "serving_ttft_seconds")
        prev = dict(zip(b0, c0))
        for b, c in zip(b1, c1):
            by_bound[b] = by_bound.get(b, 0.0) \
                + max(0.0, c - prev.get(b, 0.0))
        total += max(0.0, n1 - n0)
        for key, hist in (("entropy", "serving_token_entropy"),
                          ("margin", "serving_logit_margin")):
            sum1 = _sum_samples(s1, f"{hist}_sum")
            cnt1 = _sum_samples(s1, f"{hist}_count")
            if sum1 is None or cnt1 is None:
                continue
            sum0 = _sum_samples(s0, f"{hist}_sum") or 0.0
            cnt0 = _sum_samples(s0, f"{hist}_count") or 0.0
            q_sums[key][0] += max(0.0, sum1 - sum0)
            q_sums[key][1] += max(0.0, cnt1 - cnt0)
        for v in _gauge_values(s1, "serving_quality_drift"):
            if math.isfinite(v):
                drift = v if drift is None else max(drift, v)
            elif not math.isnan(v):  # inf = incompatible fingerprint
                drift = v
        for v in _gauge_values(s1, "serving_constraint_validity_rate"):
            if math.isfinite(v):
                validity = v if validity is None else min(validity, v)
    bounds = sorted(by_bound)
    cumulative = [by_bound[b] for b in bounds]
    good = good_count_under(bounds, cumulative, ttft_threshold_s)
    err = None if total <= 0 else max(0.0, (total - good) / total)
    return {
        "count": total,
        "error_ratio": err,
        "burn_rate": burn_rate(err, slo_target),
        "target": slo_target,
        "p95_ttft_s": histogram_quantile(bounds, cumulative, total,
                                         0.95),
        "entropy_mean": (q_sums["entropy"][0] / q_sums["entropy"][1]
                         if q_sums["entropy"][1] else None),
        "margin_mean": (q_sums["margin"][0] / q_sums["margin"][1]
                        if q_sums["margin"][1] else None),
        "drift": drift,
        "validity": validity,
    }


class _GateArgs:
    """The two attributes :func:`check` reads."""

    def __init__(self, max_burn: float):
        self.max_burn = max_burn
        self.require_traffic = False


def judge_canary(canary: dict, control: dict,
                 cfg: AutoscalerConfig) -> Tuple[str, str]:
    """Promote-or-rollback ruling from two :func:`window_stats` dicts.
    Reuses the fleet's existing judges: slo_report's burn-gate
    :func:`check` for the canary's own SLO burn, and perf_gate's
    regression slack
    (``gate_key``, control as baseline) for p95 TTFT. Thin evidence
    (< ``canary_min_requests`` in the window) is a ROLLBACK — an
    unjudgeable canary must not be promoted by default."""
    if canary["count"] < cfg.canary_min_requests:
        return "rollback", (
            f"inconclusive: {canary['count']:.0f} canary requests in "
            f"window (need {cfg.canary_min_requests}); refusing to "
            "promote on thin evidence"
        )
    violations = check(
        {"canary_ttft": canary}, _GateArgs(cfg.canary_max_burn)
    )
    if violations:
        return "rollback", violations[0]
    c_p95 = canary.get("p95_ttft_s")
    ctl_p95 = control.get("p95_ttft_s")
    if ctl_p95 is not None and math.isfinite(ctl_p95):
        if c_p95 is None or not math.isfinite(c_p95):
            return "rollback", (
                "canary window p95 TTFT beyond the histogram range "
                f"while control served {ctl_p95:.3f}s"
            )
        verdict = gate_key(
            [{"p95_ttft_s": ctl_p95}, {"p95_ttft_s": c_p95}],
            "p95_ttft_s:lower", window=1,
            max_regress=cfg.canary_max_regress, mad_factor=0.0,
            min_history=2,
        )
        if verdict["status"] == "regressed":
            return "rollback", (
                f"canary p95 TTFT {c_p95:.3f}s regressed past control "
                f"{ctl_p95:.3f}s + {cfg.canary_max_regress:.0%} slack"
            )
    # -- quality axis (obs/quality.py) -----------------------------------
    # A canary can be latency-flat and still WRONG: a perturbed λ or a
    # bad int8 scale moves the token-quality distributions, not p95.
    # None = the fleet does not run quality telemetry (gates pass, not
    # fail-closed: quality is opt-in); NaN never reaches here (the
    # drift gauge's "no signal" degradation is 0.0).
    drift = canary.get("drift")
    if (cfg.canary_max_drift > 0 and drift is not None
            and not math.isnan(drift) and drift > cfg.canary_max_drift):
        return "rollback", (
            f"canary quality drift {drift:.3f} past budget "
            f"{cfg.canary_max_drift:.3f} (PSI vs reference "
            "fingerprint) — latency alone would have promoted"
        )
    c_validity = canary.get("validity")
    if cfg.canary_max_validity_delta > 0 and c_validity is not None:
        ctl_validity = control.get("validity")
        base = (ctl_validity
                if ctl_validity is not None
                and math.isfinite(ctl_validity) else 1.0)
        if base - c_validity > cfg.canary_max_validity_delta:
            return "rollback", (
                f"canary constraint validity {c_validity:.3f} fell "
                f"more than {cfg.canary_max_validity_delta:.3f} below "
                f"control {base:.3f} — latency alone would have "
                "promoted"
            )
    return "promote", (
        "canary inside burn, latency, and quality budgets over "
        f"{canary['count']:.0f}-request window"
    )


class CanaryController:
    """One canaried rollout: relaunch a replica on new args, split
    traffic, judge the window, promote or roll back. Unattended — a
    regressed canary (e.g. the ``canary_regress`` fault) comes back
    on its ORIGINAL argv/env with zero operator input."""

    def __init__(self, fleet, router, cfg: AutoscalerConfig,
                 events=None,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 fetch: Optional[Callable[[str], str]] = None):
        self.fleet = fleet
        self.router = router
        self.cfg = cfg
        self.events = events if events is not None else open_event_log(
            None, process="canary"
        )
        self._sleep = sleep_fn
        self._fetch = fetch if fetch is not None else self._http_fetch

    @staticmethod
    def _http_fetch(url: str) -> str:
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            return r.read().decode("utf-8", "replace")

    def _ready_check(self):
        router = self.router

        def ok(r) -> bool:
            rep = next(
                (x for x in router.replicas if x.url == r.url), None
            )
            return rep is None or rep.eligible()

        return ok

    def _snapshot(self, urls: Sequence[str]) -> Dict[str, str]:
        out = {}
        for u in urls:
            try:
                out[u] = self._fetch(u)
            except OSError:
                out[u] = ""  # a dead control replica judges as empty
        return out

    def run(self, server_args: Optional[Sequence[str]] = None,
            extra_env: Optional[dict] = None,
            index: Optional[int] = None) -> dict:
        """Execute one rollout; returns the judgment record (also
        emitted as events). Zero-failed-requests is the router's job:
        the canary drains in/out through the same SIGTERM path a
        rolling restart uses, and its traffic share comes back to the
        control pool the moment ``set_canary(None)`` lands."""
        if index is None:
            index = max(r.index for r in self.fleet.replicas)
        replica = next(
            r for r in self.fleet.replicas if r.index == index
        )
        url = replica.url
        self.events.emit("canary_started", replica=index, url=url,
                         fraction=self.cfg.canary_fraction)
        old_argv, old_env = self.fleet.relaunch_replica(
            index, server_args=server_args, extra_env=extra_env,
            ready_check=self._ready_check(),
        )
        self.router.set_canary(url, self.cfg.canary_fraction)
        control_urls = [
            r.url for r in self.fleet.replicas if r.url != url
        ]
        try:
            before = self._snapshot([url] + control_urls)
            self._sleep(self.cfg.canary_window_s)
            after = self._snapshot([url] + control_urls)
        finally:
            # judgment happens OFF the split: the canary keeps serving
            # only if promoted, and a judge crash must not leave a
            # fraction of traffic pinned to an unjudged replica
            self.router.set_canary(None)
        canary_stats = window_stats(
            [(before.get(url, ""), after.get(url, ""))],
            self.cfg.ttft_threshold_s, self.cfg.slo_target,
        )
        control_stats = window_stats(
            [(before.get(u, ""), after.get(u, "")) for u in control_urls],
            self.cfg.ttft_threshold_s, self.cfg.slo_target,
        )
        verdict, reason = judge_canary(canary_stats, control_stats,
                                       self.cfg)
        self.events.emit(
            "canary_judged", replica=index, verdict=verdict,
            reason=reason, canary=canary_stats, control=control_stats,
        )
        if verdict == "promote":
            self.events.emit("canary_promoted", replica=index)
        else:
            self.fleet.relaunch_replica(
                index, argv=old_argv, env=old_env,
                ready_check=self._ready_check(),
            )
            self.events.emit("canary_rolled_back", replica=index)
        record = {
            "verdict": verdict, "reason": reason, "replica": index,
            "canary": canary_stats, "control": control_stats,
        }
        self.events.flush()
        return record


# -- CLI -----------------------------------------------------------------


def _http_poll(url: str, timeout: float = 5.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode("utf-8", "replace")


def main() -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--replay", default=None,
                   help="re-derive decisions from a --record JSONL "
                        "trace and print them (no fleet, no clock)")
    p.add_argument("--replicas", type=int, default=1,
                   help="initial fleet size (live mode)")
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--max-replicas", type=int, default=4)
    p.add_argument("--poll-interval", type=float, default=1.0)
    p.add_argument("--scale-up-burn", type=float, default=1.0)
    p.add_argument("--scale-down-burn", type=float, default=0.5)
    p.add_argument("--up-sustain", type=int, default=3)
    p.add_argument("--down-sustain", type=int, default=6)
    p.add_argument("--cooldown-up", type=float, default=5.0)
    p.add_argument("--cooldown-down", type=float, default=15.0)
    p.add_argument("--ttft", type=float, default=1.0)
    p.add_argument("--itl", type=float, default=0.25)
    p.add_argument("--target", type=float, default=0.99)
    p.add_argument("--stale-after", type=float, default=5.0)
    p.add_argument("--canary-max-drift", type=float, default=0.25,
                   help="canary judge rolls back when the canary's "
                        "serving_quality_drift (PSI vs reference "
                        "fingerprint) exceeds this; 0 = quality drift "
                        "gate off")
    p.add_argument("--canary-max-validity-delta", type=float,
                   default=0.05,
                   help="canary judge rolls back when the canary's "
                        "constraint validity rate falls this far "
                        "below control's; 0 = gate off")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--router-port", type=int, default=8000)
    p.add_argument("--record", default=None,
                   help="append per-tick signal+decision JSONL rows "
                        "(the --replay input)")
    p.add_argument("--event-log", default=None)
    p.add_argument("--fleet-log", default=None)
    p.add_argument("server_args", nargs=argparse.REMAINDER,
                   help="-- then serving.server CLI args per replica")
    args = p.parse_args()

    cfg = AutoscalerConfig(
        poll_interval_s=args.poll_interval,
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        scale_up_burn=args.scale_up_burn,
        scale_down_burn=args.scale_down_burn,
        scale_up_sustain=args.up_sustain,
        scale_down_sustain=args.down_sustain,
        cooldown_up_s=args.cooldown_up,
        cooldown_down_s=args.cooldown_down,
        ttft_threshold_s=args.ttft,
        itl_threshold_s=args.itl,
        slo_target=args.target,
        stale_after_s=args.stale_after,
        canary_max_drift=args.canary_max_drift,
        canary_max_validity_delta=args.canary_max_validity_delta,
    )

    if args.replay:
        rows = []
        with open(args.replay, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        for d in replay(rows, cfg, initial_replicas=args.replicas):
            print(json.dumps(d.to_row()))
        return 0

    # the fleet and the router ride in this process: stdlib-only imports
    from differential_transformer_replication_tpu_torch.config import (
        RouterConfig,
    )
    from differential_transformer_replication_tpu_torch.serving.fleet import (
        Fleet,
    )
    from differential_transformer_replication_tpu_torch.serving.router import (
        Router,
        serve_router,
    )

    server_args = list(args.server_args)
    if server_args and server_args[0] == "--":
        server_args = server_args[1:]
    fleet = Fleet(args.replicas, server_args=server_args,
                  host=args.host, fleet_log=args.fleet_log)
    print(f"[autoscaler] launching {args.replicas} replicas: "
          f"{fleet.urls}", file=sys.stderr)
    fleet.start()
    router = Router(
        fleet.urls, RouterConfig(),
        events=open_event_log(args.event_log, process="router"),
    ).start()
    httpd = serve_router(router, args.host, args.router_port)
    metrics_url = (
        f"http://{args.host}:{args.router_port}/fleet/metrics"
    )
    scaler = Autoscaler(
        cfg,
        poll=lambda: _http_poll(metrics_url),
        actuator=FleetActuator(fleet, router),
        registry=router.registry,
        events=open_event_log(args.event_log, process="autoscaler"),
        record_path=args.record,
    )
    stop = threading.Event()

    def _stop_all(signum, frame):
        del frame
        print(f"[autoscaler] signal {signum}: stopping",
              file=sys.stderr)
        stop.set()
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    _signal.signal(_signal.SIGTERM, _stop_all)
    _signal.signal(_signal.SIGINT, _stop_all)
    loop = threading.Thread(target=scaler.run, args=(stop,),
                            name="autoscaler", daemon=True)
    loop.start()
    print(f"[autoscaler] steering {metrics_url} between "
          f"{cfg.min_replicas} and {cfg.max_replicas} replicas",
          file=sys.stderr)
    try:
        httpd.serve_forever()
    finally:
        stop.set()
        loop.join(5.0)
        httpd.server_close()
        scaler.close()
        router.close()
        router.events.close()
        fleet.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
