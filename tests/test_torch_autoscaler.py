"""The port's control plane (serving/autoscaler.py, config.py's
``AutoscalerConfig``) against the repo's ``tools/autoscaler.py``, on the
CPU.

The control plane is pure host code in both packages, so the port's
copy is held to the tool exactly, in one process, on the same inputs:
``AutoscalerConfig`` and every one of its checks; the judges copied
from ``tools/perf_gate.py`` (``gate_key``) and ``tools/slo_report.py``
(``check``); the signals extracted from the same sequence of
``/fleet/metrics`` bodies; the pure ``decide()`` state machine on the
JAX tests' synthetic traces and on seeded random ones, byte for byte;
``tick()`` with one ``scale_flap`` plan armed in both packages' fault
modules, the same scripted poll and stepped clock (decisions, events,
the ``autoscaler_*`` exposition lines, actuator calls); record and
replay through both packages' functions and both CLIs; window stats,
canary verdicts and their reasons; and the canary controller and the
fleet actuator against fake fleets and routers.

The ``slow`` tests are the port's twins of the JAX package's three
control-plane chaos gates (tests/test_autoscaler.py), marked ``slow`` as
the JAX originals are, over tiny ``--device cpu`` port replicas behind
the port's router: a scale 2 -> 3 -> 2 with the scale-down victim
SIGKILLed mid-drain, a ``canary_regress`` canary and a
``quality_drift`` canary each rolled back unattended, with zero failed
client requests. The JAX gates drive the first with the JAX package's
``tools/serve_bench.py`` and pin each replica's XLA compile count; the
port's twin drives plain client threads (the port's ``serve_bench`` is
a later item) and checks instead that every replica ran on the CPU it
was asked for.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest

from differential_transformer_replication_tpu.config import (
    AutoscalerConfig as JAutoscalerConfig,
)
from differential_transformer_replication_tpu.obs.registry import (
    Registry as JRegistry,
)
from differential_transformer_replication_tpu.utils import faults as jfaults
from differential_transformer_replication_tpu_torch.config import (
    AutoscalerConfig,
    RouterConfig,
)
from differential_transformer_replication_tpu_torch.obs.registry import Registry
from differential_transformer_replication_tpu_torch.serving import autoscaler as tas
from differential_transformer_replication_tpu_torch.utils import faults as tfaults

REPO = Path(__file__).resolve().parents[1]
TOOLS = REPO / "tools"
MODULE = "differential_transformer_replication_tpu_torch.serving.autoscaler"


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", str(TOOLS / f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses resolve __module__ via here
    spec.loader.exec_module(mod)
    return mod


jas = _load_tool("autoscaler")
perf_gate = _load_tool("perf_gate")
slo_report = _load_tool("slo_report")

# (autoscaler module, config class, registry class, faults module)
PKGS = {"port": (tas, AutoscalerConfig, Registry, tfaults),
        "jax": (jas, JAutoscalerConfig, JRegistry, jfaults)}


@pytest.fixture(autouse=True)
def _clean_faults():
    tfaults.reset()
    jfaults.reset()
    yield
    tfaults.reset()
    jfaults.reset()


class _Events:
    """Recording event sink (obs/events.py surface)."""

    def __init__(self):
        self.rows = []

    def emit(self, event, **kw):
        self.rows.append((event, kw))

    def names(self):
        return [e for e, _ in self.rows]

    def flush(self):
        pass

    def close(self):
        pass


def _stepper(step=1.0):
    """Injectable monotonic clock: advances ``step`` per call."""
    t = {"v": 0.0}

    def now():
        t["v"] += step
        return t["v"]

    return now


def _hist_expo(good, total, extra=""):
    """A fleet body whose TTFT histogram has ``good`` fast requests out
    of ``total`` (cumulative, as scrapes are)."""
    return (
        f'serving_ttft_seconds_bucket{{le="0.5"}} {good}\n'
        f'serving_ttft_seconds_bucket{{le="+Inf"}} {total}\n'
        f"serving_ttft_seconds_count {total}\n" + extra
    )


def _rows(decisions):
    return [json.dumps(d.to_row()) for d in decisions]


# -- AutoscalerConfig ----------------------------------------------------


def test_config_fields_and_defaults_equal_jax():
    mine = [(f.name, f.type, f.default) for f in dataclasses.fields(AutoscalerConfig)]
    theirs = [(f.name, f.type, f.default) for f in dataclasses.fields(JAutoscalerConfig)]
    assert mine == theirs
    assert mine[0][0] == "poll_interval_s" and mine[-1][0] == "canary_max_validity_delta"
    cfg, jcfg = AutoscalerConfig(), JAutoscalerConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (dataclasses.asdict(cfg.replace(max_replicas=7, canary_fraction=0.5))
            == dataclasses.asdict(jcfg.replace(max_replicas=7, canary_fraction=0.5)))
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.min_replicas = 2


_NON_NEGATIVE = ("poll_interval_s", "scale_up_burn", "scale_down_burn",
                 "cooldown_up_s", "cooldown_down_s", "util_high", "util_low",
                 "stale_after_s", "ttft_threshold_s", "itl_threshold_s",
                 "canary_window_s", "canary_max_burn", "canary_max_regress",
                 "canary_max_drift", "canary_max_validity_delta")
_BAD = ([{name: -0.5} for name in _NON_NEGATIVE]
        + [{"min_replicas": 0}, {"min_replicas": 3, "max_replicas": 2},
           {"scale_up_sustain": 0}, {"scale_down_sustain": 0},
           {"slo_target": 0.0}, {"slo_target": 1.0},
           {"canary_fraction": 0.0}, {"canary_fraction": 1.0},
           {"canary_min_requests": 0}])


@pytest.mark.parametrize("bad", _BAD, ids=lambda b: "-".join(f"{k}={v}" for k, v in b.items()))
def test_config_check_raises_as_jax(bad):
    with pytest.raises(ValueError) as mine:
        AutoscalerConfig(**bad)
    with pytest.raises(ValueError) as theirs:
        JAutoscalerConfig(**bad)
    assert str(mine.value) == str(theirs.value)
    # the edge just inside the check passes in both
    edge = {k: (0.0 if isinstance(v, float) and v < 0 else v) for k, v in bad.items()}
    if edge != bad:
        assert dataclasses.asdict(AutoscalerConfig(**edge)) == \
            dataclasses.asdict(JAutoscalerConfig(**edge))


# -- the judges copied from tools/ ---------------------------------------


def test_gate_helpers_equal_perf_gate():
    assert tas.MAD_SIGMA == perf_gate.MAD_SIGMA
    assert tas._LOWER_BETTER_TOKENS == perf_gate._LOWER_BETTER_TOKENS
    rng = random.Random(0)
    for n in range(1, 9):
        xs = [rng.uniform(-5, 5) for _ in range(n)]
        assert tas.median(xs) == perf_gate.median(xs)
        assert tas.mad(xs) == perf_gate.mad(xs)
        assert tas.mad(xs, 1.0) == perf_gate.mad(xs, 1.0)
        assert tas.baseline_stats(xs) == perf_gate.baseline_stats(xs)
    for spec in ("value", "tokens_per_sec", "itl_ms.p95", "p95_ttft_s:lower",
                 "mfu:higher", "bucket_ms.flash_attention", "busy", "stall_s",
                 "x.y:lower"):
        assert tas.parse_key_spec(spec) == perf_gate.parse_key_spec(spec)
    for spec in ("value:sideways", "a:b"):
        with pytest.raises(ValueError) as mine:
            tas.parse_key_spec(spec)
        with pytest.raises(ValueError) as theirs:
            perf_gate.parse_key_spec(spec)
        assert str(mine.value) == str(theirs.value)
    doc = {"a": {"b": 2, "t": True, "s": "x"}, "v": 1.5, "n": None}
    for path in ("a.b", "a.t", "a.s", "v", "n", "a", "a.b.c", "missing", "a.zz"):
        assert tas.lookup(doc, path) == perf_gate.lookup(doc, path), path


def _gate_grid():
    rng = random.Random(1)
    grid = [
        ([], "value", 5, 0.1, 3.0, 3),                       # no samples
        ([{"value": 1.0}], "value", 5, 0.1, 3.0, 1),         # a single sample
        ([{"value": 1.0}, {"value": 2.0}], "value", 5, 0.1, 3.0, 3),  # too short
        ([{"value": 10.0}, {"other": 1}, {"value": 8.0}], "value", 5, 0.1, 0.0, 2),
        ([{"p95_ttft_s": 0.5}, {"p95_ttft_s": 1.0}], "p95_ttft_s:lower", 1, 0.5, 0.0, 2),
        ([{"p95_ttft_s": 0.5}, {"p95_ttft_s": 0.7}], "p95_ttft_s:lower", 1, 0.5, 0.0, 2),
        ([{"p95_ttft_s": 0.5}, {"p95_ttft_s": 0.2}], "p95_ttft_s:higher", 1, 0.5, 0.0, 2),
        ([{"x": {"tok": 100.0}}, {"x": {"tok": 80.0}}], "x.tok:higher", 5, 0.1, 3.0, 2),
        ([{"itl_ms": {"p95": v}} for v in (10, 11, 9, 10, 30)], "itl_ms.p95", 4, 0.1, 3.0, 3),
        ([{"itl_ms": {"p95": v}} for v in (10, 11, 9, 10, 10.5)], "itl_ms.p95", 4, 0.1, 3.0, 3),
    ]
    for _ in range(24):
        n = rng.randint(1, 9)
        key = rng.choice(["value", "value:lower", "ttft_ms", "mfu:higher"])
        path = key.split(":")[0]
        samples = [({path: rng.uniform(0, 10)} if rng.random() < 0.85 else {})
                   for _ in range(n)]
        grid.append((samples, key, rng.randint(1, 6), rng.choice([0.0, 0.1, 0.5]),
                     rng.choice([0.0, 3.0]), rng.randint(1, 4)))
    return grid


@pytest.mark.parametrize("case", range(len(_gate_grid())))
def test_gate_key_equals_perf_gate(case):
    samples, spec, window, max_regress, mad_factor, min_history = _gate_grid()[case]
    kw = dict(window=window, max_regress=max_regress, mad_factor=mad_factor,
              min_history=min_history)
    mine = tas.gate_key(samples, spec, **kw)
    assert mine == perf_gate.gate_key(samples, spec, **kw)
    assert mine["status"] in ("ok", "regressed", "insufficient_history")


def _objectives():
    base = {"target": 0.99, "error_ratio": 0.02, "burn_rate": 2.0}
    return [
        {},
        {"ttft": dict(base)},
        {"ttft": dict(base, burn_rate=0.5, error_ratio=0.005)},
        {"ttft": dict(base, burn_rate=None, error_ratio=None)},
        {"ttft": dict(base), "itl": dict(base, burn_rate=None), "note": "x",
         "n": 3, "no_burn": {"count": 1}},
        {"stale_replicas": ["a", "b"], "ttft": dict(base, burn_rate=0.1)},
        {"quality": {"drift_max": 0.4}},
        {"quality": {"drift_max": 0.1}},
        {"quality": {"drift_max": float("nan")}},
        {"quality": {"drift_max": None}},
        {"quality": "off", "canary_ttft": dict(base, burn_rate=5.0, error_ratio=0.05)},
    ]


_ARGS = [
    {"max_burn": 1.0, "require_traffic": False},
    {"max_burn": 1.0, "require_traffic": True},
    {"max_burn": 3.0, "require_traffic": True, "max_drift": 0.25},
    {"max_burn": 0.0, "require_traffic": False, "max_drift": 0.0},
    {"max_burn": 1.0, "require_traffic": False, "max_drift": 0.25,
     "max_scrape_age": 5.0},
]


@pytest.mark.parametrize("args", range(len(_ARGS)))
def test_check_equals_slo_report(args):
    a = SimpleNamespace(**_ARGS[args])
    for obj in _objectives():
        assert tas.check(obj, a) == slo_report.check(obj, a), obj
    # the shim the judge passes: no max_drift attribute at all
    for pkg in (tas, jas):
        shim = pkg._GateArgs(1.0)
        assert not hasattr(shim, "max_drift")
    for obj in _objectives():
        assert tas.check(obj, tas._GateArgs(1.0)) == \
            slo_report.check(obj, jas._GateArgs(1.0))


# -- signal extraction ---------------------------------------------------


GAUGES = (
    'serving_slots{replica="a"} 4\n'
    'serving_slot_occupancy{replica="a"} 2\n'
    'serving_queue_depth{replica="a"} 8\n'
    'serving_kv_utilization{replica="a"} 0.3\n'
    'fleet_replica_up{replica="a",state="up"} 1\n'
)
PRESSURE = (
    'serving_slots{replica="b"} 8\n'
    'serving_slot_occupancy{replica="b"} 3\n'
    'serving_queue_depth{replica="b"} 1\n'
    'serving_kv_pages_total{replica="b"} 100\n'
    'serving_kv_pages_free{replica="b"} 40\n'
    'serving_host_tier_budget_bytes{replica="b"} 1000\n'
    'serving_host_tier_bytes{replica="b"} 950\n'
    'fleet_replica_up{replica="b",state="up"} 1\n'
    'fleet_scrape_age_seconds{replica="b"} 0.2\n'
)
STALE = (
    'serving_slots{replica="c"} 4\n'
    'serving_queue_depth{replica="c"} 8\n'
    'fleet_replica_up{replica="c",state="up"} 0\n'
    'fleet_scrape_age_seconds{replica="c"} 10\n'
)
EXTRACT_TRACES = {
    # JAX's windowed burn and util scores: 10 new requests, all slow
    "windowed_burn": (dict(ttft_threshold_s=0.5, slo_target=0.9, stale_after_s=5.0),
                      [_hist_expo(10, 10, GAUGES), _hist_expo(10, 20, GAUGES),
                       _hist_expo(15, 30, GAUGES), _hist_expo(15, 30, GAUGES)]),
    "stale_dropped": (dict(stale_after_s=5.0),
                      ['serving_slots{replica="a"} 4\nserving_queue_depth{replica="a"} 8\n'
                       'fleet_scrape_age_seconds{replica="a"} 10\n', STALE + PRESSURE]),
    "stale_gate_off": (dict(stale_after_s=0.0), [STALE + PRESSURE]),
    # a replica left the aggregate: the cumulative counts step back
    "shrinking_fleet": ({}, [_hist_expo(0, 30), _hist_expo(0, 5), _hist_expo(3, 8),
                             _hist_expo(3, 8)]),
    "pressure_sources": ({}, [PRESSURE, PRESSURE + GAUGES, ""]),
    "itl_and_ttft": (dict(itl_threshold_s=0.1, slo_target=0.95),
                     [_hist_expo(4, 4) + 'serving_itl_seconds_bucket{le="0.1"} 10\n'
                      'serving_itl_seconds_bucket{le="+Inf"} 10\nserving_itl_seconds_count 10\n',
                      _hist_expo(9, 10) + 'serving_itl_seconds_bucket{le="0.1"} 12\n'
                      'serving_itl_seconds_bucket{le="+Inf"} 20\nserving_itl_seconds_count 20\n']),
}


@pytest.mark.parametrize("name", sorted(EXTRACT_TRACES))
def test_signal_extractor_equals_jax(name):
    kw, bodies = EXTRACT_TRACES[name]
    mine = tas.SignalExtractor(AutoscalerConfig(**kw))
    theirs = jas.SignalExtractor(JAutoscalerConfig(**kw))
    rows = []
    for body in bodies:
        row = mine.extract(body).to_row()
        assert json.dumps(row) == json.dumps(theirs.extract(body).to_row())
        rows.append(row)
    # the traces reach what they name
    if name == "windowed_burn":
        assert rows[0]["burn"] == 0.0 and rows[1]["burn"] == pytest.approx(10.0)
        assert rows[0]["util"] == 1.0 and rows[0]["replicas_up"] == 1
    elif name == "stale_dropped":
        assert rows[0]["stale_replicas"] == 1 and rows[0]["util"] == 0.0
        assert rows[1]["stale_replicas"] == 1 and rows[1]["util"] == 0.95
    elif name == "shrinking_fleet":
        assert rows[1]["burn"] is None and rows[2]["burn"] is not None
    elif name == "pressure_sources":
        assert rows[0]["util"] == 0.95 and rows[2]["util"] == 0.0


def test_replica_utils_equal_jax():
    keys = list(tas._UTIL_GAUGES)
    assert tas._UTIL_GAUGES == jas._UTIL_GAUGES
    rng = random.Random(2)
    cases = [{
        "serving_slots": 4.0, "serving_slot_occupancy": 2.0,
        "serving_queue_depth": 1.0, "serving_kv_utilization": 0.7,
        "serving_kv_pages_total": 100.0, "serving_kv_pages_free": 25.0,
        "serving_host_tier_budget_bytes": 1000.0, "serving_host_tier_bytes": 900.0,
    }, {}, {"serving_slots": 0.0, "serving_queue_depth": 5.0},
        {"serving_kv_pages_total": 10.0, "serving_kv_pages_free": 20.0},
        {"serving_kv_utilization": 3.0}]
    for _ in range(40):
        cases.append({k: rng.choice([0.0, rng.uniform(0, 20)])
                      for k in keys if rng.random() < 0.7})
    for m in cases:
        assert tas._replica_utils(m) == jas._replica_utils(m), m
    assert tas._replica_utils(cases[0]) == pytest.approx([0.5, 0.25, 0.7, 0.75, 0.9])


# -- the decision state machine ------------------------------------------


HIGH = dict(ok=True, burn=5.0, util=0.2)
LOW = dict(ok=True, burn=0.0, util=0.0)
MID = dict(ok=True, burn=0.7, util=0.5)
FAIL = dict(ok=False)
DECIDE_CFG = dict(min_replicas=1, max_replicas=3, scale_up_burn=1.0,
                  scale_down_burn=0.5, scale_up_sustain=3, scale_down_sustain=4,
                  cooldown_up_s=5.0, cooldown_down_s=10.0, util_high=0.85,
                  util_low=0.3)
# JAX's synthetic traces (tests/test_autoscaler.py TestAutoscalerDecide):
# (initial replicas, [(signals, now), ...])
DECIDE_TRACES = {
    "hysteresis": (1, [(HIGH, 0.0), (HIGH, 1.0), (HIGH, 2.0)]),
    "cooldown": (1, [(HIGH, float(t)) for t in range(8)]),
    "bounds": (1, [(HIGH, float(t)) for t in range(3)]
               + [(HIGH, t) for t in (7.0, 8.0, 9.0, 15.0, 16.0, 17.0)]
               + [(LOW, 30.0 + t) for t in range(40)]),
    "util_alone": (1, [(dict(ok=True, burn=None, util=0.95), float(t)) for t in range(3)]),
    "no_traffic_is_calm": (2, [(dict(ok=True, burn=None, util=0.0), float(t))
                               for t in range(4)]),
    "interleaved": (1, [(HIGH, 0.0), (HIGH, 1.0), (MID, 2.0), (HIGH, 3.0)]),
    "poll_failure": (1, [(HIGH, 0.0), (HIGH, 1.0), (FAIL, 2.0), (HIGH, 3.0),
                         (FAIL, 4.0), (FAIL, 5.0), (LOW, 6.0)]),
}


def _pair(cfg_kw, initial):
    return (tas.Autoscaler(AutoscalerConfig(**cfg_kw), initial_replicas=initial),
            jas.Autoscaler(JAutoscalerConfig(**cfg_kw), initial_replicas=initial))


@pytest.mark.parametrize("name", sorted(DECIDE_TRACES))
def test_decide_equals_jax_on_synthetic_traces(name):
    initial, trace = DECIDE_TRACES[name]
    mine, theirs = _pair(DECIDE_CFG, initial)
    got = []
    for sig, now in trace:
        a = mine.decide(tas.Signals(**sig), now)
        b = theirs.decide(jas.Signals(**sig), now)
        assert json.dumps(a.to_row()) == json.dumps(b.to_row())
        got.append(a)
    assert mine.current == theirs.current
    actions = [d.action for d in got]
    want = {"hysteresis": ["hold", "hold", "up"],
            "interleaved": ["hold"] * 4}.get(name)
    if want:
        assert actions == want
    if name == "bounds":
        assert actions.count("up") == 2 and actions.count("down") == 2
        assert "min_replicas" in got[-1].reason and mine.current == 1
    if name == "poll_failure":
        assert "poll failed (2 consecutive)" in got[5].reason


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decide_equals_jax_on_a_random_trace(seed):
    rng = random.Random(seed)
    lo = rng.randint(1, 2)
    cfg = dict(min_replicas=lo, max_replicas=lo + rng.randint(0, 3),
               scale_up_burn=rng.choice([1.0, 2.0]), scale_down_burn=0.5,
               scale_up_sustain=rng.randint(1, 3), scale_down_sustain=rng.randint(1, 5),
               cooldown_up_s=rng.choice([0.0, 2.0, 5.0]),
               cooldown_down_s=rng.choice([0.0, 4.0, 10.0]),
               util_high=0.85, util_low=0.3)
    mine, theirs = _pair(cfg, lo)
    now, actions = 0.0, set()
    for _ in range(250):
        now += rng.choice([0.25, 0.5, 1.0, 3.0])
        regime = rng.random()
        if regime < 0.08:
            sig = dict(ok=False)
        elif regime < 0.45:
            sig = dict(ok=True, burn=rng.choice([None, rng.uniform(1.0, 20.0)]),
                       util=rng.uniform(0.5, 1.0))
        else:
            sig = dict(ok=True, burn=rng.choice([None, rng.uniform(0.0, 0.6)]),
                       util=rng.uniform(0.0, 0.4))
        sig.update(queue_depth=float(rng.randint(0, 30)),
                   replicas_up=rng.randint(0, 4), stale_replicas=rng.randint(0, 1))
        a = mine.decide(tas.Signals(**sig), now)
        b = theirs.decide(jas.Signals(**sig), now)
        assert json.dumps(a.to_row()) == json.dumps(b.to_row())
        actions.add(a.action)
    assert mine.current == theirs.current
    if cfg["max_replicas"] > cfg["min_replicas"]:
        assert {"up", "down"} <= actions


# -- tick: polling, scale_flap, events, metrics, actuation ---------------


class _Actuator:
    """A scripted actuator: records its calls and raises on the calls
    named in ``fail`` (1-based over all scale calls)."""

    def __init__(self, n, fail=()):
        self.n, self.fail, self.calls = n, set(fail), []

    def replicas(self):
        return self.n

    def _call(self, what):
        self.calls.append(what)
        if len(self.calls) in self.fail:
            raise RuntimeError(f"SIGKILL mid-{what}")
        self.n += 1 if what == "scale_up" else -1

    def scale_up(self, n=1):
        self._call("scale_up")
        return ["http://127.0.0.1:1"]

    def scale_down(self):
        self._call("scale_down")
        return "http://127.0.0.1:2"


def _tick_bodies():
    """20 polls: idle bodies under the flap window, a refused poll, then
    slow traffic (pressure) and calm again."""
    out = [_hist_expo(0, 0, GAUGES.replace(" 8\n", " 0\n"))] * 8
    out.append(OSError("connection refused"))
    total = good = 0
    for k in range(8):  # all slow: burn 100 and a full queue
        total += 10
        out.append(_hist_expo(good, total, GAUGES))
    for k in range(12):  # calm: fast and idle
        total += 10
        good += 10
        out.append(_hist_expo(good, total, ""))
    return out


def _tick_run(pkg, tmp_path, plan):
    mod, cfg_cls, reg_cls, flt = PKGS[pkg]
    flt.arm(plan)
    bodies = iter(_tick_bodies())

    def poll():
        b = next(bodies)
        if isinstance(b, Exception):
            raise b
        return b

    cfg = cfg_cls(min_replicas=1, max_replicas=3, scale_up_sustain=2,
                  scale_down_sustain=3, cooldown_up_s=1.0, cooldown_down_s=2.0,
                  ttft_threshold_s=0.5, slo_target=0.9)
    registry, events = reg_cls(), _Events()
    act = _Actuator(2, fail=(1,))
    sc = mod.Autoscaler(cfg, poll=poll, actuator=act, registry=registry,
                        events=events, now_fn=_stepper(),
                        record_path=str(tmp_path / f"{pkg}.jsonl"))
    decisions = [sc.tick() for _ in range(len(_tick_bodies()))]
    sc.close()
    flt.reset()
    expo = [line for line in registry.render().splitlines() if "autoscaler_" in line]
    return decisions, events.rows, expo, act.calls, sc.current, \
        (tmp_path / f"{pkg}.jsonl").read_text()


def test_tick_with_scale_flap_equals_jax(tmp_path):
    plan = "scale_flap@0-7"
    mine = _tick_run("port", tmp_path, plan)
    theirs = _tick_run("jax", tmp_path, plan)
    assert _rows(mine[0]) == _rows(theirs[0])
    assert mine[1] == theirs[1]            # event names and fields
    assert mine[2] == theirs[2]            # the autoscaler_* exposition lines
    assert mine[3] == theirs[3]            # actuator calls
    assert mine[4] == theirs[4]
    assert mine[5] == theirs[5]            # the --record rows, byte for byte
    decisions, events, expo, calls, current, _ = mine
    # the flap window moved nothing; the refused poll held; pressure's
    # first up failed and reverted, the next took; calm scaled down
    assert all(d.action == "hold" for d in decisions[:8])
    assert [r["signals"]["burn"] for r in map(json.loads, mine[5].splitlines()[:4])] \
        == [99.0, 0.0, 99.0, 0.0]
    assert "poll failed" in decisions[8].reason
    assert calls == ["scale_up", "scale_up", "scale_down", "scale_down"]
    assert [d.action for d in decisions].count("up") == 2
    names = [e for e, _ in events]
    assert names.count("autoscaler_decision") == len(decisions)
    assert "autoscaler_scale_failed" in names and "autoscaler_scaled" in names
    failed = next(kw for e, kw in events if e == "autoscaler_scale_failed")
    assert failed["replicas"] == 2 and failed["action"] == "up"
    assert any("poll_error" in kw for e, kw in events if e == "autoscaler_decision")
    for fam in ("autoscaler_replicas_target", "autoscaler_burn_observed",
                "autoscaler_util_observed", "autoscaler_decisions_total"):
        assert any(line.startswith(fam) for line in expo), fam
    assert current == 1  # 2, the failed up reverted, up to 3, calm down twice


def test_tick_without_a_poll_source_or_with_the_flap_unarmed_equals_jax(tmp_path):
    rows = []
    for pkg in ("port", "jax"):
        mod, cfg_cls, _, _ = PKGS[pkg]
        events = _Events()
        sc = mod.Autoscaler(cfg_cls(), events=events, now_fn=_stepper())
        d = sc.tick()
        rows.append((json.dumps(d.to_row()), events.rows))
    assert rows[0] == rows[1]
    assert rows[0][1][0][1]["poll_error"] == "no poll source configured"
    mine = _tick_run("port", tmp_path, "")
    theirs = _tick_run("jax", tmp_path, "")
    assert _rows(mine[0]) == _rows(theirs[0]) and mine[1:5] == theirs[1:5]


# -- record and replay ---------------------------------------------------


REPLAY_CFG = dict(min_replicas=1, max_replicas=4, scale_up_sustain=2,
                  scale_down_sustain=3, cooldown_up_s=1.0, cooldown_down_s=2.0,
                  ttft_threshold_s=0.5, slo_target=0.9)
REPLAY_FLAGS = ["--min-replicas", "1", "--max-replicas", "4", "--up-sustain", "2",
                "--down-sustain", "3", "--cooldown-up", "1.0", "--cooldown-down", "2.0",
                "--ttft", "0.5", "--target", "0.9", "--replicas", "1"]


def _cli(argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, *argv], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def test_record_replays_byte_for_byte_through_both_packages_and_clis(tmp_path):
    record = tmp_path / "scaler.jsonl"
    bodies = [_hist_expo(0, 10), _hist_expo(0, 20), _hist_expo(0, 30)] + \
        [_hist_expo(10 * k, 30 + 10 * k) for k in range(1, 9)]
    it = iter(bodies)
    tfaults.arm("scale_flap@9")  # a recorded flap replays as recorded
    sc = tas.Autoscaler(AutoscalerConfig(**REPLAY_CFG), poll=lambda: next(it),
                        registry=Registry(), now_fn=_stepper(),
                        record_path=str(record), initial_replicas=1)
    live = [sc.tick() for _ in range(len(bodies))]
    sc.close()
    tfaults.reset()
    assert {"up", "down"} <= {d.action for d in live}
    rows = [json.loads(line) for line in record.read_text().splitlines() if line]
    want = _rows(live)
    assert [json.dumps(r["decision"]) for r in rows] == want
    assert rows[9]["signals"]["burn"] == 0.0 and rows[9]["signals"]["util"] == 0.0
    assert _rows(tas.replay(rows, AutoscalerConfig(**REPLAY_CFG), initial_replicas=1)) == want
    assert _rows(jas.replay(rows, JAutoscalerConfig(**REPLAY_CFG), initial_replicas=1)) == want
    text = "".join(line + "\n" for line in want)
    assert _cli(["-m", MODULE, "--replay", str(record), *REPLAY_FLAGS]) == text
    assert _cli([str(TOOLS / "autoscaler.py"), "--replay", str(record),
                 *REPLAY_FLAGS]) == text


def test_cli_flags_equal_the_tool():
    import re

    def flags(path):
        return sorted(set(re.findall(r'add_argument\("(--[a-z-]+)"',
                                     Path(path).read_text())))

    assert flags(tas.__file__) == flags(TOOLS / "autoscaler.py")


# -- canary judgment -----------------------------------------------------


def test_histogram_quantile_equals_jax():
    cases = [([], [], 0, 0.95), ([0.1, 0.5, 1.0], [5, 9, 10], 10, 0.5),
             ([0.1, 0.5, 1.0], [5, 9, 10], 10, 0.95), ([0.1], [1], 10, 0.95),
             ([0.1, 0.2], [0, 0], 0, 0.5), ([0.1, 0.2, math.inf], [3, 3, 4], 4, 0.99),
             ([0.1, 0.2], [2, 4], 4, 0.0)]
    for args in cases:
        assert tas.histogram_quantile(*args) == jas.histogram_quantile(*args), args
    assert tas.histogram_quantile([0.1], [1], 10, 0.95) == math.inf


_Q_B = ("serving_token_entropy_sum 10.0\nserving_token_entropy_count 4\n"
        "serving_logit_margin_sum 2.0\nserving_logit_margin_count 4\n"
        "serving_quality_drift 0.05\nserving_constraint_validity_rate 1.0\n")
_Q_A = ("serving_token_entropy_sum 55.0\nserving_token_entropy_count 14\n"
        "serving_logit_margin_sum 4.0\nserving_logit_margin_count 14\n"
        "serving_quality_drift 0.42\nserving_constraint_validity_rate 0.9\n")
WINDOWS = {
    "deltas": ([(_hist_expo(5, 5), _hist_expo(14, 15))], 0.5, 0.9),
    "restart_clamp": ([(_hist_expo(14, 15), _hist_expo(5, 5))], 0.5, 0.9),
    "empty": ([("", "")], 0.5, 0.9),
    "no_pairs": ([], 0.5, 0.9),
    "quality": ([(_hist_expo(5, 5, _Q_B), _hist_expo(14, 15, _Q_A))], 0.5, 0.9),
    "quality_clamp": ([(_hist_expo(5, 5, _Q_A), _hist_expo(14, 15, _Q_B))], 0.5, 0.9),
    "worst_drift": ([(_hist_expo(0, 0), _hist_expo(10, 10, "serving_quality_drift 0.01\n")),
                     (_hist_expo(0, 0), _hist_expo(9, 10, "serving_quality_drift 0.6\n"))],
                    0.5, 0.9),
    "inf_drift": ([(_hist_expo(0, 0), _hist_expo(10, 10, "serving_quality_drift 0.01\n")),
                   (_hist_expo(0, 0), _hist_expo(10, 10, "serving_quality_drift +Inf\n"))],
                  0.5, 0.9),
    "nan_drift": ([(_hist_expo(0, 0), _hist_expo(10, 10, "serving_quality_drift NaN\n"
                                                "serving_constraint_validity_rate NaN\n"))],
                  0.5, 0.9),
    "pooled": ([(_hist_expo(0, 0), _hist_expo(10, 10)), (_hist_expo(3, 5), _hist_expo(3, 25))],
               0.5, 0.99),
}


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_window_stats_equal_jax(name):
    pairs, thr, target = WINDOWS[name]
    mine = tas.window_stats(pairs, thr, target)
    assert json.dumps(mine) == json.dumps(jas.window_stats(pairs, thr, target))
    if name == "quality":
        assert mine["entropy_mean"] == pytest.approx(4.5) and mine["drift"] == 0.42
        assert mine["validity"] == 0.9
    elif name == "inf_drift":
        assert mine["drift"] == math.inf
    elif name == "deltas":
        assert mine["count"] == 10.0 and mine["p95_ttft_s"] == math.inf


def _stats(**kw):
    base = {"count": 20.0, "error_ratio": 0.0, "burn_rate": 0.0,
            "target": 0.99, "p95_ttft_s": 0.5}
    base.update(kw)
    return base


JUDGE_CFG = dict(canary_min_requests=8, canary_max_burn=1.0, canary_max_regress=0.5)
# JAX's TestCanaryJudge cases: (canary, control, config overrides, reason word)
JUDGE = {
    "thin_evidence": (_stats(count=3.0), _stats(), {}, "inconclusive"),
    "burn": (_stats(burn_rate=5.0, error_ratio=0.05), _stats(), {}, "burn rate"),
    "p95_regressed": (_stats(p95_ttft_s=1.0), _stats(p95_ttft_s=0.5), {}, "p95"),
    "p95_within_slack": (_stats(p95_ttft_s=0.7), _stats(p95_ttft_s=0.5), {}, "promote"),
    "unbounded_p95": (_stats(p95_ttft_s=math.inf), _stats(p95_ttft_s=0.5), {},
                      "histogram range"),
    "canary_p95_none": (_stats(p95_ttft_s=None), _stats(p95_ttft_s=0.5), {},
                        "histogram range"),
    "idle_control": (_stats(p95_ttft_s=2.0), _stats(p95_ttft_s=None, count=0.0), {},
                     "promote"),
    "inf_control": (_stats(p95_ttft_s=2.0), _stats(p95_ttft_s=math.inf), {}, "promote"),
    "drift": (_stats(drift=0.30), _stats(), {}, "quality drift"),
    "drift_none": (_stats(drift=None), _stats(), {}, "promote"),
    "drift_zero": (_stats(drift=0.0), _stats(), {}, "promote"),
    "drift_in_budget": (_stats(drift=0.24), _stats(), {}, "promote"),
    "drift_nan": (_stats(drift=float("nan")), _stats(), {}, "promote"),
    "drift_inf": (_stats(drift=math.inf), _stats(), {}, "quality drift"),
    "drift_gate_off": (_stats(drift=5.0), _stats(), {"canary_max_drift": 0.0}, "promote"),
    "validity": (_stats(validity=0.90), _stats(validity=1.0), {}, "constraint validity"),
    "validity_in_budget": (_stats(validity=0.96), _stats(validity=1.0), {}, "promote"),
    "validity_base_perfect": (_stats(validity=0.90), _stats(validity=None), {}, "1.000"),
    "validity_base_nan": (_stats(validity=0.97), _stats(validity=float("nan")), {},
                          "promote"),
    "validity_gate_off": (_stats(validity=0.1), _stats(validity=1.0),
                          {"canary_max_validity_delta": 0.0}, "promote"),
    "latency_before_quality": (_stats(burn_rate=5.0, error_ratio=0.05, drift=0.9), _stats(),
                               {}, "burn rate"),
}


@pytest.mark.parametrize("name", sorted(JUDGE))
def test_judge_canary_equals_jax(name):
    canary, control, over, word = JUDGE[name]
    mine = tas.judge_canary(canary, control, AutoscalerConfig(**JUDGE_CFG, **over))
    assert mine == jas.judge_canary(canary, control, JAutoscalerConfig(**JUDGE_CFG, **over))
    verdict, reason = mine
    assert verdict == ("promote" if word == "promote" else "rollback")
    assert word == "promote" or word in reason


# -- the canary controller and the fleet actuator -----------------------


class _FakeCanaryFleet:
    def __init__(self):
        self.replicas = [SimpleNamespace(index=0, url="http://c0"),
                         SimpleNamespace(index=1, url="http://c1")]
        self.relaunches = []

    def relaunch_replica(self, index, server_args=None, extra_env=None,
                         argv=None, env=None, ready_check=None):
        self.relaunches.append({"index": index, "server_args": server_args,
                                "extra_env": extra_env, "argv": argv, "env": env,
                                "ready_check": ready_check is not None})
        return ["old", "argv"], {"OLD": "1"}


class _FakeCanaryRouter:
    def __init__(self):
        self.calls = []
        self.replicas = []

    def set_canary(self, url, fraction=0.0):
        self.calls.append((url, fraction))


def _canary_run(pkg, canary_after, control_after, **run_kw):
    mod, cfg_cls, _, _ = PKGS[pkg]
    fleet, router, events = _FakeCanaryFleet(), _FakeCanaryRouter(), _Events()
    phase = {"v": "before"}
    expos = {("http://c1", "before"): _hist_expo(0, 0),
             ("http://c1", "after"): canary_after,
             ("http://c0", "before"): _hist_expo(0, 0),
             ("http://c0", "after"): control_after}
    sleeps = []

    def fetch(u):
        body = expos[(u, phase["v"])]
        if body is None:
            raise OSError("dead control replica")
        return body

    def sleep(s):
        sleeps.append(s)
        phase["v"] = "after"

    cc = mod.CanaryController(
        fleet, router,
        cfg_cls(canary_fraction=0.25, canary_window_s=0.5, canary_min_requests=8,
                ttft_threshold_s=0.5, slo_target=0.9),
        events=events, sleep_fn=sleep, fetch=fetch)
    record = cc.run(**run_kw)
    return record, fleet.relaunches, router.calls, events.rows, sleeps


CANARY = {
    "regressed": (_hist_expo(0, 20), _hist_expo(20, 20), "rollback"),
    "healthy": (_hist_expo(20, 20), _hist_expo(20, 20), "promote"),
    "thin": (_hist_expo(3, 3), _hist_expo(20, 20), "rollback"),
    "dead_control": (_hist_expo(20, 20), None, "promote"),
}


@pytest.mark.parametrize("name", sorted(CANARY))
def test_canary_controller_equals_jax(name):
    canary_after, control_after, verdict = CANARY[name]
    kw = dict(server_args=["--model", "new"], extra_env={"DTX_FAULTS": "canary_regress"})
    if name != "healthy":
        kw["index"] = 1  # else the highest index, as JAX's
    mine = _canary_run("port", canary_after, control_after, **kw)
    theirs = _canary_run("jax", canary_after, control_after, **kw)
    assert json.dumps(mine[0]) == json.dumps(theirs[0])
    assert mine[1:] == theirs[1:]
    record, relaunches, calls, events, sleeps = mine
    assert record["verdict"] == verdict and sleeps == [0.5]
    assert relaunches[0]["server_args"] == ["--model", "new"]
    assert calls == [("http://c1", 0.25), (None, 0.0)]
    names = [e for e, _ in events]
    if verdict == "rollback":
        # the rollback relaunch passes back EXACTLY what the first returned
        assert len(relaunches) == 2
        assert relaunches[1]["argv"] == ["old", "argv"] and relaunches[1]["env"] == {"OLD": "1"}
        assert names.index("canary_started") < names.index("canary_judged") \
            < names.index("canary_rolled_back")
    else:
        assert len(relaunches) == 1 and "canary_promoted" in names


def _actuator_run(pkg, with_migrate):
    mod = PKGS[pkg][0]
    calls = []

    class _F:
        replicas = [1, 2]

        def scale_up(self, n=1):
            calls.append(("fleet_up", n))
            return ["http://127.0.0.1:19007", "http://127.0.0.1:19008"][:n]

        def scale_down(self, score_of=None, pre_drain=None):
            # the canary must be invisible to victim selection
            calls.append(("fleet_down", score_of("http://c"), score_of("http://a"),
                          score_of("http://zz"),
                          None if pre_drain is None else pre_drain("http://a")))
            return "http://a"

    class _R:
        replicas = [SimpleNamespace(url="http://a", score=lambda: 0.25),
                    SimpleNamespace(url="http://c", score=lambda: 0.0)]

        def canary(self):
            return "http://c", 0.3

        def add_replica(self, url):
            calls.append(("router_add", url))

        def remove_replica(self, url):
            calls.append(("router_remove", url))

    router = _R()
    if with_migrate:
        router.migrate_out = lambda url: calls.append(("migrate_out", url)) or {"migrated": 1}
    act = mod.FleetActuator(_F(), router)
    out = [act.replicas(), act.scale_up(), act.scale_up(2), act.scale_down()]
    return out, calls


@pytest.mark.parametrize("with_migrate", [False, True])
def test_fleet_actuator_equals_jax(with_migrate):
    mine = _actuator_run("port", with_migrate)
    assert mine == _actuator_run("jax", with_migrate)
    out, calls = mine
    assert out[0] == 2 and out[3] == "http://a"
    assert calls[:2] == [("fleet_up", 1), ("router_add", "http://127.0.0.1:19007")]
    down = next(c for c in calls if c[0] == "fleet_down")
    assert down[1:4] == (None, 0.25, None)
    assert calls[-1] == ("router_remove", "http://a")
    if with_migrate:
        assert ("migrate_out", "http://a") in calls and down[4] == {"migrated": 1}


# -- chaos over port replicas (slow tier, as the JAX originals) ---------------


TINY = ["--device", "cpu", "--num-slots", "2", "--prefill-chunk", "16",
        "--prefill-budget", "32", "--drain-timeout", "60", "--max-queue-len", "0"]


def _post(url, payload, timeout=90):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")
    except OSError as e:
        return -1, {"error": repr(e)}


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


def _warm_ladder(url):
    for n in (1, 2, 4, 8, 16):
        status, body = _post(url + "/generate", {
            "prompt_ids": [1] * n, "max_new_tokens": 2, "temperature": 0.0,
            "seed": 0}, timeout=240)
        assert status == 200, (url, n, body)


def _chaos_router_cfg():
    return RouterConfig(probe_interval_s=0.05, probe_backoff_s=0.05,
                        probe_backoff_max_s=0.5, eject_after=2, readmit_after=2,
                        max_attempts=4, retry_base_s=0.02, retry_cap_s=0.2,
                        default_deadline_s=120.0, wait_for_replica_s=5.0)


class _ChaosFront:
    """A started port fleet of ``n`` tiny CPU replicas, each warmed, the
    port's router in front over HTTP, and client threads posting the
    JAX gates' request mix until stopped."""

    def __init__(self, n, server_args=TINY):
        from differential_transformer_replication_tpu_torch.serving import fleet as tfleet
        from differential_transformer_replication_tpu_torch.serving.router import (
            Router,
            serve_router,
        )

        self.fleet = tfleet.Fleet(n, server_args=server_args, max_restarts=3,
                                  backoff_base=0.2, backoff_max=2.0,
                                  ready_timeout_s=240.0)
        self.router = self.httpd = None
        self.results, self._lock = [], threading.Lock()
        self._stop, self.workers = threading.Event(), []
        self.fleet.start()
        for url in self.fleet.urls:
            _warm_ladder(url)
        self.router = Router(self.fleet.urls, _chaos_router_cfg()).start()
        self.httpd = serve_router(self.router, port=0)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/generate"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def load(self, n_workers):
        def client(wid):
            k = 0
            while not self._stop.is_set():
                k += 1
                rec = _post(self.url, {
                    "prompt_ids": [1 + (wid + k) % 7] * (1 + k % 12),
                    "max_new_tokens": 2, "temperature": 0.0,
                    "seed": wid * 1000 + k, "timeout": 60})
                with self._lock:
                    self.results.append(rec)

        self.workers = [threading.Thread(target=client, args=(w,)) for w in range(n_workers)]
        for w in self.workers:
            w.start()

    def join(self):
        self._stop.set()
        for w in self.workers:
            w.join(timeout=180)
            assert not w.is_alive(), "client hung"
        bad = [(s, b) for s, b in self.results if s != 200]
        assert not bad, f"{len(bad)} failed requests, first: {bad[:3]}"
        assert len(self.results) >= 10

    def close(self):
        self._stop.set()
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
        if self.router is not None:
            self.router.close()
        self.fleet.stop()


@pytest.mark.slow
def test_chaos_sigkill_mid_scale_down_zero_loss():
    """Twin of JAX's trace-replay gate: load through the router while
    the fleet scales 2 -> 3 -> 2 by the port's ``FleetActuator``, the
    scale-down victim SIGKILLed mid-drain; zero failed client requests,
    the victim's slot released from the fleet and the router."""
    front = _ChaosFront(2)
    try:
        fleet, router = front.fleet, front.router
        actuator = tas.FleetActuator(fleet, router)
        (new_url,) = actuator.scale_up()
        by_url = {r.url: r for r in router.replicas}
        deadline = time.time() + 240
        while time.time() < deadline and not by_url[new_url].eligible():
            time.sleep(0.05)
        assert by_url[new_url].eligible(), "router never admitted"
        _warm_ladder(new_url)
        assert fleet.replicas[-1].index == 2 and len(router.replicas) == 3
        front.load(4)
        time.sleep(4.0)  # let the load ramp onto the 3-wide fleet
        down_url = []
        th = threading.Thread(target=lambda: down_url.append(actuator.scale_down()))
        th.start()
        kill_deadline = time.time() + 30
        victim = None
        while victim is None and time.time() < kill_deadline:
            victim = next((r for r in fleet.replicas if r.expected_exit), None)
            time.sleep(0.02)
        assert victim is not None, "scale_down never picked a victim"
        time.sleep(0.2)  # let the drain actually begin
        if victim.alive():  # SIGKILL mid-drain (uncatchable)
            victim.proc.send_signal(signal.SIGKILL)
        th.join(120)
        assert not th.is_alive(), "scale_down hung"
        assert down_url and down_url[0] == victim.url
        assert len(fleet.replicas) == 2 and len(router.replicas) == 2
        assert victim.index not in [r.index for r in fleet.replicas]
        time.sleep(2.0)  # serve on the 2-wide fleet
        front.join()
        assert {_get(u + "/health")["device"] for u in fleet.urls} == {"cpu"}
        for url in fleet.urls:
            _warm_ladder(url)
    finally:
        front.close()


def _canary_gate(extra_env, cfg, server_args=TINY):
    front = _ChaosFront(2, server_args)
    try:
        fleet = front.fleet
        front.load(6)
        time.sleep(1.0)
        original_argv = list(fleet.replicas[1].argv)
        record = tas.CanaryController(fleet, front.router, cfg).run(
            index=1, extra_env=extra_env)
        time.sleep(1.0)  # serve a little while fully healed
        front.join()
        # ...rolled back onto its ORIGINAL command line, faults gone
        assert fleet.replicas[1].argv == original_argv
        assert "DTX_FAULTS" not in (fleet.replicas[1].env or {})
        assert front.router.canary() == (None, 0.0)
        assert len(fleet.replicas) == 2
        assert {_get(u + "/health")["device"] for u in fleet.urls} == {"cpu"}
        return record
    finally:
        front.close()


@pytest.mark.slow
def test_chaos_canary_regress_auto_rollback_zero_loss():
    """Twin of JAX's gate: a ``canary_regress`` canary (every engine
    iteration sleeps 0.75 s) is convicted on the burn gate, on real
    evidence, and rolled back unattended with zero failed requests."""
    record = _canary_gate(
        {"DTX_FAULTS": "canary_regress", "DTX_CANARY_REGRESS_S": "0.75"},
        AutoscalerConfig(canary_fraction=0.5, canary_window_s=12.0,
                         canary_min_requests=2, ttft_threshold_s=0.5,
                         slo_target=0.9, canary_max_burn=1.0))
    assert record["verdict"] == "rollback", record
    assert record["canary"]["count"] >= 2, record
    assert record["canary"]["burn_rate"] > 1.0, record
    assert "inconclusive" not in record["reason"], record


@pytest.mark.slow
def test_chaos_canary_quality_drift_auto_rollback_zero_loss(tmp_path):
    """Twin of JAX's quality gate: a canary whose params drift silently
    (``quality_drift``: finite logits, flat latency) is convicted by the
    PSI drift against a fingerprint recorded on the port's engine over
    the server's demo model, every latency gate given generous slack."""
    import torch

    from differential_transformer_replication_tpu_torch.config import (
        ModelConfig,
        ServingConfig,
    )
    from differential_transformer_replication_tpu_torch.models import init_model
    from differential_transformer_replication_tpu_torch.obs.quality import save_fingerprint
    from differential_transformer_replication_tpu_torch.serving.engine import ServingEngine

    model_cfg = ModelConfig(model="control", vocab_size=512, n_embd=64, n_head=2,
                            n_layer=2, block_size=128, compute_dtype="float32")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)  # the server's demo model (serving/server.py)
    eng = ServingEngine(init_model(gen, model_cfg), model_cfg,
                        ServingConfig(num_slots=2, prefill_chunk=16, prefill_budget=32,
                                      quality_telemetry=True), device="cpu")
    eng.generate([[1 + (w + k) % 7] * (1 + k % 12) for w in range(6) for k in range(1, 8)],
                 max_new_tokens=2, temperature=0.0)
    assert eng.quality_stats()["tokens_observed"] >= 32
    fp = str(tmp_path / "quality_fp.json")
    save_fingerprint(fp, eng.quality_fingerprint(meta={"model": "control",
                                                       "source": "chaos-test"}))
    record = _canary_gate(
        {"DTX_FAULTS": "quality_drift@2"},
        AutoscalerConfig(canary_fraction=0.5, canary_window_s=15.0,
                         canary_min_requests=2, ttft_threshold_s=30.0,
                         slo_target=0.9, canary_max_burn=1000.0,
                         canary_max_regress=100.0, canary_max_drift=0.25),
        TINY + ["--model", "control", "--quality-telemetry",
                "--quality-fingerprint", fp])
    # convicted on the QUALITY axis, not on any latency gate
    assert record["verdict"] == "rollback", record
    assert "quality drift" in record["reason"], record
    assert record["canary"]["drift"] > 0.25, record
    assert record["canary"]["count"] >= 2, record
    assert (record["canary"]["burn_rate"] or 0.0) <= 1000.0
