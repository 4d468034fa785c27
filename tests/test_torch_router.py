"""The port's router (serving/router.py) against the JAX package's, on
the CPU.

The router is pure host code in both packages, so the port's copy is
held to the JAX one exactly, in one process, on the same inputs: both
routers are built alike (the same scripted replicas, canned HTTP
handlers on loopback port 0, ``rng=random.Random(0)``, injected probe
clocks) and must give the same pick sequences, replica state
transitions and replies (status, body with trace ids normalised, and
``Retry-After``) through failover, the deadline budget, hedging,
affinity and ``repin``, the canary split and fleet membership changes.
The two registries' expositions are byte-identical except
``build_info``'s version label (the clocks that stamp durations and the
start time are frozen alike); ``aggregate_fleet_metrics`` and
``/fleet/metrics`` give byte-identical output on the same bodies; one
plan arming all four router fault kinds gives the same replies,
counters and events in both.

Every scenario runs first through the port's router, then, with the
canned replicas' hit counts reset, through the JAX router at the same
URLs, so replica names agree without any mapping.
"""

from __future__ import annotations

import json
import random
import re
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from differential_transformer_replication_tpu.config import RouterConfig as JRouterConfig
from differential_transformer_replication_tpu.obs import registry as jregistry
from differential_transformer_replication_tpu.serving import router as jrouter
from differential_transformer_replication_tpu.utils import faults as jfaults
from differential_transformer_replication_tpu_torch.config import RouterConfig
from differential_transformer_replication_tpu_torch.obs import registry as tregistry
from differential_transformer_replication_tpu_torch.serving import router as trouter
from differential_transformer_replication_tpu_torch.utils import faults as tfaults

# (router module, config class, faults module) of each package
PKGS = {"port": (trouter, RouterConfig, tfaults),
        "jax": (jrouter, JRouterConfig, jfaults)}

OK = {"request_id": 1, "prompt_ids": [1], "tokens": [2, 3],
      "finish_reason": "length", "ttft_ms": 1.0}
EXPO = ("# TYPE serving_queue_depth gauge\nserving_queue_depth 2\n"
        "# TYPE serving_slot_occupancy gauge\nserving_slot_occupancy 1\n"
        "# TYPE serving_slots gauge\nserving_slots 4\n"
        "# TYPE serving_kv_utilization gauge\nserving_kv_utilization 0.25\n"
        "# TYPE serving_requests_completed_total counter\n"
        "serving_requests_completed_total 7\n")


@pytest.fixture(autouse=True)
def _clean_faults():
    tfaults.reset()
    jfaults.reset()
    yield
    tfaults.reset()
    jfaults.reset()


def _cfg(pkg, **kw):
    kw.setdefault("probe_interval_s", 0.05)
    kw.setdefault("probe_backoff_s", 0.05)
    kw.setdefault("probe_backoff_max_s", 0.4)
    kw.setdefault("retry_base_s", 0.001)
    kw.setdefault("retry_cap_s", 0.01)
    kw.setdefault("wait_for_replica_s", 0.0)
    return PKGS[pkg][1](**kw)


class _Replica:
    """A scripted replica on loopback: POST /generate answers from
    ``script`` by hit count (the last entry repeats); GET /ready,
    /metrics and /inflight answer canned bodies."""

    def __init__(self, script, metrics=EXPO, ready=(200, {"ready": True, "status": "healthy"})):
        self.script, self.metrics, self.ready = script, metrics, ready
        self.hits = 0
        self.lock = threading.Lock()
        owner = self

        class H(BaseHTTPRequestHandler):
            def _send(self, status, data, headers=()):
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length", "0")))
                with owner.lock:
                    i = min(len(owner.script) - 1, owner.hits)
                    owner.hits += 1
                status, body, headers = owner.script[i]
                data = body if isinstance(body, bytes) else json.dumps(body).encode()
                self._send(status, data, headers.items())

            def do_GET(self):
                if self.path == "/ready":
                    self._send(owner.ready[0], json.dumps(owner.ready[1]).encode())
                elif self.path == "/metrics":
                    self._send(200, owner.metrics.encode())
                elif self.path == "/inflight":
                    self._send(200, b'{"inflight": []}')
                else:
                    self._send(404, b"{}")

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, args=(0.05,), daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def replicas():
    made = []

    def make(*scripts, **kw):
        reps = [_Replica(s, **kw) for s in scripts]
        made.extend(reps)
        return reps

    yield make
    for r in made:
        r.close()


def _dead_url():
    """A loopback URL nothing listens on (connection refused at once)."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), BaseHTTPRequestHandler)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.server_close()
    return url


def _norm(obj):
    """A reply or event with its trace ids replaced by a placeholder."""
    if isinstance(obj, dict):
        return {k: ("<trace>" if k in ("trace_id", "traceparent") and v else _norm(v))
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_norm(v) for v in obj]
    return obj


def _mark_up(router, now=0.0):
    for r in router.replicas:
        r.note_probe_success(True, "healthy", {}, now=now)


class _Events:
    """A recording event sink (obs/events.py surface)."""

    def __init__(self):
        self.rows = []

    def emit(self, event, **kw):
        self.rows.append((event, _norm(kw)))

    def flush(self):
        pass

    def close(self):
        pass


def _frozen(monkeypatch):
    """Freeze the clocks that stamp exposition values (durations read on
    perf_counter, the registry's start time) in both packages; deadlines
    and sleeps keep the real clock."""
    shim = types.SimpleNamespace(monotonic=time.monotonic, sleep=time.sleep,
                                 perf_counter=lambda: 0.0, time=lambda: 1.7e9)
    for mod in (trouter, jrouter, tregistry, jregistry):
        monkeypatch.setattr(mod, "time", shim)


def _expo_norm(text):
    return re.sub(r'jax_version="[^"]*"', 'jax_version="<v>"', text)


def _counters(router):
    """The router's counter and gauge samples (the pick histogram's
    timings left out)."""
    return [ln for ln in router.registry.render().splitlines()
            if ln.startswith("router_") and "pick_seconds" not in ln]


def _both(run, reps=()):
    """``run(pkg)`` for the port, then for JAX with the replicas' hit
    counts reset; returns the two transcripts."""
    out = {}
    for pkg in ("port", "jax"):
        for r in reps:
            r.hits = 0
        out[pkg] = run(pkg)
    return out["port"], out["jax"]


# -- pure functions ---------------------------------------------------------


SCORE_TEXTS = [
    EXPO,
    "serving_queue_depth 3\nserving_slots nan\nserving_slots x\n# c\n\nbad line here\n",
    'serving_kv_utilization{a="b"} 0.5\nserving_slot_occupancy 2 123\n',
    "",
]


@pytest.mark.parametrize("i", range(len(SCORE_TEXTS)))
def test_parse_replica_scores_equals_jax(i):
    got = trouter.parse_replica_scores(SCORE_TEXTS[i])
    want = jrouter.parse_replica_scores(SCORE_TEXTS[i])
    assert repr(got) == repr(want)


BODY_A = (
    "# HELP serving_requests_completed_total done\n"
    "# TYPE serving_requests_completed_total counter\n"
    'serving_requests_completed_total{code="ok"} 5\n'
    "# TYPE serving_ttft_seconds histogram\n"
    'serving_ttft_seconds_bucket{le="0.5"} 3\n'
    'serving_ttft_seconds_bucket{le="+Inf"} 4\n'
    "serving_ttft_seconds_sum 1.25\nserving_ttft_seconds_count 4\n"
    "# TYPE serving_queue_depth gauge\nserving_queue_depth 2\n"
    "# TYPE build_info gauge\n"
    'build_info{role="replica",config_hash="abc",jax_version="9"} 1\n'
    "untyped_thing 7\n"
)
BODY_B = (
    "# TYPE serving_requests_completed_total counter\n"
    'serving_requests_completed_total{code="ok"} 2\n'
    'serving_requests_completed_total{code="err"} 1\n'
    "# TYPE serving_ttft_seconds histogram\n"
    'serving_ttft_seconds_bucket{le="0.5"} 1\n'
    'serving_ttft_seconds_bucket{le="+Inf"} 2\n'
    "serving_ttft_seconds_sum 0.75\nserving_ttft_seconds_count 2\n"
    "# TYPE serving_queue_depth gauge\nserving_queue_depth 0\n"
    'serving_label_escape{path="a\\"b\\\\c\\nd"} 1\n'
    "garbage line with words\n"
)


@pytest.mark.parametrize("own", ["", "# TYPE router_x counter\nrouter_x 3\n"
                                     "# TYPE build_info gauge\n"
                                     'build_info{role="router",config_hash="",jax_version="1"} 1\n'])
def test_aggregate_fleet_metrics_byte_identical(own):
    bodies = {"127.0.0.1:1": BODY_A, "127.0.0.1:2": BODY_B, "127.0.0.1:3": ""}
    got = trouter.aggregate_fleet_metrics(bodies, own=own)
    assert got == jrouter.aggregate_fleet_metrics(bodies, own=own)
    assert 'serving_requests_completed_total{code="ok"} 7' in got
    assert 'serving_queue_depth{replica="127.0.0.1:2"} 0' in got


# -- the state machine and the picker, no HTTP ------------------------------


def test_replica_state_transitions_equal_jax():
    events = [("ok", True, "healthy", {"queue_depth": 2.0, "slots": 4.0}),
              ("fail",), ("fail",), ("ok", False, "draining", {}),
              ("fail",), ("fail",), ("fail",), ("fail",),
              ("ok", False, "restarting", {}), ("ok", True, "healthy", {}),
              ("req",), ("ok", True, "healthy", {"kv_utilization": 0.5}),
              ("ok", True, "healthy", {}), ("fail",), ("req",),
              ("ok", False, "not_ready", {}), ("ok", True, "healthy", {})]

    def run(pkg):
        mod, _, _ = PKGS[pkg]
        rep = mod.Replica("http://127.0.0.1:9/", _cfg(pkg, eject_after=3, readmit_after=2))
        out = [(rep.name, rep.url, rep.snapshot())]
        for t, ev in enumerate(events):
            now = float(t)
            if ev[0] == "ok":
                r = rep.note_probe_success(ev[1], ev[2], ev[3], now=now)
            elif ev[0] == "fail":
                r = rep.note_failure(now)
            else:
                r = rep.note_request_success()
            out.append((r, rep.snapshot(), rep.score(), rep.eligible(),
                        rep.next_probe_t, rep.probe_backoff, rep.consec_ok))
        return out

    got, want = _both(run)
    assert got == want
    states = [row[1]["state"] for row in got[1:]]
    assert {"up", "draining", "ejected"} <= set(states)


def test_pick_sequence_affinity_canary_membership_equal_jax():
    dead = _dead_url()

    def run(pkg):
        mod, _, _ = PKGS[pkg]
        urls = [f"http://127.0.0.1:{19100 + i}" for i in range(4)]
        router = mod.Router(urls, _cfg(pkg, affinity_max_sessions=3),
                            rng=random.Random(0), events=_Events())
        for i, r in enumerate(router.replicas):
            r.note_probe_success(True, "healthy",
                                 {"queue_depth": float(i % 3), "slots": 4.0,
                                  "slot_occupancy": float(i), "kv_utilization": 0.1 * i},
                                 now=0.0)
        name = lambda r: None if r is None else r.name  # noqa: E731
        seq = [name(router.pick()) for _ in range(40)]
        seq += [name(router.pick(exclude=(urls[0], urls[2]))) for _ in range(10)]
        for s in ("a", "b", "c", "d", "a"):
            seq.append(name(router.pick(session_id=s)))
        seq.append(router.repin("b", urls[3]))
        seq.append(router.repin("zz", "http://127.0.0.1:1"))
        seq.append(name(router.pick(session_id="b")))
        router.replicas[3].note_failure(1.0)
        router.replicas[3].note_failure(1.0)
        router.replicas[3].note_failure(1.0)  # ejected: "b" re-pins
        seq.append(name(router.pick(session_id="b")))
        router.set_canary(urls[1], 0.3)
        seq.append(router.canary())
        seq += [name(router.pick()) for _ in range(60)]
        seq.append(name(router.pick(session_id="new")))
        with pytest.raises(ValueError):
            router.set_canary("http://127.0.0.1:2", 0.3)
        with pytest.raises(ValueError):
            router.set_canary(urls[1], 1.5)
        seq.append(router.remove_replica(urls[1]).name)
        seq.append(router.canary())
        seq.append(router.remove_replica("http://127.0.0.1:3"))
        added = router.add_replica(dead)  # its first probe: one strike
        seq.append(added.snapshot())
        with pytest.raises(ValueError):
            router.add_replica(dead)
        seq += [name(router.pick()) for _ in range(20)]
        seq.append(name(router.pick(exclude=tuple(urls))))
        seq.append(router.health())
        with router._aff_lock:
            seq.append({k: v.name for k, v in router._affinity.items()})
        seq.append(_counters(router))
        seq.append(router.events.rows)
        router.close()
        return seq

    got, want = _both(run)
    assert got == want
    assert got[59] == ("http://127.0.0.1:19101", 0.3)
    assert "127.0.0.1:19101" in got[60:120]  # the canary took its share


# -- replies over scripted HTTP replicas ------------------------------------


def _route(pkg, reps, payloads, pin=None, cfg_kw=None, dead_first=False):
    mod, _, _ = PKGS[pkg]
    urls = [r.url for r in reps]
    if dead_first:
        urls = [dead_first] + urls
    router = mod.Router(urls, _cfg(pkg, **(cfg_kw or {})), rng=random.Random(0),
                        events=_Events())
    _mark_up(router)
    if pin is not None:
        for sid, i in pin.items():
            router._affinity[sid] = router.replicas[i]
    out = []
    for p in payloads:
        status, body, headers = router.handle_generate(dict(p))
        out.append((status, _norm(body), headers))
    out.append([r.snapshot() for r in router.replicas])
    out.append(_counters(router))
    out.append(router.events.rows)
    router.close()
    return out


SCENARIOS = {
    # a retriable 503 fails over to the other replica
    "failover": dict(
        scripts=[[(503, {"code": "queue_full"}, {"Retry-After": "0.01"})],
                 [(200, OK, {})]],
        payloads=[{"prompt_ids": [1], "session_id": "s"}], pin={"s": 0}),
    # a transient failover serves elsewhere without re-pinning the session
    "transient_keeps_pin": dict(
        scripts=[[(503, {"code": "queue_full"}, {}), (200, dict(OK, tokens=[7]), {})],
                 [(200, OK, {})]],
        payloads=[{"prompt_ids": [1], "session_id": "s"}] * 2, pin={"s": 0}),
    # non-recoverable codes pass through once, attributed
    "non_retriable": dict(
        scripts=[[(504, {"code": "deadline", "error": "late"}, {})],
                 [(503, {"code": "engine_failed"}, {})]],
        payloads=[{"prompt_ids": [1], "session_id": "s"},
                  {"prompt_ids": [1], "session_id": "t"}], pin={"s": 0, "t": 1}),
    # exhausted failover: the last 503 with the Retry-After capped
    "exhausted_capped": dict(
        scripts=[[(503, {"code": "queue_full"}, {"Retry-After": "30"})]] * 2,
        payloads=[{"prompt_ids": [1]}],
        cfg_kw={"max_attempts": 3, "retry_after_cap_s": 0.2}),
    # a request deadline that a backoff would overrun surfaces the last failure
    "deadline_budget": dict(
        scripts=[[(503, {"code": "shutting_down"}, {"Retry-After": "30"})]] * 2,
        payloads=[{"prompt_ids": [1], "deadline_s": 1.5}],
        cfg_kw={"max_attempts": 4, "retry_base_s": 1.0, "retry_cap_s": 1.0}),
    # a garbage 200 body fails over like a transport death
    "garbage_200": dict(
        scripts=[[(200, b"not json{", {})], [(200, OK, {})]],
        payloads=[{"prompt_ids": [1], "session_id": "s"}], pin={"s": 0}),
    # an unreachable replica fails over and counts a strike
    "unreachable": dict(
        scripts=[[(200, OK, {})]],
        payloads=[{"prompt_ids": [1], "session_id": "s"}], pin={"s": 0},
        dead_first=True),
    # client errors pass through untouched
    "client_error": dict(
        scripts=[[(400, {"code": "bad_request", "error": "no"}, {})]] * 2,
        payloads=[{"prompt_ids": [1]}]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_replies_equal_jax(name, replicas):
    sc = SCENARIOS[name]
    reps = replicas(*sc["scripts"])
    dead = _dead_url() if sc.get("dead_first") else False
    got, want = _both(lambda pkg: _route(pkg, reps, sc["payloads"], sc.get("pin"),
                                         sc.get("cfg_kw"), dead), reps)
    assert got == want
    assert all(isinstance(row, tuple) and "trace_id" in row[1]
               for row in got[:len(sc["payloads"])])


def test_no_eligible_replica_sheds_alike():
    def run(pkg):
        mod, _, _ = PKGS[pkg]
        router = mod.Router(["http://127.0.0.1:19200"],
                            _cfg(pkg, admission_predictive=False, shed_retry_after_s=7.0),
                            rng=random.Random(0))
        out = router.handle_generate({"prompt_ids": [1]})
        router.close()
        return out[0], _norm(out[1]), out[2]

    got, want = _both(run)
    assert got == want
    assert got[0] == 503 and got[1]["code"] == "no_replica" and got[2] == {"Retry-After": "7"}


def test_hedged_request_equal_jax(replicas, monkeypatch):
    """A hung primary hedges to the other replica, and the hedge wins."""
    monkeypatch.setenv(tfaults.ROUTER_HANG_ENV_VAR, "0.5")
    a, b = replicas([(200, dict(OK, tokens=[9]), {})], [(200, OK, {})])

    def run(pkg):
        fmod = PKGS[pkg][2]
        fmod.arm("router_replica_hang@1")
        out = _route(pkg, [a, b], [{"prompt_ids": [1], "session_id": "s"},
                                   {"prompt_ids": [1], "session_id": "s"}],
                     pin={"s": 0}, cfg_kw={"hedge_factor": 1.0, "hedge_min_s": 0.05})
        # the hung primary's own attempt lands before the next package runs
        end = time.monotonic() + 10
        while a.hits < 1 and time.monotonic() < end:
            time.sleep(0.01)
        out.append((a.hits, b.hits))
        fmod.reset()
        return out

    got, want = _both(run, (a, b))
    assert got == want
    assert got[0][0] == 200 and got[0][1]["hedged"] is True
    assert got[0][1]["replica"] == b.url.split("//")[1]
    assert "router_hedge_wins_total 1" in got[3]


def test_fault_plan_counters_equal_jax(replicas, monkeypatch):
    """One plan arms all four router kinds: the probe fault counts a
    strike, stale metrics leave the body unscraped, the pick fault is
    the typed 500 and the hung forward is rescued by its hedge."""
    monkeypatch.setenv(tfaults.ROUTER_HANG_ENV_VAR, "0.4")
    a, b = replicas([(200, dict(OK, tokens=[4]), {})], [(200, OK, {})])

    def run(pkg):
        mod, _, fmod = PKGS[pkg]
        router = mod.Router([a.url, b.url],
                            _cfg(pkg, hedge_factor=1.0, hedge_min_s=0.05),
                            rng=random.Random(0), events=_Events())
        _mark_up(router)
        router._affinity["s"] = router.replicas[0]
        httpd = mod.serve_router(router, port=0)
        threading.Thread(target=httpd.serve_forever, args=(0.05,), daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        fmod.arm("router_probe_fail,router_stale_metrics,router_pick_raise,"
                 "router_replica_hang")
        out = []
        router.probe(router.replicas[0], now=1.0)   # probe fault: a strike
        router.probe(router.replicas[1], now=1.0)   # stale: nothing scraped
        out.append([(r.snapshot(), r.metrics_text) for r in router.replicas])
        for _ in range(2):  # the pick fault, then the hung forward's hedge
            out.append(_http(url + "/generate", {"prompt_ids": [1], "session_id": "s"}))
        router.probe(router.replicas[1], now=2.0)   # the body refreshes again
        out.append([(r.snapshot(), r.metrics_text) for r in router.replicas])
        out.append(fmod.armed())
        end = time.monotonic() + 10
        while a.hits < 1 and time.monotonic() < end:
            time.sleep(0.01)
        out.append(_counters(router))
        out.append(router.events.rows)
        httpd.shutdown()
        httpd.server_close()
        router.close()
        return out

    got, want = _both(run, (a, b))
    assert got == want
    snaps = got[0]
    assert snaps[0][0]["consec_fail"] == 1 and snaps[1][1] == ""
    assert got[1][0] == 500 and got[1][1]["code"] == "internal"
    assert got[2][0] == 200 and got[2][1]["hedged"] is True
    assert got[3][1][1] == EXPO and got[4] is False
    assert "router_hedges_total 1" in got[5]


def _http(url, body=None, raw=None):
    """(status, normalised JSON or text body, selected headers)."""
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            status, payload, headers = r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        status, payload, headers = e.code, e.read(), e.headers
    try:
        payload = _norm(json.loads(payload))
    except ValueError:
        payload = payload.decode()
    return status, payload, {k: headers[k] for k in ("Retry-After", "Content-Type")
                             if k in headers}


def test_http_surface_and_expositions_equal_jax(replicas, monkeypatch):
    """/generate, /health, /ready, /metrics, /fleet/metrics, /drain and
    the 4xx paths through serve_router; the registries byte-identical
    but for build_info's version label."""
    _frozen(monkeypatch)
    a, b = replicas([(200, OK, {})], [(503, {"code": "queue_full"}, {"Retry-After": "9"})])

    def run(pkg):
        mod, _, _ = PKGS[pkg]
        router = mod.Router([a.url, b.url], _cfg(pkg, retry_after_cap_s=0.05),
                            rng=random.Random(0))
        for r in router.replicas:
            router.probe(r, now=5.0)
        httpd = mod.serve_router(router, port=0)
        threading.Thread(target=httpd.serve_forever, args=(0.05,), daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        out = [_http(url + "/generate", {"prompt_ids": [1], "max_new_tokens": 2})
               for _ in range(4)]
        out += [_http(url + p) for p in ("/health", "/ready", "/metrics", "/nope")]
        out.append(_http(url + "/generate", raw=b"{not json"))
        out.append(_http(url + "/generate", raw=b"[1, 2]"))
        out.append(_http(url + "/drain", {}))
        out.append(_http(url + "/elsewhere", {}))
        out.append(router.fleet_metrics(now=6.0))
        for r in router.replicas:
            r.metrics_t = 0.0  # past metrics_max_age_s: excluded
        out.append(router.fleet_metrics(now=60.0))
        out.append(router.registry.render())
        httpd.shutdown()
        httpd.server_close()
        router.close()
        return [_expo_norm(x) if isinstance(x, str) else
                (x[0], _expo_norm(x[1]), x[2]) if isinstance(x[1], str) else x
                for x in out]

    got, want = _both(run, (a, b))
    assert got == want
    assert got[6][0] == 200 and "router_requests_total" in got[6][1]
    assert "fleet_scrape_age_seconds" in got[-3] and "serving_slots{" in got[-3]
    assert "serving_slots{" not in got[-2]


def test_empty_fleet_ready_is_503_alike():
    def run(pkg):
        mod, _, _ = PKGS[pkg]
        router = mod.Router(["http://127.0.0.1:19300"], _cfg(pkg), rng=random.Random(0))
        httpd = mod.serve_router(router, port=0)
        threading.Thread(target=httpd.serve_forever, args=(0.05,), daemon=True).start()
        out = _http(f"http://127.0.0.1:{httpd.server_address[1]}/ready")
        httpd.shutdown()
        httpd.server_close()
        router.close()
        return out

    got, want = _both(run)
    assert got == want and got[0] == 503 and "Retry-After" in got[2]


def test_probe_harvests_inflight_and_readmits_alike(replicas):
    """The prober's view: a probe reaching a replica scrapes its scores
    and /inflight into the journal; failures eject; slow re-admission."""
    (a,) = replicas([(200, OK, {})])
    inflight = {"inflight": [{"journal_id": "j1", "tokens": [5, 6]},
                             {"request_id": 3, "tokens": [1]}]}

    dead = _dead_url()

    def run(pkg):
        mod, _, _ = PKGS[pkg]
        router = mod.Router([a.url, dead], _cfg(pkg, eject_after=2, readmit_after=2),
                            rng=random.Random(0), events=_Events())
        router.journal.begin("j1")
        orig = router._http_get

        def get(url, timeout):
            if url.endswith("/inflight"):
                return 200, json.dumps(inflight).encode()
            return orig(url, timeout)

        router._http_get = get
        out = []
        for t in range(4):
            for r in router.replicas:
                router.probe(r, now=float(t))
            out.append([r.snapshot() for r in router.replicas])
        out.append((router.journal.tokens("j1"), router.journal.stats()))
        out.append(router.health())
        out.append(_counters(router))
        out.append(router.events.rows)
        router.close()
        return out

    got, want = _both(run, (a,))
    assert got == want
    assert got[-4] == ([5, 6], {"bytes": 8, "entries": 1, "finished": 0, "evicted_total": 0})
    assert got[3][1]["state"] == "ejected"


def test_migrate_rung_and_hop_limit_alike(replicas):
    """A ``migrated`` reply is followed to the destination's
    /migrate/await (attribution and the session's pin move there); a
    pointer chain past ``migrate_max_hops`` falls to the retriable
    ladder."""
    (dest,) = replicas([(200, dict(OK, tokens=[5, 6, 7]), {})])
    (src,) = replicas([(200, {"code": "migrated", "dest": dest.url, "migrate_id": "m1"}, {})])
    (loop,) = replicas([(200, {"code": "migrated", "dest": "", "migrate_id": "m2"}, {})])
    loop.script = [(200, {"code": "migrated", "dest": loop.url, "migrate_id": "m2"}, {})]

    def run(pkg):
        out = _route(pkg, [src, dest], [{"prompt_ids": [1], "session_id": "s"}],
                     pin={"s": 0})
        out += _route(pkg, [loop], [{"prompt_ids": [1]}],
                      cfg_kw={"migrate_max_hops": 2, "max_attempts": 1})
        return out

    got, want = _both(run, (src, dest, loop))
    assert got == want
    assert got[0][0] == 200 and got[0][1]["migrated"] is True
    assert got[0][1]["replica"] == dest.url.split("//")[1]
    assert got[4][0] == 503 and got[4][1]["code"] == "migrate_await_failed"
