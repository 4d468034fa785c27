"""The port's fleet supervisor (serving/fleet.py), on the CPU.

The quick test launches one tiny replica of the port's server
(``--device cpu``, the 2-layer demo model) as a subprocess, SIGKILLs it,
and sees the supervisor log the exit, back off, relaunch it and the
relaunched process turn ready. The supervisor's restart arithmetic
(``backoff_s``, ``classify_exit``) equals the repo's
``tools/train_supervisor.py``'s, from which it is copied.

The ``slow`` tests are the port's twins of the JAX package's fleet
gates, marked ``slow`` as the JAX originals are: the rolling restart
and crash under load with zero client failures
(tests/test_router.py's chaos test), gate A (a SIGKILL mid-decode,
every request finished by the replay rung, bit-equal greedy tokens) and
gate B (a drain by live migration within its budget, bit-equal tokens),
tests/test_migrate.py's. The JAX gates also pin each replica's XLA
compile count; the port compiles nothing per shape, and its twins check
instead that every replica ran on the device it was asked for.
"""

from __future__ import annotations

import importlib.util
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from differential_transformer_replication_tpu_torch.config import RouterConfig
from differential_transformer_replication_tpu_torch.serving import fleet as tfleet
from differential_transformer_replication_tpu_torch.serving.retry import (
    http_post_json_with_retries,
)
from differential_transformer_replication_tpu_torch.serving.router import (
    Router,
    serve_router,
)

REPO = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--num-slots", "2", "--prefill-chunk", "16",
        "--prefill-budget", "32", "--drain-timeout", "60", "--max-queue-len", "0"]


def _supervisor_tool():
    spec = importlib.util.spec_from_file_location(
        "train_supervisor", str(REPO / "tools" / "train_supervisor.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_restart_arithmetic_equals_the_supervisor_tool():
    tool = _supervisor_tool()
    assert tfleet.HANG_EXIT_CODE == tool.HANG_EXIT_CODE
    for rc in (0, 1, 2, 113, -9, -15, -11, 137, 143, 139, 128, 160, 255, -6):
        assert tfleet.classify_exit(rc) == tool.classify_exit(rc), rc
    for restart in range(8):
        for base, cap in ((0.5, 10.0), (2.0, 60.0), (0.1, 0.3)):
            assert (tfleet.backoff_s(restart, base, cap)
                    == tool.backoff_s(restart, base, cap))


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


def test_supervisor_relaunches_a_killed_replica(tmp_path):
    log = tmp_path / "fleet.jsonl"
    fleet = tfleet.Fleet(1, server_args=TINY, max_restarts=2, backoff_base=0.1,
                         backoff_max=0.5, ready_timeout_s=120.0, fleet_log=str(log))
    try:
        fleet.start()
        url = fleet.urls[0]
        assert _get(url + "/health")["device"] == "cpu"
        pid = fleet.replicas[0].proc.pid
        fleet.kill(0)
        end = time.monotonic() + 60
        while time.monotonic() < end and not (
                fleet.replicas[0].alive() and fleet.replicas[0].proc.pid != pid):
            time.sleep(0.05)
        assert fleet.replicas[0].proc.pid != pid, "the supervisor never relaunched"
        assert fleet.replicas[0].restarts == 1
        assert fleet.wait_ready(0, timeout_s=120)
        status, body, _ = http_post_json_with_retries(
            url + "/generate", {"prompt_ids": [1, 2, 3], "max_new_tokens": 2,
                                "temperature": 0.0}, timeout=60, max_retries=2)
        assert status == 200 and len(body["tokens"]) == 2
    finally:
        fleet.stop()
    rows = [json.loads(x) for x in log.read_text().splitlines()]
    events = [(r["event"], r.get("outcome")) for r in rows]
    assert events[:4] == [("launch", None), ("exit", "sigkill"), ("backoff", None),
                          ("launch", None)], events
    assert events[-1] == ("stopped", None)
    assert not fleet.replicas[0].alive()


# -- the scale surface (twins of JAX's TestFleetScaling) -----------------------
# No replica launches here: each fleet's ports are OS-assigned (port 0),
# and launches are recorded or stubbed.


def test_scale_down_drains_least_loaded_and_releases_lease():
    fleet = tfleet.Fleet(3)
    urls = fleet.urls
    scores = {urls[0]: 2.0, urls[1]: 0.5, urls[2]: 1.0}
    fleet._relaunch_at[1] = 999.0  # pretend a relaunch is pending
    # least-loaded by the router's score, and its supervision lease
    # (pending relaunch) is RELEASED with the slot
    assert fleet.scale_down(score_of=scores.get) == urls[1]
    assert [r.index for r in fleet.replicas] == [0, 2]
    assert 1 not in fleet._relaunch_at
    # a replica the scorer hides (the canary) is never the victim
    assert fleet.scale_down(score_of=lambda u: None if u == urls[0] else 5.0) == urls[2]
    with pytest.raises(ValueError):
        fleet.scale_down()  # never below one replica
    # no scores at all: fall back to the highest index
    fleet = tfleet.Fleet(2)
    last = fleet.urls[-1]
    assert fleet.scale_down() == last
    assert [r.index for r in fleet.replicas] == [0]


def test_scale_down_explicit_index():
    fleet = tfleet.Fleet(2)
    first = fleet.urls[0]
    assert fleet.scale_down(index=0) == first
    assert [r.index for r in fleet.replicas] == [1]
    fleet = tfleet.Fleet(2)
    with pytest.raises(ValueError):
        fleet.scale_down(index=99)


def test_scale_up_mints_fresh_slots():
    fleet = tfleet.Fleet(2, server_args=["--event-log", "ev-{replica}.jsonl"])
    launched = []
    fleet._launch = launched.append
    urls = fleet.scale_up(2, wait_ready=False)
    assert len(urls) == 2 and len(fleet.replicas) == 4
    assert [r.index for r in launched] == [2, 3]
    assert urls == [r.url for r in launched]
    r2 = launched[0]
    assert r2.restarts == 0 and not r2.gave_up  # fresh budget
    assert "ev-2.jsonl" in r2.argv  # per-replica templating holds
    assert r2.argv[1:3] == ["-m", tfleet.SERVER_MODULE]
    # indices are never reused: a scar on slot 3 cannot haunt a future
    # scale-up
    fleet.scale_down(index=3)
    assert fleet.scale_up(1, wait_ready=False)
    assert fleet.replicas[-1].index == 4
    with pytest.raises(ValueError):
        fleet.scale_up(0)


def test_relaunch_replica_overrides_and_restores():
    fleet = tfleet.Fleet(1, server_args=["--model", "base"])
    restarted = []
    fleet._restart_one = lambda r, ready_check=None: restarted.append(r.index)
    old = fleet.relaunch_replica(
        0, server_args=["--model", "canary"],
        extra_env={"DTX_FAULTS": "canary_regress"})
    r = fleet.replicas[0]
    assert "canary" in r.argv and "base" not in r.argv
    assert r.env["DTX_FAULTS"] == "canary_regress"
    assert "base" in old[0] and old[1] is None
    # rollback: pass back exactly what relaunch returned
    fleet.relaunch_replica(0, argv=old[0], env=old[1])
    assert r.argv == old[0] and r.env is None
    assert restarted == [0, 0]
    with pytest.raises(ValueError):
        fleet.relaunch_replica(99)


# -- the fleet gates (slow tier, as the JAX originals) -------------------------


def _post(url, payload, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")
    except OSError as e:
        return -1, {"error": repr(e)}


class _Front:
    """A started fleet with the port's router in front over HTTP."""

    def __init__(self, server_args, **cfg_kw):
        self.fleet = tfleet.Fleet(2, server_args=server_args, max_restarts=3,
                                  backoff_base=0.2, backoff_max=2.0,
                                  ready_timeout_s=180.0)
        self.router = self.httpd = None
        self.fleet.start()
        for u in self.fleet.urls:  # warm each replica directly
            for n in (1, 2, 4, 8, 16):
                status, body, _ = http_post_json_with_retries(
                    u + "/generate", {"prompt_ids": [1] * n, "max_new_tokens": 2,
                                      "temperature": 0.0, "seed": 0},
                    timeout=120, max_retries=2)
                assert status == 200, (u, n, body)
        cfg = dict(probe_interval_s=0.05, probe_backoff_s=0.05,
                   probe_backoff_max_s=0.5, eject_after=2, readmit_after=2,
                   max_attempts=4, retry_base_s=0.02, retry_cap_s=0.2,
                   default_deadline_s=120.0, wait_for_replica_s=5.0)
        cfg.update(cfg_kw)
        self.router = Router(self.fleet.urls, RouterConfig(**cfg)).start()
        self.httpd = serve_router(self.router, port=0)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/generate"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def load(self, n_workers, make_payload, timeout):
        """Client threads posting ``make_payload(worker, k)`` until
        ``stop`` is set; returns (results, stop event, workers)."""
        results, lock, stop = [], threading.Lock(), threading.Event()

        def client(wid):
            k = 0
            while not stop.is_set():
                k += 1
                payload = make_payload(wid, k)
                status, body = _post(self.url, payload, timeout=timeout)
                with lock:
                    results.append((payload, status, body))

        workers = [threading.Thread(target=client, args=(w,)) for w in range(n_workers)]
        for w in workers:
            w.start()
        return results, stop, workers

    def close(self):
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
        if self.router is not None:
            self.router.close()
        self.fleet.stop()


def _join(stop, workers, timeout):
    stop.set()
    for w in workers:
        w.join(timeout=timeout)
        assert not w.is_alive(), "client hung"


def _serve_on(results, n, timeout=120.0):
    """Keep the load running, healed, for a second and until ``n``
    requests have answered."""
    time.sleep(1.0)
    end = time.monotonic() + timeout
    while len(results) < n and time.monotonic() < end:
        time.sleep(0.1)


def _devices(urls):
    return {_get(u + "/health")["device"] for u in urls}


@pytest.mark.slow
def test_chaos_rolling_restart_and_crash_zero_client_failures():
    """Sustained load through the router over 2 port replicas survives
    a rolling restart (migrating pre-drain) and a SIGKILL of one replica
    with zero failed client requests and no client-side retries."""
    front = _Front(TINY)
    try:
        names = {rep.name for rep in front.router.replicas}
        results, stop, workers = front.load(4, lambda wid, k: {
            "prompt_ids": [1 + (wid + k) % 7] * (1 + (k % 12)),
            "max_new_tokens": 4, "temperature": 0.0 if k % 2 else 0.7,
            "seed": wid * 1000 + k, "timeout": 60, "session_id": f"w{wid}"}, 90)
        try:
            by_url = {rep.url: rep for rep in front.router.replicas}
            time.sleep(1.0)
            front.fleet.rolling_restart(ready_check=lambda r: by_url[r.url].eligible(),
                                        pre_drain=front.router.migrate_out)
            assert results, "no load flowed during the restart"
            front.fleet.kill(0)
            end = time.time() + 120
            while time.time() < end and front.fleet.replicas[0].restarts < 1:
                time.sleep(0.05)
            assert front.fleet.wait_ready(0, timeout_s=180)
            _serve_on(results, 20)
        finally:
            _join(stop, workers, 120)
        bad = [(s, b) for _, s, b in results if s != 200]
        assert not bad, f"{len(bad)} failed requests, first: {bad[:3]}"
        assert len(results) >= 20
        assert all(b.get("replica") in names for _, _, b in results)
        assert front.fleet.replicas[0].restarts >= 1
        assert _devices(front.fleet.urls) == {"cpu"}
        assert "router_requests_total" in front.router.registry.render()
    finally:
        front.close()


@pytest.mark.slow
def test_chaos_gate_a_sigkill_mid_decode_zero_loss_replay():
    """Gate A: a SIGKILL mid-decode loses no request; every replayed
    reply's greedy tokens equal the same request run undisturbed."""
    front = _Front(TINY, probe_interval_s=0.02)
    try:
        results, stop, workers = front.load(4, lambda wid, k: {
            "prompt_ids": [1 + (wid + k) % 7] * (1 + (k % 12)),
            "max_new_tokens": 100, "temperature": 0.0, "seed": 0, "timeout": 60}, 90)
        try:
            victim = None
            end = time.time() + 60
            while time.time() < end and victim is None:
                if front.router.journal.stats()["bytes"] == 0:
                    time.sleep(0.005)
                    continue
                for i, u in enumerate(front.fleet.urls):
                    try:
                        ents = _get(u + "/inflight", 5).get("inflight", [])
                    except OSError:
                        continue
                    # a request the router has journaled, with decode left
                    # (the port's tiny model decodes 100 tokens in a blink)
                    if any(front.router.journal.tokens(e.get("journal_id") or "")
                           and len(e.get("tokens") or []) < 60 for e in ents):
                        victim = i
                        break
            assert victim is not None, "no journaled in-flight decode"
            front.fleet.kill(victim)
            end = time.time() + 120
            while time.time() < end and front.fleet.replicas[victim].restarts < 1:
                time.sleep(0.05)
            assert front.fleet.wait_ready(victim, timeout_s=180)
            _serve_on(results, 20)
        finally:
            _join(stop, workers, 120)
        bad = [(s, b) for _, s, b in results if s != 200]
        assert not bad, f"{len(bad)} failed requests, first: {bad[:3]}"
        assert len(results) >= 20
        replayed = [(p, b) for p, s, b in results if b.get("replayed")]
        assert replayed, "the SIGKILL never caught a journaled request"
        survivor = front.fleet.urls[1 - victim]
        for payload, body in replayed[:5]:
            ref_p = {k: v for k, v in payload.items() if k != "timeout"}
            status, ref, _ = http_post_json_with_retries(
                survivor + "/generate", ref_p, timeout=120, max_retries=2)
            assert status == 200 and body["tokens"] == ref["tokens"], payload
    finally:
        front.close()


@pytest.mark.slow
def test_chaos_gate_b_drain_by_migration_bounded_and_bit_exact():
    """Gate B: draining a replica whose requests have far more decode
    left than the drain budget ends within it by migration; migrated
    continuations equal the same requests run on the source alone."""
    front = _Front(TINY + ["--kv-page-size", "8", "--kv-pool-pages", "64"],
                   eject_after=3, default_deadline_s=300.0, migrate_budget_s=20.0)
    try:
        results, stop, workers = front.load(3, lambda wid, k: {
            "prompt_ids": [2 + (wid + k) % 5] * 8, "max_new_tokens": 100,
            "temperature": 0.0, "seed": 0, "timeout": 240}, 300)
        drained = src = None
        try:
            end = time.time() + 120
            while time.time() < end:
                src = None
                for u in front.fleet.urls:
                    try:
                        ents = _get(u + "/inflight", 5).get("inflight", [])
                    except OSError:
                        continue
                    if any(len(e.get("tokens") or []) >= 2 for e in ents):
                        src = u
                        break
                if src is None:
                    time.sleep(0.01)
                    continue
                drained = front.router.migrate_out(src)
                if drained["migrated"] >= 1:
                    break
            assert drained is not None, "no in-flight decode observed"
            assert drained["migrated"] >= 1, drained
            assert drained["drain_seconds"] < 20.0, drained
        finally:
            _join(stop, workers, 300)
        bad = [(s, b) for _, s, b in results if s != 200]
        assert not bad, f"failed requests: {bad[:3]}"
        migrated = [(p, b) for p, s, b in results if b.get("migrated")]
        assert migrated, "the drain migrated nothing visible to clients"
        for payload, body in migrated[:5]:
            assert len(body["tokens"]) == 100
            ref_p = {k: v for k, v in payload.items() if k != "timeout"}
            status, ref, _ = http_post_json_with_retries(
                src + "/generate", ref_p, timeout=240, max_retries=2)
            assert status == 200 and body["tokens"] == ref["tokens"], payload
        assert _devices(front.fleet.urls) == {"cpu"}
    finally:
        front.close()


def test_fleet_cli_flags_equal_the_tool():
    """``main``'s flags are the repo's tools/fleet.py's."""
    import re

    def flags(path):
        return sorted(set(re.findall(r'add_argument\("(--[a-z-]+)"',
                                     Path(path).read_text())))

    assert flags(tfleet.__file__) == flags(REPO / "tools" / "fleet.py")
