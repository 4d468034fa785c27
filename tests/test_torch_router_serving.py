"""The port's router in front of port replicas, on the CPU.

Two port servers (``serving/server.py``: ``EngineRunner`` behind
``serve``) on loopback port 0, each with its own engine on the tiny diff
model of tests/torch_tier_common.py (2 layers, width 64, fp32, the
paged pool with pages of 8 and the prefix cache), whose weights are the
JAX package's initialisation carried over by ``params.py``. Each
engine's step is slowed by a constant so a request stays in flight far
longer than a probe interval; every wait has a deadline.

- The replay rung: a replica's engine crashes mid-request (the
  ``serve_raise`` fault, answered 503 ``engine_crash``); the router
  resubmits prompt + journaled tokens on the peer at ``key_offset``, and
  the greedy tokens equal the uninterrupted run's.
- The migrate rung and ``migrate_out``: a request caught mid-decode is
  live-migrated to the peer, and its greedy tokens equal both a run on
  the destination alone and the JAX engine's greedy tokens on the same
  weights; its sticky session follows it.
- Affinity keeps a session on one replica, whose prefix cache then hits.
- The JAX package's ``Router`` (it imports no JAX) in front of the same
  port replicas gives the same replies as the port's router: the wire
  holds both ways.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.request

import pytest

from differential_transformer_replication_tpu.config import RouterConfig as JRouterConfig
from differential_transformer_replication_tpu.serving.router import Router as JRouter
from differential_transformer_replication_tpu_torch.config import RouterConfig
from differential_transformer_replication_tpu_torch.serving import server as tserver
from differential_transformer_replication_tpu_torch.serving.router import Router
from differential_transformer_replication_tpu_torch.utils import faults
from torch_tier_common import jax_engine, port_engine, prompts

STEP_S = 0.05  # each engine step is slowed by this much


@pytest.fixture(autouse=True)
def _disarm():
    faults.reset()
    yield
    faults.reset()


class _Server:
    """One port server on an ephemeral loopback port."""

    def __init__(self, engine):
        step = engine.step

        def slowed():
            time.sleep(STEP_S)
            return step()

        engine.step = slowed
        self.client = tserver.ServingClient(engine)
        self.httpd = tserver.serve(self.client, port=0)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       args=(0.05,), daemon=True)
        self.thread.start()

    @property
    def runner(self):
        return self.client.runner

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.client.close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def pair():
    a, b = _Server(port_engine()), _Server(port_engine())
    yield a, b
    a.close()
    b.close()


def _cfg(cls=RouterConfig, **kw):
    kw.setdefault("probe_interval_s", 0.02)
    kw.setdefault("probe_backoff_s", 0.05)
    kw.setdefault("retry_base_s", 0.001)
    kw.setdefault("retry_cap_s", 0.01)
    kw.setdefault("max_attempts", 4)
    kw.setdefault("wait_for_replica_s", 5.0)
    return cls(**kw)


def _direct(url, payload, timeout=60):
    req = urllib.request.Request(url + "/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _metric(url, name):
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        for line in r.read().decode().splitlines():
            if line.startswith(name + " "):
                return float(line.split()[1])
    return 0.0


class _Call:
    """``router.handle_generate`` on its own thread, joined with a deadline."""

    def __init__(self, router, payload):
        self.result = None
        self.thread = threading.Thread(
            target=lambda: setattr(self, "result", router.handle_generate(dict(payload))),
            daemon=True)
        self.thread.start()

    def join(self, timeout=60):
        self.thread.join(timeout)
        assert not self.thread.is_alive(), "the routed request did not answer in time"
        return self.result


def _wait(cond, what, timeout=30):
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, f"no {what} within {timeout} s"
        time.sleep(0.005)


def _live_decode(router, server):
    """Whether ``server`` shows a request of this router mid-decode (the
    runner's snapshot is the last step's, and stays as it was after a
    crash until the next step, so its entries are matched to the
    router's live journal)."""
    return any(len(e.get("tokens") or []) >= 2
               and router.journal.tokens(e.get("journal_id") or "") is not None
               for e in server.runner.inflight_snapshot())


def _jax_greedy(prompt, n):
    """The JAX engine's greedy tokens on the same weights and pool."""
    eng = jax_engine()
    rid = eng.submit(prompt, max_new_tokens=n, temperature=0.0)
    done = {}
    while eng.has_work():
        for o in eng.step():
            done[o.request_id] = list(o.tokens)
    return done[rid]


def test_replay_rung_resumes_at_key_offset_after_a_crash(pair):
    a, b = pair
    prompt = prompts([8], 70)[0]
    payload = {"prompt_ids": prompt, "max_new_tokens": 22, "temperature": 0.0,
               "session_id": "replay"}
    router = Router([a.url, b.url], _cfg(), rng=random.Random(0)).start()
    try:
        router.repin("replay", a.url)
        call = _Call(router, payload)
        # the probe loop harvested at least 3 emitted tokens from A
        _wait(lambda: router.journal.stats()["bytes"] >= 12, "journal harvest")
        faults.arm(f"serve_raise@{a.runner.engine.stats['iterations'] + 1}")
        status, body, _ = call.join()
        assert status == 200, body
        assert body["replayed"] is True and body["replica"] == b.url.split("//")[1]
        assert body["prompt_ids"] == prompt and len(body["tokens"]) == 22
        ref = _direct(b.url, {k: v for k, v in payload.items() if k != "session_id"})
        assert body["tokens"] == ref["tokens"]
        assert 'router_migrations_total{outcome="replayed"} 1' in router.registry.render()
    finally:
        router.close()
    _wait(lambda: a.runner.accepting(), "restart of A's engine")


def test_migrate_out_moves_a_request_bit_equal_to_destination_and_jax(pair):
    a, b = pair
    prompt = prompts([8], 71)[0]
    payload = {"prompt_ids": prompt, "max_new_tokens": 20, "temperature": 0.0,
               "session_id": "mig"}
    router = Router([a.url, b.url], _cfg(migrate_budget_s=10.0),
                    rng=random.Random(0)).start()
    try:
        router.repin("mig", a.url)
        call = _Call(router, payload)
        _wait(lambda: _live_decode(router, a), "decode on A")
        drained = router.migrate_out(a.url)
        status, body, _ = call.join()
        assert drained["migrated"] == 1 and drained["failed"] == 0, drained
        assert status == 200, body
        assert body["migrated"] is True and body["replica"] == b.url.split("//")[1]
        assert len(body["tokens"]) == 20
        ref = _direct(b.url, {k: v for k, v in payload.items() if k != "session_id"})
        assert body["tokens"] == ref["tokens"]
        assert body["tokens"] == _jax_greedy(prompt, 20)
        with router._aff_lock:
            assert router._affinity["mig"].url == b.url
        reg = router.registry.render()
        assert 'router_migrations_total{outcome="migrated"} 1' in reg
        assert "router_drain_seconds_count 1" in reg
    finally:
        router.close()


def test_affinity_keeps_a_session_on_one_replica_whose_prefix_cache_hits(pair):
    a, b = pair
    shared = prompts([16], 72)[0]
    router = Router([a.url, b.url], _cfg(), rng=random.Random(0)).start()
    try:
        before = {u: _metric(u, "serving_prefix_cache_hits_total") for u in (a.url, b.url)}
        replies = []
        for k in range(3):
            status, body, _ = router.handle_generate({
                "prompt_ids": shared + [k + 1, k + 2], "max_new_tokens": 3,
                "temperature": 0.0, "session_id": "aff"})
            assert status == 200, body
            replies.append(body["replica"])
        assert len(set(replies)) == 1
        pinned = next(u for u in (a.url, b.url) if u.endswith(replies[0]))
        other = b.url if pinned == a.url else a.url
        assert _metric(pinned, "serving_prefix_cache_hits_total") - before[pinned] >= 2
        assert _metric(other, "serving_prefix_cache_hits_total") == before[other]
    finally:
        router.close()


def _strip(body):
    """A reply without the fields that name one run (trace, request id,
    time to first token)."""
    return {k: v for k, v in body.items() if k not in ("trace_id", "request_id", "ttft_ms")}


def test_jax_router_fronts_port_replicas_with_the_port_routers_replies(pair):
    a, b = pair
    bodies = [{"prompt_ids": p, "max_new_tokens": 4, "temperature": 0.0}
              for p in prompts([5, 9, 6, 11], 73)]
    bodies.append({"prompt_ids": prompts([7], 74)[0], "max_new_tokens": 5,
                   "temperature": 0.8, "seed": 3})
    bodies.append({"prompt_ids": prompts([6], 75)[0], "max_new_tokens": 3,
                   "temperature": 0.0, "session_id": "wire"})
    bodies.append({"prompt_ids": [], "max_new_tokens": 3})  # a typed 400
    out = []
    for cls, cfg_cls in ((Router, RouterConfig), (JRouter, JRouterConfig)):
        router = cls([a.url, b.url], _cfg(cfg_cls), rng=random.Random(0))
        for r in router.replicas:
            router.probe(r)
        replies = []
        for p in bodies:
            status, body, headers = router.handle_generate(dict(p))
            replies.append((status, _strip(body), headers))
        out.append(replies)
        router.close()
    assert out[0] == out[1]
    assert [s for s, _, _ in out[0]] == [200] * 6 + [400]
    assert {body["replica"] for _, body, _ in out[0][:6]} <= {a.url[7:], b.url[7:]}
