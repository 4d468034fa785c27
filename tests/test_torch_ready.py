"""``GET /ready`` of the port's server against the JAX server's, on the
CPU: the same code, body and ``Retry-After`` in each runner state
(healthy, degraded, restarting, draining, failed). Each side's real
``EngineRunner.status``/``accepting`` and HTTP handler run over a stub
runner in that state (no engine, no thread), behind its own ``serve``
on a free localhost port."""

from __future__ import annotations

import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from differential_transformer_replication_tpu.serving import server as jserver
from differential_transformer_replication_tpu_torch.serving import server as tserver

STATES = ("healthy", "degraded", "restarting", "draining", "failed")


def _stub_client(mod, state: str):
    """A ``ServingClient`` of ``mod`` whose runner is in ``state``."""
    runner = object.__new__(mod.EngineRunner)
    runner._cond = threading.Condition()
    runner._failed = state == "failed"
    runner._draining = state == "draining"
    runner._stop = False
    runner._restarting = state == "restarting"
    runner._degraded = state == "degraded"
    runner._step_budget = 0.0
    runner._step_started = None
    runner.engine = types.SimpleNamespace(serving=types.SimpleNamespace(
        drain_timeout_s=7.9, restart_backoff_s=2.5))
    client = object.__new__(mod.ServingClient)
    client.runner = runner
    return client


def _get_ready(mod, state: str) -> tuple:
    httpd = mod.serve(_stub_client(mod, state), port=0)
    t = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05},
                         daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/ready"
    try:
        try:
            with urllib.request.urlopen(url, timeout=30) as r:
                return r.status, json.load(r), r.headers.get("Retry-After")
        except urllib.error.HTTPError as e:
            return e.code, json.load(e), e.headers.get("Retry-After")
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(30)


@pytest.mark.parametrize("state", STATES)
def test_ready_answers_as_the_jax_server_does(state):
    assert tserver.EngineRunner.status(_stub_client(tserver, state).runner) == state
    want = _get_ready(jserver, state)
    got = _get_ready(tserver, state)
    assert got == want
    accepting = state in ("healthy", "degraded")
    assert got[0] == (200 if accepting else 503)
    assert got[1] == {"ready": accepting, "status": state}
    assert got[2] == (None if accepting else ("7" if state == "draining" else "2"))


def test_an_overrunning_step_stays_ready_and_a_drain_does_not():
    """A step past its time budget is 'degraded' and still ready, as in
    JAX; the same runner draining is not."""
    for mod in (jserver, tserver):
        client = _stub_client(mod, "healthy")
        client.runner._step_budget = 0.01
        client.runner._step_started = time.perf_counter() - 1.0
        assert client.runner.status() == "degraded" and client.runner.accepting()
        client.runner._stop = True
        assert client.runner.status() == "draining" and not client.runner.accepting()
