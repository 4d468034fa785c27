"""Live migration over HTTP between two port servers on loopback, the
host tier's telemetry, and the server's command line, on the CPU.

Servers A and B each own a port engine (the tiny diff model, the paged
pool with the host tier). A long ``/generate`` on A is polled on
``A/inflight`` until it shows tokens, then ``POST A/migrate/export`` moves
it to B: the blocked call answers ``{"code": "migrated"}`` and
``POST B/migrate/await`` returns tokens equal, bit for bit, to the same
request served by B alone (greedy and sampled). Every wait has a
deadline and every server thread is joined with a timeout; no fixed
sleep orders events (the engines' steps are slowed by a constant so a
request stays in flight for a window far longer than a migration).

Also: dedup against a warmed B; ``migrate_corrupt`` (B answers the typed
409, A finishes the request itself); the typed failures (contiguous
pool, request not active, geometry mismatch, dedup miss, corrupt and
malformed bodies, an unknown migrate id) with the JAX server's status
codes and ``code``s; ``/metrics`` families and ``/health``'s
``host_tier`` keys against the JAX engine's; ``--host-tier-bytes``,
``key_offset`` and ``journal_id`` accepted, and the request-path fields
served (no key is refused as a later slice's; ``"spec"`` meets the
unknown-field 400).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from differential_transformer_replication_tpu.utils import faults as jfaults
from differential_transformer_replication_tpu_torch.serving import server as tserver
from differential_transformer_replication_tpu_torch.serving.engine import (
    UNPORTED_FAMILIES,
)
from differential_transformer_replication_tpu_torch.serving.migrate import to_wire
from differential_transformer_replication_tpu_torch.utils import faults
from torch_tier_common import jax_engine, port_engine, prompts

STEP_S = 0.05  # each engine step is slowed by this much
PROMPT = prompts([12], 50)[0]


@pytest.fixture(autouse=True)
def _disarm():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


class _Server:
    """One port server on an ephemeral loopback port."""

    def __init__(self, engine, step_s=STEP_S):
        if step_s:
            step = engine.step

            def slowed():
                time.sleep(step_s)
                return step()

            engine.step = slowed
        self.engine = engine
        self.client = tserver.ServingClient(engine)
        self.httpd = tserver.serve(self.client, port=0)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

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


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read().decode()


class _Call:
    """A POST on its own thread, joined with a deadline."""

    def __init__(self, url, body):
        self.result = None
        self.thread = threading.Thread(
            target=lambda: setattr(self, "result", _post(url, body)),
            daemon=True)
        self.thread.start()

    def join(self, timeout=60):
        self.thread.join(timeout)
        assert not self.thread.is_alive(), "call did not answer in time"
        return self.result


def _wait_inflight(url, journal_id, n=2, timeout=30):
    """Poll ``/inflight`` until the request with ``journal_id`` shows n
    tokens; returns its entry."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        for ent in json.loads(_get(url + "/inflight")[1])["inflight"]:
            if ent.get("journal_id") == journal_id and len(ent["tokens"]) >= n:
                return ent
        time.sleep(0.005)
    raise AssertionError(f"{journal_id} showed no {n} tokens on {url}")


def _migrate_over_http(a, b, body, journal_id, mid):
    call = _Call(a.url + "/generate", dict(body, journal_id=journal_id))
    ent = _wait_inflight(a.url, journal_id)
    assert ent["prompt_len"] == len(body["prompt_ids"])
    status, reply = _post(a.url + "/migrate/export", {
        "request_id": ent["request_id"], "dest": b.url + "/",
        "migrate_id": mid, "budget_s": 20})
    return call, status, reply


@pytest.mark.parametrize("temp", [0.0, 0.9], ids=["greedy", "sampled"])
def test_a_request_migrates_bit_exact_over_http(pair, temp):
    a, b = pair
    body = {"prompt_ids": PROMPT, "max_new_tokens": 20, "temperature": temp,
            "seed": 11}
    call, status, reply = _migrate_over_http(a, b, body, f"j-{temp}", f"m-{temp}")
    assert status == 200 and reply["outcome"] == "migrated", reply
    assert reply["dest"] == b.url and reply["bytes"] > 0
    status, moved = call.join()
    assert status == 200
    assert moved["code"] == "migrated" and moved["migrate_id"] == f"m-{temp}"
    status, out = _post(b.url + "/migrate/await", {"migrate_id": f"m-{temp}"})
    assert status == 200 and out["finish_reason"] == "length"
    status, alone = _post(b.url + "/generate", body)
    assert status == 200 and out["tokens"] == alone["tokens"]
    assert len(out["tokens"]) == 20


def test_dedup_against_a_warmed_peer_ships_fewer_pages(pair):
    a, b = pair
    prompt = prompts([17], 51)[0]  # two full pages of 8
    body = {"prompt_ids": prompt, "max_new_tokens": 14, "temperature": 0.0}
    assert _post(b.url + "/generate", body)[0] == 200  # warm B's radix tree
    status, probe = _post(b.url + "/migrate/probe", {"prompt_ids": prompt})
    assert status == 200 and probe["cached_pages"] == 2
    deduped0 = a.engine.stats["migrate_pages_deduped"]
    call, status, reply = _migrate_over_http(a, b, body, "j-dedup", "m-dedup")
    assert status == 200 and reply["dedup_pages"] == 2
    assert call.join()[1]["code"] == "migrated"
    status, out = _post(b.url + "/migrate/await", {"migrate_id": "m-dedup"})
    assert status == 200
    assert out["tokens"] == _post(b.url + "/generate", body)[1]["tokens"]
    assert a.engine.stats["migrate_pages_deduped"] - deduped0 == 2


def test_a_corrupt_transfer_is_refused_and_the_source_finishes(pair):
    a, b = pair
    body = {"prompt_ids": PROMPT, "max_new_tokens": 20, "temperature": 0.0}
    imports0, failed0 = b.engine.stats["migrate_imports"], a.engine.stats["migrate_failed"]
    faults.arm("migrate_corrupt")
    call, status, reply = _migrate_over_http(a, b, body, "j-bad", "m-bad")
    assert status == 409 and reply["code"] == "migrate_transfer", reply
    assert "409" in reply["error"] and "migrate_corrupt" in reply["error"]
    status, out = call.join()
    assert status == 200 and out["finish_reason"] == "length"
    assert out["tokens"] == _post(a.url + "/generate", body)[1]["tokens"]
    assert b.engine.stats["migrate_imports"] == imports0
    assert a.engine.stats["migrate_failed"] == failed0 + 1
    assert _post(b.url + "/migrate/await", {"migrate_id": "m-bad"})[0] == 404


def test_typed_failures_answer_as_the_jax_server(pair):
    a, b = pair
    status, reply = _post(a.url + "/migrate/export",
                          {"request_id": 987654, "dest": b.url, "migrate_id": "x"})
    # unknown here: nothing to move, the request already answered
    assert (status, reply) == (200, {"outcome": "finished"})
    assert _post(a.url + "/migrate/export", {"dest": b.url})[1]["code"] == "bad_request"
    assert _post(b.url + "/migrate/import", {"migrate_id": "x"})[1]["code"] == "bad_request"
    status, reply = _post(b.url + "/migrate/import", {"migrate_id": "x",
                                                      "state": "!!!"})
    assert (status, reply["code"]) == (409, "migrate_corrupt")
    status, reply = _post(b.url + "/migrate/await", {"migrate_id": "nope"})
    assert (status, reply["code"]) == (404, "unknown_migrate_id")
    # a blob of another geometry, and one whose dedup the peer cannot resolve
    src = port_engine(kv_page_size=4, kv_pool_pages=24)
    rid = src.submit(PROMPT, max_new_tokens=8, temperature=0.0)
    while not src._slot_for(rid) or not src._slot_for(rid).generated:
        src.step()
    status, reply = _post(b.url + "/migrate/import", {
        "migrate_id": "g", "state": to_wire(src.export_slot_state(rid))})
    assert (status, reply["code"]) == (409, "migrate_geometry")
    src = port_engine()
    rid = src.submit(prompts([12], 52)[0], max_new_tokens=8, temperature=0.0)
    while not src._slot_for(rid) or not src._slot_for(rid).generated:
        src.step()
    status, reply = _post(b.url + "/migrate/import", {
        "migrate_id": "d", "state": to_wire(src.export_slot_state(rid, 1))})
    assert (status, reply["code"]) == (409, "migrate_dedup_miss")
    # a request in flight on a contiguous pool: nothing page-shaped
    contiguous = _Server(port_engine(kv_page_size=0, host_tier_bytes=0))
    try:
        status, reply = _post(contiguous.url + "/migrate/probe",
                              {"prompt_ids": PROMPT})
        assert (status, reply) == (200, {"cached_pages": 0})
        call = _Call(contiguous.url + "/generate", {
            "prompt_ids": PROMPT, "max_new_tokens": 20, "temperature": 0.0,
            "journal_id": "c"})
        ent = _wait_inflight(contiguous.url, "c")
        status, reply = _post(contiguous.url + "/migrate/export", {
            "request_id": ent["request_id"], "dest": b.url, "migrate_id": "c"})
        assert (status, reply["code"]) == (409, "migrate_unsupported")
        assert "paged" in reply["error"]
        assert call.join()[0] == 200
    finally:
        contiguous.close()
    with pytest.raises(Exception) as ei:
        a.engine.export_slot_state(987654)
    assert ei.value.code == "migrate_not_active"


def test_health_and_metrics_carry_the_host_tier_as_jax_does(pair):
    a, _ = pair
    health = json.loads(_get(a.url + "/health")[1])
    jeng = jax_engine()
    assert set(health["host_tier"]) == set(jeng.tier_stats())
    assert health["host_tier"]["budget_bytes"] == 1 << 30
    _, text = _get(a.url + "/metrics")
    for name in ("serving_host_tier_prefix_hits_total",
                 "serving_host_tier_budget_bytes", "serving_host_tier_bytes",
                 "serving_host_tier_entries", "serving_host_tier_stashes",
                 "serving_host_tier_hits_total",
                 "serving_host_tier_misses_total",
                 "serving_host_tier_evictions_total",
                 "serving_host_tier_corrupt_total",
                 "serving_migrate_exports_total",
                 "serving_preemptions_total"):
        assert f"# TYPE {name} " in text, name
    # the families, help texts and labels equal the JAX engine's, less
    # the unported ones (which list no host-tier family any more)
    fam = lambda reg, skip=(): {  # noqa: E731
        m.name: (type(m).__name__, m.help, tuple(m.labelnames))
        for m in reg.metrics()
        if m.name not in skip and not m.name.startswith("device_")}
    assert fam(port_engine().registry) == fam(jeng.registry, UNPORTED_FAMILIES)
    assert not [f for f in UNPORTED_FAMILIES if "host_tier" in f]


def test_host_tier_flag_key_offset_and_journal_id_are_served(pair):
    a, _ = pair
    args = tserver.build_parser().parse_args(
        ["--host-tier-bytes", "4096", "--kv-page-size", "8"])
    assert tserver.refused_flags(["--host-tier-bytes=4096"]) == []
    sv = tserver.serving_config_from_args(args)
    assert sv.host_tier_bytes == 4096 and sv.tiered()
    assert "--host-tier-bytes" not in tserver.LATER_FLAGS
    assert {"key_offset", "journal_id"} <= set(tserver.GENERATE_KEYS)
    assert not {"key_offset", "journal_id"} & set(tserver.LATER_SLICE_KEYS)
    body = {"prompt_ids": PROMPT, "max_new_tokens": 6, "temperature": 0.0}
    full = _post(a.url + "/generate", body)[1]["tokens"]
    status, tail = _post(a.url + "/generate", dict(
        body, prompt_ids=PROMPT + full[:2], max_new_tokens=4, key_offset=2,
        journal_id="replay"))
    assert status == 200 and tail["tokens"] == full[2:]


# the request fields the request-path slice serves, each with a valid
# value; "spec" was never a /generate field of the JAX server
SERVED_KEYS = {"json_schema": {"type": "integer"}, "regex": "[a-z]+",
               "choices": ["12", "ab"], "repetition_penalty": 1.2,
               "presence_penalty": 0.5, "frequency_penalty": 0.5,
               "logprobs": 2, "spec": None}


@pytest.mark.parametrize("key", list(SERVED_KEYS))
def test_later_slice_keys_stay_refused(pair, key):
    """No field is refused as "a later slice's" any more
    (``LATER_SLICE_KEYS`` is empty): the request-path fields answer 200
    for a valid value, and "spec" meets the unknown-field 400."""
    a, _ = pair
    assert tserver.LATER_SLICE_KEYS == ()
    # the id -> text table constrained requests compile against
    a.engine._vocab = tuple(chr(48 + i % 75) for i in range(61))
    body = {"prompt_ids": [1, 2], "max_new_tokens": 3, key: SERVED_KEYS[key]}
    status, reply = _post(a.url + "/generate", body)
    if key == "spec":
        assert status == 400 and reply["code"] == "bad_request"
        assert reply["error"] == "unknown field 'spec'"
        return
    assert status == 200 and len(reply["tokens"]) >= 1, reply
    assert ("token_logprobs" in reply) == (key == "logprobs")
