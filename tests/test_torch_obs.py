"""The port's observability and resilience copies against the JAX
package's, on the CPU: the metrics registry and its exposition, the
sidecar, the span tracer, the step watchdog, the heartbeat files, the
per-layer lambda records, the metric logger and the profiler window.

The registry, span tracer, watchdog and heartbeat are copies (stdlib
only): the same calls give byte-identical exposition, the same Chrome
events (timestamps aside), the same fire at the same deadline, and
heartbeat files that each side reads from the other. The introspection
records are rewritten on torch and held to JAX's on the same params.
"""

from __future__ import annotations

import json
import os
import sys
import urllib.request

import jax
import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu.config import ModelConfig as JModelConfig
from differential_transformer_replication_tpu.models import init_model as jinit
from differential_transformer_replication_tpu.obs import introspect as jintro
from differential_transformer_replication_tpu.obs import registry as jreg
from differential_transformer_replication_tpu.obs import spans as jspans
from differential_transformer_replication_tpu.parallel import heartbeat as jhb
from differential_transformer_replication_tpu.train import watchdog as jwd
from differential_transformer_replication_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
)
from differential_transformer_replication_tpu_torch.obs import introspect as tintro
from differential_transformer_replication_tpu_torch.obs import registry as treg
from differential_transformer_replication_tpu_torch.obs import spans as tspans
from differential_transformer_replication_tpu_torch.obs.http import (
    start_metrics_server,
)
from differential_transformer_replication_tpu_torch.parallel import heartbeat as thb
from differential_transformer_replication_tpu_torch.params import params_from_jax
from differential_transformer_replication_tpu_torch.train import watchdog as twd
from differential_transformer_replication_tpu_torch.train.metrics import (
    MetricLogger,
    device_memory_mb,
)
from differential_transformer_replication_tpu_torch.utils.profiling import (
    ProfilerWindow,
)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def _fill(mod):
    r = mod.Registry()
    mod.set_build_info(r, role="trainer", config_hash="abc123",
                       version="2.13.0", start_time=1234.5)
    c = r.counter("train_iterations_total", "Optimizer steps completed.")
    c.inc()
    c.inc(2)
    a = r.counter("train_anomaly_events_total", "Anomaly-guard interventions.",
                  labelnames=("kind",))
    a.inc(3, kind="skip")
    a.set(1, kind="rollback")
    g = r.gauge("train_data_stall_ratio", "Fraction \"quoted\"\nnewline\\.")
    g.set(0.125)
    m = r.gauge("train_device_memory_peak_mb", "High-water mark.")
    m.set_max(10.0)
    m.set_max(4.0)
    ages = r.gauge("train_heartbeat_age_seconds", "Ages.", labelnames=("peer",))
    ages.set(1.5, peer="1")
    ages.set(float("inf"), peer='we"ird\\')
    h = r.histogram("train_step_seconds", "Step wall.")
    for v in (0.0004, 0.02, 0.3, 7.0, 1e4):
        h.observe(v)
    hl = r.histogram("ckpt_save_seconds", "Saves.", buckets=(0.1, 1.0))
    hl.observe(0.5)
    return r


def test_the_same_calls_render_byte_identical_exposition():
    j, t = _fill(jreg).render(), _fill(treg).render()
    assert t == j
    assert t.encode() == j.encode()
    assert treg.CONTENT_TYPE == jreg.CONTENT_TYPE
    assert treg.LATENCY_BUCKETS_S == jreg.LATENCY_BUCKETS_S


def test_parse_exposition_round_trips_on_both_sides():
    text = _fill(treg).render()
    types_t, samples_t = treg.parse_exposition(text)
    types_j, samples_j = jreg.parse_exposition(text)
    assert types_t == types_j and samples_t == samples_j
    assert types_t["train_step_seconds"] == "histogram"
    assert types_t["train_anomaly_events_total"] == "counter"
    got = {(n, tuple(sorted(lab.items()))): v for n, lab, v in samples_t}
    assert got[("train_iterations_total", ())] == 3.0
    assert got[("train_anomaly_events_total", (("kind", "skip"),))] == 3.0
    assert got[("train_anomaly_events_total", (("kind", "rollback"),))] == 1.0
    assert got[("train_device_memory_peak_mb", ())] == 10.0
    assert got[("train_heartbeat_age_seconds", (("peer", 'we"ird\\'),))] == \
        float("inf")
    assert got[("train_step_seconds_count", ())] == 5.0
    assert got[("build_info", (("config_hash", "abc123"), ("jax_version", "2.13.0"),
                               ("role", "trainer")))] == 1.0


def test_build_info_defaults_to_the_torch_version():
    r = treg.Registry()
    treg.set_build_info(r, role="trainer")
    _, samples = treg.parse_exposition(r.render())
    (labels,) = [lab for n, lab, _ in samples if n == "build_info"]
    assert labels["jax_version"].split("+")[0] == torch.__version__.split("+")[0]


def test_sidecar_serves_the_registry():
    r = _fill(treg)
    server = start_metrics_server(r, 0, host="127.0.0.1")
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(url + "/metrics", timeout=10) as resp:
            assert resp.headers["Content-Type"] == treg.CONTENT_TYPE
            assert resp.read().decode() == r.render()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(url + "/nope", timeout=10)
    finally:
        server.shutdown()
        server.server_close()


# ---------------------------------------------------------------------------
# the span tracer
# ---------------------------------------------------------------------------


def _spans(mod, path):
    tr = mod.SpanTracer(str(path), process_name="trainer", flush_every=3)
    with tr.span("data_wait", iter=0):
        pass
    with tr.span("dispatch", iter=0):
        with tr.span("block", what="anomaly_streak"):
            pass
    tr.instant("rollback", to=6)
    tr.counter("queue", depth=3)
    tr.complete("request", 1.0, 1.5, trace_id="t1", span_id="s1")
    with tr.span("eval", iter=6):
        pass
    tr.close()
    tr.close()  # idempotent
    mod.NOOP_TRACER.span("x", a=1).__enter__()
    mod.NOOP_TRACER.close()
    events = json.load(open(path))
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid", "tid")}
            for e in events]


def test_the_same_spans_write_the_same_chrome_events(tmp_path):
    j = _spans(jspans, tmp_path / "j.json")
    t = _spans(tspans, tmp_path / "t.json")
    assert t == j
    assert [e["name"] for e in t if e["ph"] == "X"] == \
        ["data_wait", "block", "dispatch", "request", "eval"]


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------


def _drive_watchdog(mod, path):
    now = [100.0]
    exits, rows = [], []

    class Fires:
        n = 0

        def inc(self):
            Fires.n += 1

    wd = mod.StepWatchdog(5.0, report_path=str(path), sink=rows.append,
                          fires_counter=Fires(), context={"rank": lambda: 0},
                          clock=lambda: now[0], exit_fn=exits.append)
    wd.close()  # the monitor thread; the test drives check() itself
    fired_at = None
    wd.arm(7)
    for t in np.arange(100.0, 110.0, 0.5):
        now[0] = float(t)
        wd.check()
        if exits and fired_at is None:
            fired_at = now[0]
    report = json.load(open(path))
    return fired_at, exits, rows, Fires.n, report


def test_the_watchdog_fires_at_the_same_deadline_with_the_same_report(tmp_path):
    assert twd.HANG_EXIT_CODE == jwd.HANG_EXIT_CODE == 113
    j = _drive_watchdog(jwd, tmp_path / "j.json")
    t = _drive_watchdog(twd, tmp_path / "t.json")
    assert t[0] == j[0] == 105.5  # the first check past arm + 5 s
    assert t[1] == j[1] == [113]  # once
    assert t[3] == j[3] == 1
    assert sorted(t[2][0]) == sorted(j[2][0])
    assert "threads" not in t[2][0]
    assert sorted(t[4]) == sorted(j[4])
    assert t[4]["iter"] == 7 and t[4]["rank"] == 0
    assert t[4]["reason"] == j[4]["reason"]
    assert "MainThread" in t[4]["threads"]


def test_a_trip_fires_disarmed_and_a_disarm_prevents_the_deadline(tmp_path):
    for mod in (jwd, twd):
        now, exits = [0.0], []
        wd = mod.StepWatchdog(1.0, report_path=None, clock=lambda: now[0],
                              exit_fn=exits.append)
        wd.close()
        wd.arm(3)
        wd.disarm()
        now[0] = 10.0
        wd.check()
        assert exits == []
        wd.trip("peer 1 silent")
        assert exits == [113] and wd.fired


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------


def test_each_side_reads_the_others_heartbeat_files(tmp_path):
    d = str(tmp_path / "hb")
    tj, tt = jhb.FileHeartbeatTransport(d), thb.FileHeartbeatTransport(d)
    tj.publish({"process_index": 0, "iter": 5, "seq": 1, "ts": 1.0})
    tt.publish({"process_index": 1, "iter": 6, "seq": 2, "ts": 2.0})
    assert tj.read() == tt.read() == {
        0: {"process_index": 0, "iter": 5, "seq": 1, "ts": 1.0},
        1: {"process_index": 1, "iter": 6, "seq": 2, "ts": 2.0}}
    assert sorted(os.listdir(d)) == ["hb-0.json", "hb-1.json"]


@pytest.mark.parametrize("mod", [jhb, thb], ids=["jax", "port"])
def test_a_silent_peer_is_declared_dead_once(mod):
    now, dead = [0.0], []
    tr = mod.MemoryTransport()
    hb = mod.Heartbeat(tr, process_index=0, num_processes=2, interval_s=1.0,
                       timeout_s=3.0, iter_supplier=lambda: 4,
                       on_dead=lambda p, age: dead.append((p, age)),
                       clock=lambda: now[0], start=False)
    hb.publish_once()
    assert tr.read()[0]["iter"] == 4
    tr.publish({"process_index": 1, "iter": 0, "seq": 1, "ts": 0.0})
    now[0] = 1.0
    assert hb.check_peers() == {1: 0.0}
    now[0] = 3.5
    hb.check_peers()
    assert dead == []
    now[0] = 4.5
    hb.check_peers()
    hb.check_peers()
    assert dead == [(1, 3.5)]
    with pytest.raises(ValueError, match="must exceed"):
        mod.Heartbeat(tr, 0, 2, 1.0, 1.0, lambda: 0, start=False)


def test_heartbeat_silence_mutes_the_port_publisher(tmp_path):
    from differential_transformer_replication_tpu_torch.utils import faults

    faults.reset()
    try:
        faults.arm("heartbeat_silence@1")
        tr = thb.MemoryTransport()
        for idx in (0, 1):
            thb.Heartbeat(tr, idx, 2, 1.0, 3.0, lambda: 0,
                          start=False).publish_once()
        assert sorted(tr.read()) == [0]
    finally:
        faults.reset()


# ---------------------------------------------------------------------------
# the introspection records
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=64, n_embd=32, n_head=2, n_layer=3, block_size=16,
            dropout=0.0, compute_dtype="float32")


@pytest.mark.parametrize("kind", ["control", "diff", "ndiff"])
def test_lambda_records_match_jax_on_the_same_params(kind):
    jcfg = JModelConfig(model=kind, **TINY)
    jparams = jinit(jax.random.PRNGKey(3), jcfg)
    # lambdas away from zero, so each layer and term has its own value
    rng = np.random.default_rng(5)
    for blk in jparams["blocks"]:
        for name in ("lambda_q", "lambda_k"):
            if name in blk["attn"]:
                shape = blk["attn"][name].shape
                blk["attn"][name] = jax.numpy.asarray(
                    rng.standard_normal(shape).astype(np.float32) * 0.5)
    tcfg = ModelConfig(model=kind, **TINY)
    tparams = params_from_jax(jax.device_get(jparams), tcfg)
    grads = [0.5, 0.25, 0.125, 0.0625, 2.0]
    jrec = jintro.lambda_record(
        jax.device_get(jintro.make_param_summary(jcfg)(jparams)), jcfg,
        grad_norms=np.asarray(grads, np.float32))
    trec = tintro.lambda_record(tintro.make_param_summary(tcfg)(tparams), tcfg,
                                grad_norms=grads)
    assert sorted(trec) == sorted(jrec)
    for k in jrec:
        tol = 1e-4 if k.startswith("param_norm") else 1e-6  # 4 decimals
        assert abs(trec[k] - jrec[k]) <= tol, (k, trec[k], jrec[k])
    lam = [k for k in trec if k.startswith("lambda_l")]
    if kind == "control":
        assert lam == []
    elif kind == "diff":
        assert lam == [f"lambda_l{i}" for i in (1, 2, 3)]
    else:
        assert lam == [f"lambda_l{i}_t{j}" for i in (1, 2, 3)
                       for j in range(tcfg.n_terms)]
    # the unrounded lambdas too, within fp32 rounding
    if kind != "control":
        ja = np.asarray(jintro.make_param_summary(jcfg)(jparams)["lambdas"])
        ta = tintro.make_param_summary(tcfg)(tparams)["lambdas"].numpy()
        np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the metric logger and the profiler window
# ---------------------------------------------------------------------------


def test_logger_omits_memory_on_the_cpu_and_survives_a_missing_wandb(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import fails
    cfg = TrainConfig(model=ModelConfig(**TINY), sampler="replacement",
                      metrics_path=str(tmp_path / "m.jsonl"), use_wandb=True)
    log = MetricLogger(cfg, "cpu")
    assert "wandb unavailable" in capsys.readouterr().out
    assert device_memory_mb("cpu") is None
    log.log_step(2, 1.5, 1e-3, None, {"skipped_steps": 0})
    log.log_record({"record": "introspection", "iter": 2, "lambda_l1": 0.2})
    log.finish()
    log.finish()
    rows = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    assert rows[0]["record"] == "run_header"
    assert "gpu_memory" not in rows[1] and rows[1]["skipped_steps"] == 0
    assert rows[2]["record"] == "introspection" and "ts" in rows[2]
    quiet = MetricLogger(cfg.replace(use_wandb=False,
                                     metrics_path=str(tmp_path / "q.jsonl")),
                         "cpu", primary=False)
    quiet.log_step(1, 1.0, 1e-3)
    quiet.finish()
    assert not os.path.exists(tmp_path / "q.jsonl")


def _work():
    a = torch.randn(64, 64)
    return (a @ a).sum()


def test_profiler_window_captures_its_steps(tmp_path):
    win = ProfilerWindow(str(tmp_path / "p"), start=3, n_steps=2)
    for it in range(1, 8):
        with torch.profiler.record_function(f"iter_{it}"):
            _work()
        win.step(it)
    win.close()
    assert win.path == str(tmp_path / "p" / "trace_3-5.json")
    names = {e.get("name") for e in json.load(open(win.path))["traceEvents"]}
    # iterations 4 and 5 ran inside [3, 5); the others did not
    assert {"iter_4", "iter_5"} <= names
    assert not names & {"iter_1", "iter_2", "iter_3", "iter_6", "iter_7"}
    assert "aten::mm" in names


def test_profiler_window_past_its_start_or_off_never_stops_unstarted(tmp_path):
    # a resume past the start: no capture, and close() does nothing
    win = ProfilerWindow(str(tmp_path / "p"), start=3)
    for it in range(11, 14):
        win.step(it)
    win.close()
    assert not win.active and win.path is None
    assert not os.path.exists(tmp_path / "p")
    off = ProfilerWindow(None, start=0)
    off.step(0)
    off.close()
    # a loop that ends inside the window is finalized by close()
    win = ProfilerWindow(str(tmp_path / "q"), start=1, n_steps=10)
    for it in range(1, 4):
        _work()
        win.step(it)
    assert win.active
    win.close()
    assert not win.active and os.path.exists(win.path)
