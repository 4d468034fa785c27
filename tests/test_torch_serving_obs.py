"""The port's serving telemetry against the JAX package's, on the CPU.

- the engine's counters after the same greedy requests equal the JAX
  engine's, key by key (``stats`` is a ``StatsMap`` over JAX's
  ``_STAT_SPEC``), on the contiguous pool and on the paged pool with
  n-gram speculation;
- every metric family the JAX engine registers is registered by the port
  with the same type, help and label names, except the one named list
  of unported families (``serving/engine.py:UNPORTED_FAMILIES``);
- a server round trip: ``GET /metrics`` parses and carries the SLO
  gauges and the request counts, the span trace holds the five step
  spans and the request's lifecycle stamped with its ``traceparent``'s
  trace id, and the event log holds its received and finished lines;
- the server's command line takes JAX's telemetry, SLO and priority flags
  with JAX's defaults, starts its engine with ``--quantize-weights int8``
  and with ``--spec-drafter-ckpt``, and refuses each later flag naming
  its ROADMAP item.
"""

from __future__ import annotations

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu.config import ModelConfig as JModelConfig
from differential_transformer_replication_tpu.config import ServingConfig as JServingConfig
from differential_transformer_replication_tpu.models import init_model as j_init_model
from differential_transformer_replication_tpu.serving.engine import (
    ServingEngine as JServingEngine,
)
from differential_transformer_replication_tpu_torch.config import (
    ModelConfig,
    ServingConfig,
)
from differential_transformer_replication_tpu_torch.obs.events import EventLog
from differential_transformer_replication_tpu_torch.obs.registry import (
    parse_exposition,
)
from differential_transformer_replication_tpu_torch.obs.slo import (
    SLOMonitor,
    default_serving_objectives,
)
from differential_transformer_replication_tpu_torch.obs.spans import SpanTracer
from differential_transformer_replication_tpu_torch.params import params_from_jax
from differential_transformer_replication_tpu_torch.serving import server as tserver
from differential_transformer_replication_tpu_torch.serving.engine import (
    UNPORTED_FAMILIES,
    ServingEngine,
)

SMALL = dict(vocab_size=61, n_embd=32, n_head=2, n_layer=2, block_size=32,
             dropout=0.0, n_terms=3, compute_dtype="float32")
POOL = dict(num_slots=2, prefill_chunk=4, prefill_budget=6)
PAGED_SPEC = dict(kv_page_size=8, spec_mode="ngram", spec_draft_len=3)
TID = "4bf92f3577b34da6a3ce929d0e0e4736"
SID = "00f067aa0ba902b7"


@pytest.fixture(scope="module")
def diff():
    jcfg = JModelConfig(model="diff", **SMALL)
    tree = jax.tree_util.tree_map(np.asarray,
                                  j_init_model(jax.random.PRNGKey(0), jcfg))
    tcfg = ModelConfig(model="diff", **SMALL)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), \
        params_from_jax(tree, tcfg)


def _prompts():
    return [[5, 9, 2] * 4, [7, 1] * 5 + [3], [11, 4, 4, 6] * 3, [8, 3, 2]]


def _families(registry, unported=()):
    out = {}
    for m in registry.metrics():
        if m.name in unported or m.name.startswith("device_"):
            continue
        out[m.name] = (type(m).__name__, m.help, tuple(m.labelnames))
    return out


@pytest.mark.parametrize("extra", [dict(quality_telemetry=True),
                                   dict(PAGED_SPEC, quality_telemetry=True),
                                   dict(spec_mode="model", spec_draft_len=3,
                                        quality_telemetry=True)],
                         ids=["contiguous", "paged-spec", "model-spec"])
def test_counters_and_families_equal_the_jax_engines(diff, extra):
    """The model-spec case (the target drafting for itself) adds the
    drafter's ``serving_spec_drafter_kv_bytes``, equal to JAX's."""
    jcfg, tcfg, jparams, tparams = diff
    model = extra.get("spec_mode") == "model"
    jeng = JServingEngine(jparams, jcfg, JServingConfig(**POOL, **extra),
                          spec_drafter=(jparams, jcfg) if model else None)
    teng = ServingEngine(tparams, tcfg, ServingConfig(**POOL, **extra),
                         device="cpu",
                         spec_drafter=(tparams, tcfg) if model else None)
    jouts = jeng.generate(_prompts(), max_new_tokens=6, temperature=0.0)
    touts = teng.generate(_prompts(), max_new_tokens=6, temperature=0.0)
    assert [o.tokens for o in touts] == [o.tokens for o in jouts]
    assert teng.stats.snapshot() == dict(jeng.stats)
    assert list(teng.stats) == list(jeng.stats)
    jfam = _families(jeng.registry, UNPORTED_FAMILIES)
    tfam = _families(teng.registry)
    assert tfam == jfam
    assert not set(UNPORTED_FAMILIES) & set(tfam)
    # the same exposition values for every counter family both register
    jvals = {(n, tuple(sorted(lab.items()))): v
             for n, lab, v in parse_exposition(jeng.registry.render())[1]}
    tvals = {(n, tuple(sorted(lab.items()))): v
             for n, lab, v in parse_exposition(teng.registry.render())[1]}
    for name, (kind, _, _) in tfam.items():
        if kind != "Counter":
            continue
        for key, v in tvals.items():
            if key[0] == name:
                assert jvals[key] == v, key
    assert tvals[("serving_ttft_seconds_count", ())] == len(_prompts())
    assert tvals[("serving_token_entropy_count", ())] == 6 * len(_prompts())
    assert tvals[("serving_kv_cache_bytes_per_slot", ())] > 0
    for name in ("serving_constraint_cache_entries",
                 "serving_constrained_requests_active",
                 "serving_constraint_validity_rate"):
        assert tvals[(name, ())] == jvals[(name, ())]
    if model:
        key = ("serving_spec_drafter_kv_bytes", ())
        assert tvals[key] == jvals[key] == teng.drafter.bytes_total() > 0


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read().decode(), r.headers


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_server_round_trip_metrics_trace_and_events(diff, tmp_path):
    _, tcfg, _, tparams = diff
    tracer = SpanTracer(str(tmp_path / "t.json"), process_name="serving-engine")
    events = EventLog(str(tmp_path / "e.jsonl"), process="replica")
    engine = ServingEngine(tparams, tcfg, ServingConfig(**POOL, quality_telemetry=True),
                           device="cpu", tracer=tracer)
    client = tserver.ServingClient(engine)
    slo = SLOMonitor(engine.registry, *default_serving_objectives())
    httpd = tserver.serve(client, port=0, events=events, slo=slo)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        code, traced = _post(url + "/generate", {
            "prompt_ids": [5, 9, 2, 7], "max_new_tokens": 4, "temperature": 0.0,
            "traceparent": f"00-{TID}-{SID}-01"})
        assert code == 200 and traced["trace_id"] == TID
        assert traced["quality"]["tokens_observed"] == 4
        code, fresh = _post(url + "/generate", {"prompt_ids": [3, 3],
                                                "max_new_tokens": 2})
        assert code == 200 and len(fresh["trace_id"]) == 32
        code, bad = _post(url + "/generate", {"prompt_ids": [3], "spec": 2})
        assert code == 400 and bad["code"] == "bad_request" and bad["trace_id"]
        code, body, headers = _get(url + "/metrics")
        assert code == 200 and headers["Content-Type"].startswith("text/plain")
        types, samples = parse_exposition(body)
        vals = {(n, tuple(sorted(lab.items()))): v for n, lab, v in samples}
        assert vals[("serving_ttft_seconds_count", ())] == 2
        assert vals[("serving_requests_completed_total", ())] == 2
        # the 400 was refused by the handler, before the engine
        assert vals[("serving_requests_rejected_total", ())] == 0
        assert vals[("serving_decode_tokens_total", ())] == \
            client.stats["decode_tokens"]
        assert vals[("serving_token_entropy_count", ())] == 6
        assert types["serving_ttft_seconds"] == "histogram"
        assert ("slo_burn_rate", (("objective", "ttft"),)) in vals
        assert ("slo_target", (("objective", "availability"),)) in vals
        assert sum(1 for n, _ in vals if n == "serving_lambda_mean") == \
            tcfg.n_layer
    finally:
        httpd.shutdown()
        httpd.server_close()
        client.close()
        th.join(timeout=30)
        tracer.close()
        events.close()
    trace = json.load(open(tmp_path / "t.json"))
    names = {e["name"] for e in trace}
    assert {"schedule", "prefill", "decode", "sample", "emit"} <= names
    mine = [e for e in trace if e.get("args", {}).get("trace_id") == TID]
    assert {e["name"] for e in mine} == {"admit", "first_token", "finish",
                                         "request"}
    assert next(e for e in mine if e["name"] == "request")["args"]["parent_id"] == SID
    assert any(TID in (e["args"].get("trace_ids") or [])
               for e in trace if e["name"] == "decode")
    lines = [json.loads(x) for x in open(tmp_path / "e.jsonl")]
    by = {}
    for rec in lines:
        by.setdefault(rec["event"], []).append(rec)
    assert len(by["request_received"]) == 2 and len(by["request_finished"]) == 2
    assert [r["trace_id"] for r in by["request_received"]][0] == TID
    assert by["request_finished"][0]["trace_id"] == TID
    assert by["request_failed"][0]["code"] == "bad_request"
    assert all(r["process"] == "replica" for r in lines)


CLI_FLAGS = [
    ("--priority-aging", "3.5", "priority_aging_s", 3.5),
    ("--priority-max-slots", "batch:1", "priority_max_slots", "batch:1"),
    ("--quality-telemetry", None, "quality_telemetry", True),
    ("--quality-fingerprint", "fp.json", "quality_fingerprint", "fp.json"),
    ("--quality-record", "out.json", "quality_telemetry", True),
]


@pytest.mark.parametrize("flag,value,field,want", CLI_FLAGS,
                         ids=[f[0] for f in CLI_FLAGS])
def test_server_flags_set_jax_serving_config_values(flag, value, field, want):
    p = tserver.build_parser()
    defaults = tserver.serving_config_from_args(p.parse_args([]))
    jdef = JServingConfig()
    for name in ("priority_aging_s", "priority_max_slots", "quality_telemetry",
                 "quality_fingerprint", "num_slots", "prefill_chunk",
                 "prefill_budget", "max_restarts", "drain_timeout_s"):
        assert getattr(defaults, name) == getattr(jdef, name), name
    args = p.parse_args([flag] + ([value] if value is not None else []))
    cfg = tserver.serving_config_from_args(args)
    assert getattr(cfg, field) == want == getattr(JServingConfig(**{field: want}), field)


def test_telemetry_flags_and_decode_attention_impl_parse():
    p = tserver.build_parser()
    args = p.parse_args([
        "--trace-path", "t.json", "--event-log", "e.jsonl",
        "--event-log-max-bytes", "4096", "--event-log-keep", "2",
        "--slo-ttft", "0.5", "--slo-itl", "0.1", "--slo-target", "0.95",
        "--slo-availability-target", "0.99", "--decode-attention-impl", "pallas"])
    assert (args.trace_path, args.event_log, args.event_log_max_bytes,
            args.event_log_keep) == ("t.json", "e.jsonl", 4096, 2)
    assert (args.slo_ttft, args.slo_itl, args.slo_target,
            args.slo_availability_target) == (0.5, 0.1, 0.95, 0.99)
    assert ModelConfig(**SMALL).replace(
        decode_attention_impl=args.decode_attention_impl).decode_attention_impl == "pallas"
    d = p.parse_args([])
    assert (d.slo_ttft, d.slo_itl, d.slo_target, d.slo_availability_target,
            d.event_log_max_bytes, d.event_log_keep, d.decode_attention_impl) == \
        (1.0, 0.25, 0.99, 0.999, 0, 3, "")
    with pytest.raises(SystemExit):
        p.parse_args(["--decode-attention-impl", "cuda"])


@pytest.mark.parametrize("flag", sorted(tserver.LATER_FLAGS))
def test_later_server_flags_are_refused_naming_their_item(flag, capsys):
    with pytest.raises(SystemExit) as e:
        tserver.main([flag, "1", "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and tserver.LATER_FLAGS[flag] in err
    assert "ROADMAP Queue A: " in tserver.LATER_FLAGS[flag]
    assert tserver.refused_flags([f"{flag}=1"]) == [flag]


def test_quantize_weights_flag_starts_the_engine_with_int8_weights():
    """``--quantize-weights int8`` (no longer refused): the parser takes
    it, and the engine it starts serves the random-init demo model with
    every matmul weight quantized and dequantized, as
    ``apply_weight_quantization`` does, and decodes greedily."""
    from differential_transformer_replication_tpu_torch.train.checkpoint import (
        apply_weight_quantization,
    )

    assert tserver.refused_flags(["--quantize-weights=int8"]) == []
    p = tserver.build_parser()
    args = p.parse_args(["--device", "cpu", "--quantize-weights", "int8"])
    engine, cfg, meta, tok = tserver.engine_from_args(args)
    plain, _, _, _ = tserver.engine_from_args(p.parse_args(["--device", "cpu"]))
    assert meta is None and tok is None and args.quantize_weights == "int8"
    w, w0 = engine.params["lm_head"]["w"], plain.params["lm_head"]["w"]
    want = apply_weight_quantization({"lm_head": {"w": w0}}, "int8")
    assert torch.equal(w, want["lm_head"]["w"]) and not torch.equal(w, w0)
    assert torch.equal(engine.params["tok_emb"], plain.params["tok_emb"])
    out = engine.generate([[5, 9, 2]], max_new_tokens=4, temperature=0.0)[0]
    assert len(out.tokens) == 4
    with pytest.raises(SystemExit):
        p.parse_args(["--quantize-weights", "int4"])


def test_spec_drafter_ckpt_flag_starts_a_model_drafter(tmp_path):
    """``--spec-mode model --spec-drafter-ckpt DIR`` (no longer refused):
    the engine drafts with the checkpoint's model, loaded through the
    target's verified path (int8 with ``--quantize-weights``), and its
    greedy tokens equal the engine's without speculation."""
    from differential_transformer_replication_tpu_torch.config import TrainConfig
    from differential_transformer_replication_tpu_torch.train import checkpoint as ckpt
    from differential_transformer_replication_tpu_torch.train.step import (
        create_train_state,
    )

    dcfg = TrainConfig(model=ModelConfig(
        model="control", vocab_size=512, n_embd=32, n_head=2, n_layer=1,
        block_size=128, compute_dtype="float32"), vocab_size=512)
    path = str(tmp_path / "drafter.ckpt")
    ckpt.save_checkpoint(path, create_train_state(
        torch.Generator().manual_seed(4), dcfg, "cpu"), 1.0, dcfg)
    assert tserver.refused_flags([f"--spec-drafter-ckpt={path}"]) == []
    p = tserver.build_parser()
    argv = ["--device", "cpu", "--spec-mode", "model", "--spec-drafter-ckpt", path,
            "--spec-draft-len", "3", "--quantize-weights", "int8"]
    engine, _, _, _ = tserver.engine_from_args(p.parse_args(argv))
    assert engine.serving.spec_drafter_ckpt == path
    assert engine.drafter.kind == "model" and engine.drafter.cfg.n_layer == 1
    want, _, _ = ckpt.load_params_for_inference(path, quantize="int8")
    assert torch.equal(engine.drafter.params["lm_head"]["w"], want["lm_head"]["w"])
    plain, _, _, _ = tserver.engine_from_args(
        p.parse_args(["--device", "cpu", "--quantize-weights", "int8"]))
    prompts = [[5, 9, 2, 5, 9, 2], [7, 7, 1]]
    got = [o.tokens for o in engine.generate(prompts, max_new_tokens=8,
                                             temperature=0.0)]
    assert got == [o.tokens for o in plain.generate(prompts, max_new_tokens=8,
                                                    temperature=0.0)]
    assert engine.spec_stats()["proposed"] > 0
