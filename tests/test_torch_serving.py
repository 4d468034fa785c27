"""The port's serving engine and front-ends, on the CPU.

The port's ``ServingEngine(device="cpu")`` is held against the JAX
package's ``ServingEngine`` on the same params: mixed-length prompts
through a 2-slot pool (requests queue, slots are reused) give the same
greedy tokens. Greedy equality is only meaningful away from near-ties,
so the test also checks, through the JAX full forward, that no step's
top-2 logit margin falls below 1e-4 for the chosen seed. Sampled output
cannot match ``jax.random``; it is tested for per-request determinism.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu.config import ModelConfig as JModelConfig
from differential_transformer_replication_tpu.config import ServingConfig as JServingConfig
from differential_transformer_replication_tpu.models import init_model as j_init_model
from differential_transformer_replication_tpu.models import model_forward as j_model_forward
from differential_transformer_replication_tpu.serving.engine import (
    ServingEngine as JServingEngine,
)
from differential_transformer_replication_tpu_torch.config import (
    ModelConfig,
    ServingConfig,
)
from differential_transformer_replication_tpu_torch.params import params_from_jax
from differential_transformer_replication_tpu_torch.serving.engine import (
    ServingEngine,
    draw_seed,
)
from differential_transformer_replication_tpu_torch.serving.scheduler import FREE
from differential_transformer_replication_tpu_torch.serving.server import (
    ServingClient,
    serve,
)

SMALL = dict(vocab_size=61, n_embd=32, n_head=2, n_layer=2, block_size=32,
             dropout=0.0, n_terms=3, compute_dtype="float32")
NEAR_TIE = 1e-4


def _setup(kind: str):
    jcfg = JModelConfig(model=kind, **SMALL)
    tree = jax.tree_util.tree_map(
        np.asarray, j_init_model(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(5)
    for blk in tree["blocks"]:
        for key in ("lambda_q", "lambda_k"):
            if key in blk["attn"]:
                blk["attn"][key] = (rng.standard_normal(blk["attn"][key].shape)
                                    * 0.1).astype(np.float32)
    tcfg = ModelConfig(model=kind, **SMALL)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), \
        params_from_jax(tree, tcfg)


def _prompts(lens, vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in lens]


def _engine(tparams, tcfg, **kw):
    serving = dict(num_slots=2, prefill_chunk=4, prefill_budget=6)
    serving.update(kw)
    return ServingEngine(tparams, tcfg, ServingConfig(**serving), device="cpu")


@pytest.mark.parametrize("kind", ["control", "diff", "ndiff"])
def test_greedy_tokens_match_jax_engine(kind):
    jcfg, tcfg, jparams, tparams = _setup(kind)
    prompts = _prompts([3, 9, 14, 6, 11], SMALL["vocab_size"])
    n_new = 8
    jeng = JServingEngine(jparams, jcfg, JServingConfig(
        num_slots=2, prefill_chunk=4, prefill_budget=6))
    jouts = jeng.generate(prompts, max_new_tokens=n_new, temperature=0.0)
    teng = _engine(tparams, tcfg)
    touts = teng.generate(prompts, max_new_tokens=n_new, temperature=0.0)
    for p, jo, to in zip(prompts, jouts, touts):
        # the seed is chosen so that no greedy step is a near-tie: the
        # JAX logits that produced each token have a top-2 margin >= 1e-4
        seq = jnp.asarray(p + jo.tokens[:-1], jnp.int32)[None]
        logits, _ = j_model_forward(jparams, seq, jcfg)
        steps = np.asarray(logits[0, len(p) - 1:], np.float32)
        top2 = np.sort(steps, axis=-1)[:, -2:]
        assert float(np.min(top2[:, 1] - top2[:, 0])) >= NEAR_TIE
        assert to.tokens == jo.tokens
        assert to.prompt == p and to.finish_reason == "length"
    assert teng.stats["completed"] == 5
    assert teng.scheduler.max_concurrent <= 2
    assert all(s.state == FREE for s in teng.scheduler.slots)


def test_sampled_output_is_a_function_of_the_request():
    """Seeded sampling must not see slot assignment, pool size or
    admission order: the t-th token's generator is seeded by
    draw_seed(seed, t) only."""
    _, tcfg, _, tparams = _setup("control")
    reqs = list(zip(_prompts([4, 9, 6], SMALL["vocab_size"], seed=3), [7, 7, 99]))

    def run(num_slots, order):
        eng = _engine(tparams, tcfg, num_slots=num_slots, prefill_budget=4)
        ids = {}
        for i in order:
            p, seed = reqs[i]
            ids[eng.submit(p, temperature=1.0, top_k=5, seed=seed,
                           max_new_tokens=6)] = i
        return {ids[o.request_id]: o.tokens for o in eng.run()}

    a = run(1, [0, 1, 2])
    b = run(3, [2, 0, 1])
    assert a == b
    assert all(len(t) == 6 for t in a.values())
    assert all(0 <= tok < SMALL["vocab_size"] for t in a.values() for tok in t)
    assert draw_seed(7, 0) != draw_seed(7, 1) != draw_seed(8, 0)


def test_cancel_reclaims_slot_mid_decode():
    _, tcfg, _, tparams = _setup("control")
    eng = _engine(tparams, tcfg, num_slots=1, prefill_chunk=8, prefill_budget=8)
    a = eng.submit(_prompts([5], SMALL["vocab_size"], seed=9)[0],
                   max_new_tokens=24, temperature=0.0)
    b = eng.submit(_prompts([4], SMALL["vocab_size"], seed=10)[0],
                   max_new_tokens=4, temperature=0.0)
    for _ in range(3):  # a holds the only slot and is decoding
        eng.step()
    assert eng.scheduler.slots[0].request.request_id == a
    assert eng.cancel(a) is True
    assert eng.scheduler.slots[0].state == FREE
    outs = eng.run()  # b admits into the freed slot and completes
    assert [o.request_id for o in outs] == [b]
    assert len(outs[0].tokens) == 4
    assert eng.stats["cancelled"] == 1
    assert eng.cancel(b) is False
    # the interrupted slot leaves no residue (ring-mask invariant)
    p = _prompts([6], SMALL["vocab_size"], seed=11)[0]
    reused = eng.generate([p], max_new_tokens=6, temperature=0.0)[0]
    fresh = _engine(tparams, tcfg).generate([p], max_new_tokens=6,
                                            temperature=0.0)[0]
    assert reused.tokens == fresh.tokens


def test_submit_validation_and_later_slice_fields():
    _, tcfg, _, tparams = _setup("diff")
    eng = _engine(tparams, tcfg)
    with pytest.raises(ValueError, match="cannot roll"):
        eng.submit([1] * 30, max_new_tokens=3)  # diff: prompt + new <= 32
    with pytest.raises(ValueError, match=r"\[0, 61\)"):
        eng.submit([61], max_new_tokens=2)
    for field, value in (("repetition_penalty", 1.3), ("logprobs", 2),
                         ("regex", "a+"), ("frequency_penalty", 0.5)):
        with pytest.raises(ValueError, match=field):
            eng.submit([1, 2], max_new_tokens=2, **{field: value})
    assert eng.stats["rejected"] == 6
    assert not eng.has_work()


def test_engine_defaults_to_cuda_and_refuses_to_fall_back(monkeypatch):
    _, tcfg, _, tparams = _setup("control")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(tparams, tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(tparams, tcfg, device="cuda")


def test_server_main_refuses_cuda_without_a_card():
    """``main()`` defaults to ``--device cuda`` and fails loudly when no
    card is visible, instead of serving from the CPU."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run(
        [sys.executable, "-m",
         "differential_transformer_replication_tpu_torch.serving.server",
         "--port", "0"],
        cwd=str(Path(__file__).resolve().parents[1]), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def test_http_generate_and_health_round_trip():
    _, tcfg, _, tparams = _setup("diff")
    prompts = _prompts([5, 9, 3], SMALL["vocab_size"], seed=8)
    refs = [o.tokens for o in _engine(tparams, tcfg).generate(
        prompts, max_new_tokens=6, temperature=0.0)]
    client = ServingClient(_engine(tparams, tcfg))
    httpd = serve(client, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        outs = client.generate_batch(prompts, max_new_tokens=6,
                                     temperature=0.0, timeout=120)
        assert [o.tokens for o in outs] == refs
        tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        body = _post(url + "/generate", {
            "prompt_ids": prompts[0], "max_new_tokens": 6,
            "temperature": 0.0, "traceparent": tp,
        })
        assert body["tokens"] == refs[0]
        assert body["prompt_ids"] == prompts[0]
        assert body["finish_reason"] == "length"
        assert body["ttft_ms"] >= 0 and body["trace_id"] == "ab" * 16
        assert set(body) == {"request_id", "prompt_ids", "tokens",
                             "finish_reason", "ttft_ms", "trace_id"}
        with urllib.request.urlopen(url + "/health", timeout=30) as r:
            health = json.load(r)
        assert health["ok"] and health["stats"]["completed"] >= 4
        assert health["device"] == "cpu"
        for bad, needle in (({}, "prompt_ids"),
                            ({"prompt_ids": [1], "logprobs": 2}, "logprobs"),
                            ({"prompt_ids": [1], "json_schema": {}}, "json_schema"),
                            ({"prompt_ids": [1], "frequency_penalty": 0.5},
                             "frequency_penalty")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(url + "/generate", bad)
            assert ei.value.code == 400
            err = json.load(ei.value)
            assert err["code"] == "bad_request" and needle in err["error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "/nope", timeout=30)
        assert ei.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        client.close()
        t.join(timeout=30)
    assert not t.is_alive()
