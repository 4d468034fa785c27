"""The port's paged, prefix-caching, speculative serving engine and its
HTTP front-end, on the CPU.

Engine parity: with ``kv_page_size > 0``, the prefix cache on and
``spec_mode="ngram"`` (exact, then batched verify), the port's
``ServingEngine(device="cpu")`` gives the JAX package's
``ServingEngine`` greedy tokens (XLA decode attention on the JAX side)
for the same prompts and params, and the same count of prefix hits.
Two prompts share a prefix and retire in turn, so the second is
admitted onto cached pages; two repeat a motif, so n-gram drafts are
accepted. Greedy equality is only meaningful away from near-ties: the
seed is chosen so that every step's top-2 logit margin under the JAX
full forward is >= 1e-4. Spec-on greedy tokens equal spec-off greedy
tokens (the exact verify is bit-identical to plain decoding by
construction; at these sizes batched is too). Sampled spec output is a
pure function of the request, as non-spec sampling is.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

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
    accept_seed,
    draw_seed,
    sample_tokens,
    spec_accept,
)
from differential_transformer_replication_tpu_torch.serving.request import SamplingParams
from differential_transformer_replication_tpu_torch.serving.scheduler import FREE
from differential_transformer_replication_tpu_torch.serving.server import (
    ServingClient,
    serve,
)

SMALL = dict(vocab_size=61, n_embd=64, n_head=2, n_layer=2, block_size=32,
             dropout=0.0, n_terms=3, compute_dtype="float32")
NEAR_TIE = 1e-4
N_NEW = 8
PAGED = dict(num_slots=2, prefill_chunk=4, prefill_budget=6, kv_page_size=8)


def _setup(kind: str, **over):
    small = {**SMALL, **over}
    jcfg = JModelConfig(model=kind, **small)
    tree = jax.tree_util.tree_map(
        np.asarray, j_init_model(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(5)
    for blk in tree["blocks"]:
        for key in ("lambda_q", "lambda_k"):
            if key in blk["attn"]:
                blk["attn"][key] = (rng.standard_normal(blk["attn"][key].shape)
                                    * 0.1).astype(np.float32)
    tcfg = ModelConfig(model=kind, **small)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), \
        params_from_jax(tree, tcfg)


def _prompts():
    """A donor and a sharer of one 17-token prefix (the donor retires
    before the sharer is admitted: 2 slots, FCFS), two motif prompts,
    one random."""
    rng = np.random.default_rng(2)
    shared = rng.integers(0, SMALL["vocab_size"], 17).tolist()
    return [shared + [3], [4, 9, 4, 9, 4, 9, 4], rng.integers(0, 61, 6).tolist(),
            shared + [7, 8], [11, 12, 13] * 3]


def _no_near_ties(jparams, jcfg, prompts, outs):
    for p, o in zip(prompts, outs):
        seq = jnp.asarray(p + o.tokens[:-1], jnp.int32)[None]
        logits, _ = j_model_forward(jparams, seq, jcfg)
        steps = np.asarray(logits[0, len(p) - 1:], np.float32)
        top2 = np.sort(steps, axis=-1)[:, -2:]
        assert float(np.min(top2[:, 1] - top2[:, 0])) >= NEAR_TIE


@pytest.mark.parametrize("verify", ["exact", "batched"])
@pytest.mark.parametrize("kind", ["control", "diff", "ndiff"])
def test_paged_prefix_spec_greedy_tokens_match_jax_engine(kind, verify):
    jcfg, tcfg, jparams, tparams = _setup(kind)
    prompts = _prompts()
    spec = dict(spec_mode="ngram", spec_draft_len=3, spec_verify=verify)
    jeng = JServingEngine(jparams, jcfg, JServingConfig(**PAGED, **spec))
    jouts = jeng.generate(prompts, max_new_tokens=N_NEW, temperature=0.0)
    _no_near_ties(jparams, jcfg, prompts, jouts)
    teng = ServingEngine(tparams, tcfg, ServingConfig(**PAGED, **spec), device="cpu")
    touts = teng.generate(prompts, max_new_tokens=N_NEW, temperature=0.0)
    assert [o.tokens for o in touts] == [o.tokens for o in jouts]
    tpages, jpages = teng.page_stats(), jeng.page_stats()
    assert tpages["hits_total"] == jpages["hits_total"] >= 1
    assert tpages == jpages
    st = teng.stats.snapshot()
    assert st["spec_accepted"] >= 1 and teng.steps["spec_steps"] >= 1
    assert st["spec_proposed"] == jeng.stats["spec_proposed"]
    assert st["spec_accepted"] == jeng.stats["spec_accepted"]
    assert [(o.spec_proposed, o.spec_accepted) for o in touts] == \
        [(o.spec_proposed, o.spec_accepted) for o in jouts]
    # speculation changes nothing in greedy output, nor does the pool
    plain = ServingEngine(tparams, tcfg, ServingConfig(num_slots=2, prefill_chunk=4,
                                                       prefill_budget=6), device="cpu")
    assert [o.tokens for o in plain.generate(prompts, max_new_tokens=N_NEW,
                                             temperature=0.0)] == \
        [o.tokens for o in touts]
    assert all(s.state == FREE for s in teng.scheduler.slots)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_batched_verify_of_eight_drafts_matches_jax_engine(paged):
    """Batched verify at spec_draft_len 8: L = 9 query rows a slot, past
    the 8 rows of one kernel pass on the card (two passes there). The
    port's CPU engine gives the JAX engine's greedy tokens and draft
    counts, over the contiguous rings and the paged pool."""
    jcfg, tcfg, jparams, tparams = _setup("diff", block_size=64)
    prompts = _prompts()
    cfg = dict(num_slots=2, prefill_chunk=4, prefill_budget=6,
               kv_page_size=8 if paged else 0, spec_mode="ngram",
               spec_draft_len=8, spec_verify="batched")
    jeng = JServingEngine(jparams, jcfg, JServingConfig(**cfg))
    jouts = jeng.generate(prompts, max_new_tokens=2 * N_NEW, temperature=0.0)
    _no_near_ties(jparams, jcfg, prompts, jouts)
    teng = ServingEngine(tparams, tcfg, ServingConfig(**cfg), device="cpu")
    touts = teng.generate(prompts, max_new_tokens=2 * N_NEW, temperature=0.0)
    assert [o.tokens for o in touts] == [o.tokens for o in jouts]
    assert [(o.spec_proposed, o.spec_accepted) for o in touts] == \
        [(o.spec_proposed, o.spec_accepted) for o in jouts]
    assert max(o.spec_proposed for o in touts) >= 8
    assert all(s.state == FREE for s in teng.scheduler.slots)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_int8_spec_engine_greedy_equals_int8_plain(paged):
    """With the int8 cache, exact speculation over either pool gives the
    plain int8 engine's greedy tokens, and the paged pool the contiguous
    pool's (same contents, same arithmetic)."""
    _, tcfg, _, tparams = _setup("diff")
    prompts = _prompts()
    base = dict(num_slots=2, prefill_chunk=4, prefill_budget=6, kv_cache_dtype="int8")
    pool = dict(kv_page_size=8) if paged else {}
    ref = ServingEngine(tparams, tcfg, ServingConfig(**base), device="cpu")
    spec = ServingEngine(tparams, tcfg, ServingConfig(**base, **pool, spec_mode="ngram"),
                         device="cpu")
    want = [o.tokens for o in ref.generate(prompts, max_new_tokens=N_NEW, temperature=0.0)]
    assert [o.tokens for o in spec.generate(prompts, max_new_tokens=N_NEW,
                                            temperature=0.0)] == want
    assert spec.stats["spec_accepted"] >= 1
    assert spec.cache[0]["k"].dtype == torch.int8 and "k_scale" in spec.cache[0]


def test_spec_accept_semantics():
    """Greedy: the accepted prefix is the leading run of drafts equal to
    their rows' argmax, then the argmax of the first mismatching row.
    Sampled with no draft: sample_tokens exactly. Sampled with a draft
    the target gives probability 1: always accepted."""
    V = 7
    logits = torch.full((3, 3, V), -5.0)
    logits[0, 0, 2], logits[0, 1, 4], logits[0, 2, 1] = 3.0, 3.0, 3.0
    logits[1, 0, 5] = 1.0
    logits[2, :, 6] = 50.0
    greedy = SamplingParams(temperature=0.0)
    sampled = SamplingParams(temperature=0.7, top_k=3, seed=9)
    out, ok, _ = spec_accept(logits, [[2, 3], [], [6, 6]],
                             [greedy, sampled, sampled], [0, 4, 2])
    assert out[0] == [2, 4] and ok == [True, True, True]
    plain, _, _ = sample_tokens(logits[1, :1], [sampled], [4])
    assert out[1] == [int(plain[0])]
    assert out[2][:2] == [6, 6] and len(out[2]) == 3
    logits[0, 1, 0] = float("nan")
    assert spec_accept(logits, [[2, 3]], [greedy], [0])[1] == [False]
    # the guard covers a slot's used rows (0..dl) only, as the JAX one
    assert spec_accept(logits, [[]], [greedy], [0])[1] == [True]
    assert accept_seed(9, 4) not in (draw_seed(9, 4), draw_seed(9, 5))


def test_sampled_spec_output_is_a_function_of_the_request():
    _, tcfg, _, tparams = _setup("control")
    prompts = _prompts()[:3]

    def run(num_slots, order):
        eng = ServingEngine(tparams, tcfg, ServingConfig(
            num_slots=num_slots, prefill_chunk=4, prefill_budget=6, kv_page_size=8,
            spec_mode="ngram", spec_verify="batched"), device="cpu")
        ids = {eng.submit(prompts[i], temperature=0.9, top_k=8, seed=i,
                          max_new_tokens=10): i for i in order}
        return {ids[o.request_id]: o.tokens for o in eng.run()}

    assert run(2, [0, 1, 2]) == run(3, [2, 0, 1])


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def test_http_draft_len_health_and_page_pool_exhausted():
    _, tcfg, _, tparams = _setup("diff")
    engine = ServingEngine(tparams, tcfg, ServingConfig(
        **PAGED, kv_cache_dtype="int8", spec_mode="ngram"), device="cpu")
    client = ServingClient(engine)
    httpd = serve(client, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        p = _prompts()[1]
        full = _post(url + "/generate", {"prompt_ids": p, "max_new_tokens": 8,
                                         "temperature": 0.0})
        off = _post(url + "/generate", {"prompt_ids": p, "max_new_tokens": 8,
                                        "temperature": 0.0, "draft_len": 0})
        assert off["tokens"] == full["tokens"] and len(full["tokens"]) == 8
        with urllib.request.urlopen(url + "/health", timeout=30) as r:
            health = json.load(r)
        assert health["kv_pages"]["page_size"] == 8
        assert health["kv_pages"]["misses_total"] + health["kv_pages"]["hits_total"] == 2
        assert health["spec"]["mode"] == "ngram" and health["spec"]["proposed"] >= 1
        engine.pages.force_exhaust()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "/generate", {"prompt_ids": p, "max_new_tokens": 4})
        assert ei.value.code == 503
        assert json.load(ei.value)["code"] == "page_pool_exhausted"
        assert engine.stats["page_shed"] == 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "/generate", {"prompt_ids": p, "draft_len": -1})
        assert ei.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        client.close()
        t.join(timeout=30)


def test_later_slice_serving_values_are_refused_with_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
        ServingConfig(spec_mode="model")
    # the host tier is served since the tier slice: accepted, validated
    assert ServingConfig(kv_page_size=8, host_tier_bytes=1 << 20).tiered()
    with pytest.raises(ValueError, match="host_tier_bytes"):
        ServingConfig(kv_page_size=8, host_tier_bytes=-1)
    with pytest.raises(ValueError, match="spec_verify"):
        ServingConfig(spec_verify="fast")
    with pytest.raises(ValueError, match="must divide"):
        ServingConfig(kv_page_size=5).resolved_pool_pages(ModelConfig(**SMALL))
    assert ServingConfig(kv_page_size=8, num_slots=3,
                         prefix_cache_pages=2).resolved_pool_pages(
        ModelConfig(**SMALL)) == 3 * 4 + 2
