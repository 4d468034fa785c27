"""Structured decoding, penalties and logprobs of the port's serving
engine against the JAX package's, on the CPU.

- ``compile_constraint`` of a regex, a ``choices`` list and a JSON schema
  gives masks, transitions, accepting states and start state EQUAL to
  the JAX compiler's on the same vocabulary (a byte-level BPE trained by
  the test); malformed specs raise the same typed errors;
  ``ConstraintCache`` counts the same hits, misses and evictions.
- ``apply_logit_pipeline`` equals JAX's exactly on random fp32 inputs,
  and inert rows come back bit-identical to the input.
- Sampled verify rows (penalized, constrained, plain), whose draws
  cannot match JAX's generator: the port's accept decisions, residual
  draws and logprob echo are read against the surface of JAX's own
  verify accept on the same logits and drafts.
- The engine: the same greedy requests (regex, choices, schema,
  penalties with the logprob echo, the echo under top-k, a plain row)
  give JAX's engine's tokens and finish reasons without speculation,
  with n-gram drafts and with a model drafter under exact and batched
  verify, on the contiguous and the paged pool; logprobs agree within
  1e-4 (the top lists' ids exactly); ``stats``, ``constrain_stats()``
  and ``spec_stats()`` agree key by key (the port's ``spec_stats`` adds
  ``verify_steps``).
- ``constrain_dead_end`` fires at JAX's point with the same counters and
  finish reasons; a compile failure (``constrain_compile_fail``, a
  malformed schema, no vocabulary) leaves the engine untouched.
- Over HTTP: ``constraint_compile_failed``, ``constraint_dead_end`` with
  ``partial_tokens``, the logprob payload, ``/health`` ``constraints``.
- Migration: a constrained, penalized, logprobs request exported by
  either package imports in the other and continues to the source's
  uninterrupted greedy tokens; a replay with ``key_offset`` seeds the
  histogram and the FSM cursor from the prompt tail.
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
from differential_transformer_replication_tpu.models.decode import (
    apply_logit_pipeline as j_apply_logit_pipeline,
)
from differential_transformer_replication_tpu.serving.engine import (
    _build_spec_step_fns,
)
from differential_transformer_replication_tpu.serving import constrain as jcon
from differential_transformer_replication_tpu.utils import faults as jfaults
from differential_transformer_replication_tpu_torch.models.decode import (
    apply_logit_pipeline,
)
from differential_transformer_replication_tpu_torch.serving import constrain as tcon
from differential_transformer_replication_tpu_torch.serving.engine import (
    Pipe,
    _uniform,
    accept_seed,
    spec_accept,
)
from differential_transformer_replication_tpu_torch.serving.request import (
    SamplingParams,
)
from differential_transformer_replication_tpu_torch.serving.server import (
    ServingClient,
    serve,
)
from differential_transformer_replication_tpu_torch.utils import faults as tfaults

from torch_request_common import (
    REQUESTS,
    SCHEMA,
    both_params,
    engines,
    prompts,
    vocab,
)

LP_TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    tfaults.reset()
    jfaults.reset()


# -- the compiler --------------------------------------------------------


@pytest.mark.parametrize("kind,spec", [
    ("regex", "[a-z ]+\\."),
    ("regex", "(Tom|Sue) (went|saw) [a-z]{1,6}( [a-z]+)?\\."),
    ("choices", ("Tom went home.", "Sue saw a dog.", "yes")),
    ("json_schema", json.dumps(SCHEMA)),
    ("json_schema", json.dumps({"type": "array", "items": {
        "enum": ["a", "bc", 3]}, "maxItems": 3})),
])
@pytest.mark.parametrize("eos", [None, 1])
def test_compiled_fsm_equals_jax(kind, spec, eos):
    """Tolerance: none — the same tables, entry for entry."""
    key = (kind, spec, eos)
    j, t = jcon.compile_constraint(key, vocab()), tcon.compile_constraint(key, vocab())
    for name in ("masks", "trans", "accepting"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), name)
    assert (t.start, t.n_states, t.nbytes) == (j.start, j.n_states, j.nbytes)
    assert t.masks[t.start].any()


@pytest.mark.parametrize("key", [
    ("regex", "(ab", None), ("regex", "a{3,1}", None), ("regex", "[z-a]", None),
    ("json_schema", "{not json", None),
    ("json_schema", json.dumps({"type": "tuple"}), None),
    ("regex", "☃+", None),  # no token spells it
])
def test_malformed_specs_raise_the_same_typed_error(key):
    with pytest.raises(jcon.ConstraintCompileError) as je:
        jcon.compile_constraint(key, vocab())
    with pytest.raises(tcon.ConstraintCompileError) as te:
        tcon.compile_constraint(key, vocab())
    assert str(te.value) == str(je.value)
    assert isinstance(te.value, ValueError)


def test_constraint_cache_counts_as_jax():
    keys = [("regex", r, None) for r in ("[a-c]+", "[d-f]+", "[a-c]+", "[g-i]+",
                                         "[d-f]+", "[j-l]+")]
    jc, tc = jcon.ConstraintCache(2), tcon.ConstraintCache(2)
    for i, key in enumerate(keys):
        jc.acquire(key, vocab())
        tc.acquire(key, vocab())
        if i % 2:
            jc.release(key)
            tc.release(key)
        assert tc.stats() == jc.stats()
    assert tc.stats()["hits_total"] >= 1 and tc.stats()["evictions_total"] >= 1


# -- the pipeline --------------------------------------------------------


def test_apply_logit_pipeline_equals_jax_and_passes_inert_rows_through():
    """Tolerance: none (bit for bit), on random fp32 logits with a mix of
    rows: every penalty, each alone, masked, inert."""
    rng = np.random.default_rng(7)
    n, V = 12, 97
    logits = (rng.standard_normal((n, V)) * 3).astype(np.float32)
    allowed = rng.random((n, V)) > 0.3
    allowed[[0, 5, 9]] = True  # inert rows: no mask ...
    counts = rng.integers(0, 4, (n, V)).astype(np.int32)
    rep = np.array([1, 1.3, 1, 1, 0.7, 1, 2, 1, 1, 1, 1.1, 1], np.float32)
    pres = np.array([0, 0, 0.5, 0, 0, 0, 1, 0, 0, 0, 0, 2], np.float32)
    freq = np.array([0, 0, 0, 0.25, 0, 0, 0.1, 0, 0, 0, 0, 0], np.float32)
    # ... and no penalty (rows 0, 5, 9), and masked-only rows (7, 8)
    want = np.asarray(j_apply_logit_pipeline(
        jnp.asarray(logits), jnp.asarray(allowed), jnp.asarray(counts),
        jnp.asarray(rep), jnp.asarray(pres), jnp.asarray(freq)))
    got = apply_logit_pipeline(
        torch.from_numpy(logits), torch.from_numpy(allowed),
        torch.from_numpy(counts), torch.from_numpy(rep), torch.from_numpy(pres),
        torch.from_numpy(freq)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got[[0, 5, 9]].view(np.int32),
                                  logits[[0, 5, 9]].view(np.int32))
    # the engine's inert forms: no mask and no histogram at all
    t = torch.from_numpy(logits)
    assert torch.equal(apply_logit_pipeline(t, None, None, None, None, None), t)


def _jax_accept(k: int, V: int):
    """The JAX verify step's accept (``_build_spec_step_fns._accept``,
    the sampled rung) with an echo as wide as the vocabulary, so its top
    list is each row's whole log-distribution."""
    cfg = JModelConfig(model="diff", vocab_size=V, n_embd=64, n_head=2,
                       n_layer=1, block_size=48)
    step = _build_spec_step_fns(cfg, 48, k, sampled=True, lp_k=V)
    inner = step.__wrapped__
    cells = dict(zip(inner.__code__.co_freevars,
                     (c.cell_contents for c in inner.__closure__)))
    return jax.jit(cells["_accept"])


@pytest.mark.parametrize("force_reject", [False, True])
def test_sampled_verify_rows_accept_draw_and_echo_over_jax_surface(force_reject):
    """Rows: sampled with every penalty, sampled under a constraint mask
    and top-k, sampled plain, greedy penalized; each asks for logprobs.
    The port's sampled draws cannot equal JAX's (other generators), so
    they are read against JAX's surface instead: each accepted draft's
    uniform lies below its probability there and the first rejected
    one's not (ties within 1e-5 are skipped), the correction has a
    finite logprob there and is not the rejected draft, and the echo of
    every emitted row (the chosen token's logprob and the top list)
    equals JAX's within 1e-4, ids exactly. The greedy row's tokens equal
    JAX's. Tolerance: 1e-4 on logprobs and probabilities."""
    rng = np.random.default_rng(11)
    B, k, V, lp_k = 4, 3, 64, 5
    L = k + 1
    logits = (rng.standard_normal((B, L, V)) * 2.5).astype(np.float32)
    allowed = np.ones((B, L, V), bool)
    allowed[1] = rng.random((L, V)) > 0.4
    pcounts = np.zeros((B, V), np.int32)
    pcounts[[0, 3]] = rng.integers(0, 3, (2, V))
    pens = np.array([[1.3, 0.5, 0.25], [1, 0, 0], [1, 0, 0], [1.2, 1.0, 0]],
                    np.float32)
    params = [SamplingParams(temperature=0.8, seed=1, logprobs=lp_k,
                             repetition_penalty=1.3, presence_penalty=0.5,
                             frequency_penalty=0.25),
              SamplingParams(temperature=1.1, top_k=8, seed=2, logprobs=lp_k),
              SamplingParams(temperature=1.3, seed=3, logprobs=lp_k),
              SamplingParams(temperature=0.0, logprobs=lp_k,
                             repetition_penalty=1.2, presence_penalty=1.0)]
    steps = [5, 9, 0, 2]
    # random drafts, each lifted in its row by a random margin, so some
    # are accepted and some not; one row drafts nothing
    drafts = [rng.integers(0, V, dl).tolist() for dl in (3, 3, 2, 0)]
    for i, d in enumerate(drafts):
        for j, tok in enumerate(d):
            logits[i, j, tok] += rng.uniform(2, 9)
            allowed[i, j, tok] = True
    got, ok, _, (chosen, ids, vals) = spec_accept(
        torch.from_numpy(logits), drafts, params, steps,
        force_reject=force_reject,
        pipe=Pipe(torch.from_numpy(allowed), torch.from_numpy(pcounts),
                  torch.from_numpy(pens)), lp_k=lp_k)
    dpad = np.array([d + [0] * (k - len(d)) for d in drafts], np.int32)
    toks, n_emit, j_ok, _, j_ids, j_lp, _ = _jax_accept(k, V)(
        jnp.asarray(logits), jnp.asarray(dpad),
        jnp.asarray([len(d) for d in drafts], jnp.int32),
        jnp.asarray(force_reject), jnp.zeros((B, 2), jnp.uint32),
        jnp.asarray(steps, jnp.int32),
        jnp.asarray([max(p.temperature, 0.0) for p in params], jnp.float32),
        jnp.asarray([p.top_k or 0 for p in params], jnp.int32),
        *(jnp.asarray(pens[:, c]) for c in range(3)),
        jnp.asarray(allowed), jnp.asarray(pcounts), jnp.zeros((B,), jnp.int32))
    j_ids, j_lp = np.asarray(j_ids), np.asarray(j_lp)
    surface = np.full((B, L, V), -np.inf, np.float32)
    np.put_along_axis(surface, j_ids, j_lp, axis=-1)
    assert ok == np.asarray(j_ok).tolist()
    toks = np.asarray(toks)
    assert got[3] == toks[3, :int(n_emit[3])].tolist()
    compared = 0
    for i, (d, p, t0, out) in enumerate(zip(drafts, params, steps, got)):
        a = len(out) - 1
        assert out[:a] == d[:a] and a <= len(d)
        if force_reject:
            assert a == 0
        if p.temperature > 0:
            assert np.isfinite(surface[i, a, out[a]])
            if a < len(d):
                assert out[a] != d[a]
            for j in range(a + (a < len(d) and not force_reject)):
                u = float(_uniform(1, accept_seed(p.seed, t0 + j), "cpu"))
                prob = float(np.exp(surface[i, j, d[j]]))
                if abs(u - prob) > 1e-5:
                    assert (u < prob) == (j < a), (i, j, u, prob)
                    compared += 1
        for j, tok in enumerate(out):
            np.testing.assert_allclose(chosen[i, j], surface[i, j, tok],
                                       atol=LP_TOL, rtol=0)
            np.testing.assert_array_equal(ids[i, j], j_ids[i, j, :lp_k])
            np.testing.assert_allclose(vals[i, j], j_lp[i, j, :lp_k],
                                       atol=LP_TOL, rtol=0)
    assert force_reject or compared >= 3


# -- the engine ----------------------------------------------------------


SPEC_CASES = {
    "none": dict(),
    "ngram": dict(spec_mode="ngram", spec_draft_len=3),
    "model-exact": dict(spec_mode="model", spec_draft_len=3),
    "model-batched": dict(spec_mode="model", spec_draft_len=3,
                          spec_verify="batched"),
}


def _run_both(teng, jeng, reqs=REQUESTS, ps=None):
    ps = ps or prompts(len(reqs))
    pairs = [both_params(r) for r in reqs]
    touts = teng.generate(ps, params=[p[0] for p in pairs])
    jouts = jeng.generate(ps, params=[p[1] for p in pairs])
    return touts, jouts


def _assert_outputs_agree(touts, jouts):
    for t, j in zip(touts, jouts):
        assert (t.tokens, t.finish_reason) == (j.tokens, j.finish_reason)
        assert (t.token_logprobs is None) == (j.token_logprobs is None)
        if j.token_logprobs is not None:
            np.testing.assert_allclose(t.token_logprobs, j.token_logprobs,
                                       atol=LP_TOL, rtol=0)
            assert [[i for i, _ in row] for row in t.top_logprobs] == \
                [[i for i, _ in row] for row in j.top_logprobs]
            np.testing.assert_allclose(
                [[v for _, v in row] for row in t.top_logprobs],
                [[v for _, v in row] for row in j.top_logprobs],
                atol=LP_TOL, rtol=0)


@pytest.mark.parametrize("paged", [0, 8], ids=["contiguous", "paged"])
@pytest.mark.parametrize("spec", list(SPEC_CASES))
def test_engine_greedy_tokens_logprobs_and_counters_equal_jax(spec, paged):
    teng, jeng = engines(kv_page_size=paged, **SPEC_CASES[spec])
    touts, jouts = _run_both(teng, jeng)
    _assert_outputs_agree(touts, jouts)
    # every constrained output is accepted by its FSM (up to its budget)
    for req, out in zip(REQUESTS, touts):
        if any(k in req for k in ("regex", "choices", "json_schema")):
            fsm = tcon.compile_constraint(
                tcon.spec_key(both_params(req)[0], None), vocab())
            assert fsm.walk(out.tokens) >= 0
            if out.finish_reason == "constraint_complete":
                assert fsm.matches(out.tokens)
    assert any(o.finish_reason == "constraint_complete" for o in touts)
    assert teng.stats.snapshot() == dict(jeng.stats)
    assert teng.constrain_stats() == jeng.constrain_stats()
    if spec != "none":
        ts, js = teng.spec_stats(), jeng.spec_stats()
        assert {k: ts[k] for k in js} == js
        assert ts["proposed"] > 0


@pytest.mark.parametrize("spec", ["none", "model-exact"])
def test_presence_penalty_100_repeats_no_token(spec):
    teng, jeng = engines(**SPEC_CASES[spec])
    touts, jouts = _run_both(teng, jeng, [dict(presence_penalty=100.0,
                                               max_new_tokens=12)])
    _assert_outputs_agree(touts, jouts)
    assert len(set(touts[0].tokens)) == len(touts[0].tokens) == 12


def test_dead_end_fault_and_compile_failures_match_jax():
    """``constrain_dead_end@N`` retires the first constrained ACTIVE slot
    as ``constraint_dead_end`` with its partial output in both engines,
    counted under the finish reason only; the compile failures raise the
    typed error with the engine untouched (no queue entry, no cache
    reference)."""
    got = {}
    for name, (eng, fmod) in {"port": (engines()[0], tfaults),
                              "jax": (engines()[1], jfaults)}.items():
        p = both_params(REQUESTS[0])[0 if name == "port" else 1]
        plain = both_params(REQUESTS[5])[0 if name == "port" else 1]
        fmod.arm("constrain_dead_end@4")
        rids = [eng.submit(prompts(1)[0], params=p),
                eng.submit(prompts(2)[1], params=plain)]
        outs = {o.request_id: o for o in eng.run()}
        fmod.reset()
        got[name] = ([(outs[r].tokens, outs[r].finish_reason) for r in rids],
                     eng.stats.snapshot(), eng.constrain_stats())
        assert outs[rids[0]].finish_reason == "constraint_dead_end"
        with pytest.raises(ValueError) as e:
            eng.submit([1, 2], json_schema="{oops", temperature=0.0)
        assert type(e.value).__name__ == "ConstraintCompileError"
        fmod.arm("constrain_compile_fail")
        with pytest.raises(ValueError):
            eng.submit([1, 2], regex="[q-z]+", temperature=0.0)
        fmod.reset()
        assert not eng.has_work() and eng.constrain_stats()["referenced"] == 0
    assert got["port"] == got["jax"]
    bare = engines()[0]
    bare._vocab = None
    with pytest.raises(tcon.ConstraintCompileError, match="vocabulary"):
        bare.submit([1, 2], regex="a+")
    assert not bare.has_work() and bare.stats["rejected"] == 1


# -- HTTP ----------------------------------------------------------------


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_http_constraints_logprobs_and_health():
    teng, jeng = engines()
    client = ServingClient(teng)
    httpd = serve(client, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        p = prompts(1)[0]
        # the schema as a JSON object, with logprobs: JAX's tokens and echo
        status, reply = _post(url + "/generate", {
            "prompt_ids": p, "json_schema": SCHEMA, "max_new_tokens": 12,
            "temperature": 0.0, "logprobs": 2})
        want = jeng.generate([p], params=[both_params(dict(
            json_schema=json.dumps(SCHEMA), max_new_tokens=12, logprobs=2))[1]])[0]
        assert status == 200 and reply["tokens"] == want.tokens
        assert reply["finish_reason"] == want.finish_reason
        np.testing.assert_allclose(reply["token_logprobs"], want.token_logprobs,
                                   atol=LP_TOL)
        assert [[i for i, _ in row] for row in reply["top_logprobs"]] == \
            [[i for i, _ in row] for row in want.top_logprobs]
        # no echo unless asked
        status, reply = _post(url + "/generate", {
            "prompt_ids": p, "choices": ["yes", "no"], "temperature": 0.0,
            "presence_penalty": 1.0})
        assert status == 200 and "token_logprobs" not in reply
        status, reply = _post(url + "/generate", {
            "prompt_ids": p, "json_schema": "{not json", "temperature": 0.0})
        assert (status, reply["code"]) == (400, "constraint_compile_failed")
        status, reply = _post(url + "/generate", {"prompt_ids": p, "spec": 1})
        assert (status, reply["code"]) == (400, "bad_request")
        tfaults.arm(f"constrain_dead_end@{teng.stats['iterations'] + 3}")
        status, reply = _post(url + "/generate", {
            "prompt_ids": p, "regex": "[a-z ]+\\.", "temperature": 0.0,
            "max_new_tokens": 10})
        assert (status, reply["code"]) == (400, "constraint_dead_end")
        assert isinstance(reply["partial_tokens"], list) and reply["partial_tokens"]
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.load(r)
        assert set(health["constraints"]) == set(jeng.constrain_stats())
        # the schema, the choices, the malformed schema and the regex
        assert health["constraints"]["misses_total"] == 4
        assert health["constraints"]["active"] == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        client.close()
        th.join(timeout=30)


# -- migration -----------------------------------------------------------


MIGRATED = dict(regex="[a-z ]+\\.", presence_penalty=0.7, frequency_penalty=0.2,
                logprobs=3, max_new_tokens=14)


def _decode_until(eng, rid, n):
    for _ in range(200):
        s = eng._slot_for(rid)
        if s is not None and len(s.generated) >= n:
            return
        eng.step()
    raise AssertionError("the request never reached its tokens")


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_a_constrained_penalized_logprobs_request_migrates_both_ways(direction):
    _, jeng = engines(kv_page_size=8)
    p = prompts(1, seed=4)[0]
    tp, jp = both_params(MIGRATED)
    ref = jeng.generate([p], params=[jp])[0]
    to_port = direction == "jax-to-port"
    src = engines(kv_page_size=8)[1 if to_port else 0]
    dst = engines(kv_page_size=8)[0 if to_port else 1]
    sp = jp if to_port else tp
    rid = src.submit(p, params=sp)
    _decode_until(src, rid, 4)
    new = dst.import_state(src.export_slot_state(rid))
    (out,) = [o for o in dst.run() if o.request_id == new]
    assert (out.tokens, out.finish_reason) == (ref.tokens, ref.finish_reason)
    np.testing.assert_allclose(out.token_logprobs, ref.token_logprobs, atol=LP_TOL)
    assert dst.stats["migrate_imports"] == 1 and dst.constrain_stats()["active"] == 0


def test_replay_seeds_the_histogram_and_fsm_cursor_from_the_prompt_tail():
    """A replayed continuation (prompt + the first k emitted tokens,
    ``key_offset`` k) continues to the uninterrupted run's tail, in both
    packages: the FSM cursor walks the tail and the penalty histogram
    counts it."""
    p = prompts(1, seed=5)[0]
    for idx in (0, 1):
        eng = engines()[idx]
        sp = both_params(MIGRATED)[idx]
        full = eng.generate([p], params=[sp])[0].tokens
        k = 4
        kw = dict(MIGRATED, max_new_tokens=MIGRATED["max_new_tokens"] - k,
                  key_offset=k)
        tail = eng.generate([p + full[:k]], params=[both_params(kw)[idx]])[0].tokens
        assert tail == full[k:], (idx, tail, full)
