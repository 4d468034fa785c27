"""The serving fault kinds fire in the port's engine, on the CPU.

Each of ``serve_raise``, ``serve_hang``, ``serve_corrupt``,
``page_exhaust``, ``prefix_corrupt`` and ``spec_reject_storm``
(utils/faults.py) fires at its engine iteration (``stats["iterations"]``)
with the JAX engine's outcome: the crash class (``serve_raise`` and the
two NaN poisons caught by the finite-logits guard) fails the in-flight
request with a typed ``EngineCrashError`` and the supervised runner
rebuilds the pool, keeping the queue and serving bit-identical greedy
tokens after it; ``serve_hang`` marks ``/health`` degraded while the step
overruns its budget; ``page_exhaust`` sheds the admission typed (the 503
path) with a drain-rate ``retry_after``; ``spec_reject_storm`` rejects
every draft, so ``spec_accepted`` does not grow, with the tokens of the
unfaulted run. After a restart, ``stats`` and the registry's counters
agree and ``serving_engine_restarts_total`` equals the runner's
restarts. (The JAX engine's tests of the same kinds:
tests/test_serving_resilience.py and tests/test_obs.py.)

Each kind's outcome is also held against the JAX engine's: the same plan
and the same submissions go through both engines, driven step by step as
the supervised runner drives them (a crashed step hands back what
finished, then ``reset_after_crash``), and the crashes (iteration,
exception and lost requests), the finished requests' tokens and finish
reasons, the per-step draft counts and the ``stats`` must match key by
key.
"""

from __future__ import annotations

import time

import jax
import numpy as np
import pytest

from differential_transformer_replication_tpu.config import ModelConfig as JModelConfig
from differential_transformer_replication_tpu.config import ServingConfig as JServingConfig
from differential_transformer_replication_tpu.models import init_model as j_init_model
from differential_transformer_replication_tpu.serving.engine import (
    ServingEngine as JServingEngine,
)
from differential_transformer_replication_tpu.utils import faults as jfaults
from differential_transformer_replication_tpu_torch.config import (
    ModelConfig,
    ServingConfig,
)
from differential_transformer_replication_tpu_torch.obs.registry import (
    parse_exposition,
)
from differential_transformer_replication_tpu_torch.params import params_from_jax
from differential_transformer_replication_tpu_torch.serving.engine import (
    _STAT_SPEC,
    EngineCrashError,
    ServingEngine,
)
from differential_transformer_replication_tpu_torch.serving.pages import (
    PagePoolExhaustedError,
)
from differential_transformer_replication_tpu_torch.serving.server import (
    ServingClient,
)
from differential_transformer_replication_tpu_torch.utils import faults

SMALL = dict(vocab_size=61, n_embd=32, n_head=2, n_layer=2, block_size=32,
             dropout=0.0, n_terms=3, compute_dtype="float32")
POOL = dict(num_slots=2, prefill_chunk=4, prefill_budget=6,
            restart_backoff_s=0.0, max_restarts=3)
PAGED = dict(kv_page_size=8, kv_pool_pages=12)


@pytest.fixture(autouse=True)
def _disarm():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


@pytest.fixture(scope="module")
def jax_model():
    jcfg = JModelConfig(model="control", **SMALL)
    return jcfg, j_init_model(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def model(jax_model):
    cfg = ModelConfig(model="control", **SMALL)
    tree = jax.tree_util.tree_map(np.asarray, jax_model[1])
    return cfg, params_from_jax(tree, cfg)


def _engine(model, **kw):
    cfg, params = model
    return ServingEngine(params, cfg, ServingConfig(**{**POOL, **kw}),
                         device="cpu")


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, SMALL["vocab_size"], size=n).tolist() for n in lens]


def _greedy(model, prompt, n, **kw):
    return _engine(model, **kw).generate([prompt], max_new_tokens=n,
                                         temperature=0.0)[0].tokens


def _stats_equal_registry(engine):
    snap = engine.stats.snapshot()
    _, samples = parse_exposition(engine.registry.render())
    vals = {n: v for n, lab, v in samples if not lab}
    for key, (name, _) in _STAT_SPEC.items():
        assert vals[name] == snap[key], key
    return snap


@pytest.mark.parametrize("kind,kw", [
    ("serve_raise", {}),
    ("serve_corrupt", {}),
    ("serve_corrupt", dict(PAGED, kv_cache_dtype="int8")),
], ids=["serve_raise", "serve_corrupt", "serve_corrupt-paged-int8"])
def test_crash_class_fault_restarts_keeping_the_queue(model, kind, kw):
    p_infl, p_queued, p_after = _prompts([5, 7, 6], seed=26)
    want_q = _greedy(model, p_queued, 6, **kw)
    want_after = _greedy(model, p_after, 6, **kw)
    engine = _engine(model, num_slots=1, **kw)
    client = ServingClient(engine)
    # iteration 0 prefills request 0 (5 tokens, budget 6) and decodes
    # it; iteration 2 decodes it again with request 1 still queued
    faults.arm(f"{kind}@2")
    try:
        a = client.runner.submit(p_infl, max_new_tokens=16, temperature=0.0)
        b = client.runner.submit(p_queued, max_new_tokens=6, temperature=0.0)
        assert a.done.wait(60) and b.done.wait(60)
        assert isinstance(a.error, EngineCrashError) and a.error.retriable
        if kind == "serve_corrupt":
            assert "non-finite" in str(a.error)
        else:
            assert isinstance(a.error.__cause__, faults.FaultInjected)
            assert "iteration 2" in str(a.error.__cause__)
        assert b.error is None and b.result.tokens == want_q
        out = client.generate(p_after, max_new_tokens=6, temperature=0.0,
                              timeout=60)
        assert out.tokens == want_after
        assert client.status() == "healthy"
        assert client.runner.restarts == 1
        snap = _stats_equal_registry(engine)
        assert snap["engine_restarts"] == client.runner.restarts
        assert snap["completed"] == 2
        # the fault is one-shot: the rebuilt engine replays iteration
        # numbers without crashing again
        again = client.generate(p_infl, max_new_tokens=4, temperature=0.0,
                                timeout=60)
        assert again.tokens == _greedy(model, p_infl, 4, **kw)
        assert client.runner.restarts == 1
    finally:
        client.close()


def test_serve_hang_marks_the_engine_degraded(model, monkeypatch):
    monkeypatch.setenv(faults.HANG_ENV_VAR, "0.8")
    p = _prompts([4], seed=30)[0]
    engine = _engine(model, step_time_budget_s=0.2)
    client = ServingClient(engine)
    faults.arm("serve_hang@1")
    try:
        h = client.runner.submit(p, max_new_tokens=4, temperature=0.0)
        seen = set()
        while not h.done.is_set():
            seen.add(client.status())
            time.sleep(0.02)
        assert "degraded" in seen
        assert h.error is None and h.result.tokens == _greedy(model, p, 4)
        assert client.runner.last_step_s < 0.2  # recovered: later steps are fast
        assert client.runner.restarts == 0
    finally:
        client.close()


def test_page_exhaust_sheds_typed_then_serves_on(model):
    p0, p1, p2 = _prompts([5, 6, 4], seed=31)
    engine = _engine(model, num_slots=1, **PAGED)
    client = ServingClient(engine)
    # request 1 waits for the slot; its admission plan runs at the
    # iteration after request 0 retires (iteration 3: 0 prefills and
    # decodes, 1 and 2 decode)
    faults.arm("page_exhaust@3")
    try:
        a = client.runner.submit(p0, max_new_tokens=4, temperature=0.0)
        b = client.runner.submit(p1, max_new_tokens=4, temperature=0.0)
        assert a.done.wait(60) and b.done.wait(60)
        assert a.error is None
        assert isinstance(b.error, PagePoolExhaustedError)
        assert b.error.output.finish_reason == "page_exhausted"
        assert b.error.retry_after is None or b.error.retry_after >= 0
        out = client.generate(p2, max_new_tokens=4, temperature=0.0, timeout=60)
        assert out.tokens == _greedy(model, p2, 4, **PAGED)
        snap = _stats_equal_registry(engine)
        assert snap["page_shed"] == 1 and snap["engine_restarts"] == 0
        assert snap["completed"] == 2
    finally:
        client.close()


def test_prefix_corrupt_poisons_a_shared_page_and_restarts(model):
    shared = _prompts([16], seed=32)[0]
    donor, sharer, later = shared + [3, 4], shared + [9, 9, 1], shared + [7]
    engine = _engine(model, **PAGED)
    client = ServingClient(engine)
    try:
        assert client.generate(donor, max_new_tokens=3, temperature=0.0,
                               timeout=60).tokens == _greedy(model, donor, 3, **PAGED)
        assert engine.page_stats()["cached"] >= 2
        it = engine.stats["iterations"]
        # the sharer's admission reuses the cached pages; poison one of
        # them at its second iteration, when it decodes
        faults.arm(f"prefix_corrupt@{it + 1}")
        h = client.runner.submit(sharer, max_new_tokens=8, temperature=0.0)
        assert h.done.wait(60)
        assert isinstance(h.error, EngineCrashError)
        assert "non-finite" in str(h.error)
        assert client.runner.restarts == 1
        # the rebuilt pool starts empty: the poisoned prefix is gone
        assert engine.page_stats()["cached"] == 0
        out = client.generate(later, max_new_tokens=5, temperature=0.0, timeout=60)
        assert out.tokens == _greedy(model, later, 5, **PAGED)
        assert _stats_equal_registry(engine)["engine_restarts"] == 1
    finally:
        client.close()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_spec_reject_storm_rejects_every_draft_in_its_window(model, paged):
    spec = dict(spec_mode="ngram", spec_draft_len=3, **(PAGED if paged else {}))
    prompts = [[5, 9, 2] * 4, [7, 1] * 5 + [3]]
    want = [o.tokens for o in _engine(model, **({**PAGED} if paged else {})).generate(
        prompts, max_new_tokens=10, temperature=0.0)]
    engine = _engine(model, **spec)
    faults.arm("spec_reject_storm@3-6")
    for p in prompts:
        engine.submit(p, max_new_tokens=10, temperature=0.0)
    outs, storm, after = [], [], []
    while engine.has_work():
        it = engine.stats["iterations"]
        before = engine.stats.snapshot()
        outs += engine.step()
        st = engine.stats.snapshot()
        if before["spec_proposed"] != st["spec_proposed"]:
            (storm if 3 <= it <= 6 else after).append(
                (st["spec_proposed"] - before["spec_proposed"],
                 st["spec_accepted"] - before["spec_accepted"]))
    assert [o.tokens for o in sorted(outs, key=lambda o: o.request_id)] == want
    assert storm and all(prop > 0 and acc == 0 for prop, acc in storm)
    assert any(acc > 0 for _, acc in after)  # not one-shot, not forever


def _supervise(engine, fmod, waves):
    """Drive ``engine`` step by step as the supervised runner does, the
    faults of ``fmod`` (the port's or the JAX package's module) armed by
    each wave: ``waves`` is a list of (plan or None, submissions), the
    plan a function of the engine's iteration when the wave starts, each
    submission (prompt, max_new_tokens), greedy. A wave steps until the
    engine has no work. A step that raises hands back what finished
    (``take_finished``), then ``reset_after_crash`` rebuilds the pool
    and names the requests lost. Returns what both packages must agree
    on."""
    crashes, done, steps = [], {}, []
    for plan, subs in waves:
        if plan is not None:
            fmod.arm(plan(engine.stats["iterations"]))
        for prompt, n in subs:
            engine.submit(prompt, max_new_tokens=n, temperature=0.0)
        while engine.has_work():
            it = engine.stats["iterations"]
            p0, a0 = engine.stats["spec_proposed"], engine.stats["spec_accepted"]
            try:
                outs = engine.step()
            except Exception as e:  # the runner's crash path
                outs = engine.take_finished()
                lost = engine.reset_after_crash()
                crashes.append((it, type(e).__name__, "non-finite" in str(e),
                                sorted(lost)))
            for o in outs:
                done[o.request_id] = (list(o.tokens), o.finish_reason)
            steps.append((it, engine.stats["spec_proposed"] - p0,
                          engine.stats["spec_accepted"] - a0))
    return dict(crashes=crashes, done=done, steps=steps,
                stats=dict(engine.stats))


def _wave_crash(kind):
    p_infl, p_queued, p_after = _prompts([5, 7, 6], seed=26)
    return [(lambda it: f"{kind}@2", [(p_infl, 16), (p_queued, 6)]),
            (None, [(p_after, 6)])]


def _wave_page_exhaust():
    p0, p1, p2 = _prompts([5, 6, 4], seed=31)
    return [(lambda it: "page_exhaust@3", [(p0, 4), (p1, 4)]),
            (None, [(p2, 4)])]


def _wave_prefix_corrupt():
    shared = _prompts([16], seed=32)[0]
    return [(None, [(shared + [3, 4], 3)]),
            (lambda it: f"prefix_corrupt@{it + 1}", [(shared + [9, 9, 1], 8)]),
            (None, [(shared + [7], 5)])]


def _wave_storm():
    return [(lambda it: "spec_reject_storm@3-6",
             [([5, 9, 2] * 4, 10), ([7, 1] * 5 + [3], 10)])]


SPEC = dict(spec_mode="ngram", spec_draft_len=3)
PARITY = {
    "serve_raise": (dict(num_slots=1), _wave_crash("serve_raise")),
    "serve_hang": (dict(num_slots=1), _wave_crash("serve_hang")),
    "serve_corrupt": (dict(num_slots=1), _wave_crash("serve_corrupt")),
    "serve_corrupt-paged-int8": (dict(PAGED, num_slots=1, kv_cache_dtype="int8"),
                                 _wave_crash("serve_corrupt")),
    "page_exhaust": (dict(PAGED, num_slots=1), _wave_page_exhaust()),
    "prefix_corrupt": (dict(PAGED, num_slots=1), _wave_prefix_corrupt()),
    "spec_reject_storm-paged": (dict(PAGED, **SPEC), _wave_storm()),
    "spec_reject_storm-contiguous": (dict(SPEC), _wave_storm()),
}


@pytest.mark.parametrize("case", list(PARITY))
def test_fault_outcome_equals_the_jax_engines(model, jax_model, monkeypatch, case):
    monkeypatch.setenv(faults.HANG_ENV_VAR, "0.05")
    monkeypatch.setenv(jfaults.HANG_ENV_VAR, "0.05")
    kw, waves = PARITY[case]
    got = _supervise(_engine(model, **kw), faults, waves)
    jcfg, jparams = jax_model
    want = _supervise(JServingEngine(jparams, jcfg, JServingConfig(**{**POOL, **kw})),
                      jfaults, waves)
    assert got == want
    # and the fault fired: the outcome is not that of an unfaulted run
    kind = case.split("-")[0]
    if kind in ("serve_raise", "serve_corrupt", "prefix_corrupt"):
        assert len(got["crashes"]) == 1 and got["crashes"][0][3]
        assert got["crashes"][0][1:3] == (
            ("FaultInjected", False) if kind == "serve_raise"
            else ("EngineCrashError", True))
        assert got["stats"]["engine_restarts"] == 1
    elif kind == "page_exhaust":
        assert got["stats"]["page_shed"] == 1
        assert [r for _, r in got["done"].values()].count("page_exhausted") == 1
    elif kind == "spec_reject_storm":
        storm = [(p, a) for it, p, a in got["steps"] if 3 <= it <= 6 and p]
        assert storm and not any(a for _, a in storm)
    else:  # serve_hang only stalls the step: nothing fails
        assert not got["crashes"] and len(got["done"]) == 3
