"""The port's quality telemetry against the JAX package's, on the CPU.

- ``models/decode.py:quality_vector`` equals JAX's within 1e-5 on 2-D
  sampler-shaped and 3-D verify-shaped logits, fully masked rows (entropy
  0, non-finite margin) and one-finite-logit rows (infinite margin)
  included;
- ``obs/quality.py`` (a copy): sketches, PSI, drift and the quality row
  equal JAX's, and a fingerprint saved by either package loads in the
  other;
- the engine: greedy tokens are bit-identical with quality on and off,
  and each request's ``quality`` is within 1e-4 of the JAX engine's on
  the same greedy traffic (diff and control, and diff through the paged
  pool with n-gram speculation, where the verify's accept computes the
  tail). Sampled tokens are bit-identical on and off too, and a sampled
  request's mean entropy equals the port's own plain computation over
  the model's full forward (the port's draws are not ``jax.random``'s).
  ``quality_nan`` degrades to "no signal", and ``quality_drift`` trips a
  recorded fingerprint.
"""

from __future__ import annotations

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu.config import ModelConfig as JModelConfig
from differential_transformer_replication_tpu.config import ServingConfig as JServingConfig
from differential_transformer_replication_tpu.models import init_model as j_init_model
from differential_transformer_replication_tpu.models.decode import (
    quality_vector as j_quality_vector,
)
from differential_transformer_replication_tpu.obs import quality as jq
from differential_transformer_replication_tpu.serving.engine import (
    ServingEngine as JServingEngine,
)
from differential_transformer_replication_tpu_torch.config import (
    ModelConfig,
    ServingConfig,
)
from differential_transformer_replication_tpu_torch.models import model_forward
from differential_transformer_replication_tpu_torch.models.decode import quality_vector
from differential_transformer_replication_tpu_torch.obs import quality as tq
from differential_transformer_replication_tpu_torch.params import params_from_jax
from differential_transformer_replication_tpu_torch.serving.engine import ServingEngine
from differential_transformer_replication_tpu_torch.utils import faults

SMALL = dict(vocab_size=61, n_embd=32, n_head=2, n_layer=2, block_size=32,
             dropout=0.0, n_terms=3, compute_dtype="float32")
POOL = dict(num_slots=2, prefill_chunk=4, prefill_budget=6)


@pytest.fixture(autouse=True)
def _disarm():
    faults.reset()
    yield
    faults.reset()


# -- the function --------------------------------------------------------


def _logits(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[1] = -np.inf                       # fully masked row
    flat[2, :] = -np.inf
    flat[2, 7] = 1.5                        # one finite logit: margin inf
    flat[3, 10:] = -np.inf                  # a top-k-like mask
    flat[4, :2] = flat[4].max() + 1.0       # a tie at the top
    return x


@pytest.mark.parametrize("shape", [(6, 61), (3, 5, 61)], ids=["2d", "3d-verify"])
@pytest.mark.parametrize("temp", [1.0, 0.7])
@pytest.mark.parametrize("with_top2", [False, True])
def test_quality_vector_matches_jax(shape, temp, with_top2):
    proc = _logits(shape, seed=len(shape))
    lp = jax.nn.log_softmax(jnp.asarray(proc) / temp, axis=-1)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 4, shape[:-1]).astype(np.int32)
    prev = rng.integers(-1, 4, shape[:-1]).astype(np.int32)
    top2 = -np.sort(-proc, axis=-1)[..., :2] if with_top2 else None
    want = np.asarray(j_quality_vector(
        lp, jnp.asarray(proc), jnp.asarray(tokens), jnp.asarray(prev),
        top2=None if top2 is None else jnp.asarray(top2)))
    got = quality_vector(
        torch.log_softmax(torch.from_numpy(proc) / temp, dim=-1),
        torch.from_numpy(proc), torch.from_numpy(tokens), torch.from_numpy(prev),
        top2=None if top2 is None else torch.from_numpy(top2)).numpy()
    assert got.shape == want.shape == shape[:-1] + (3,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    flat = got.reshape(-1, 3)
    assert flat[1, 0] == 0.0 and not math.isfinite(flat[1, 1])
    assert flat[2, 0] == 0.0 and flat[2, 1] == math.inf
    assert flat[4, 1] == 0.0


# -- the sketches, PSI and the fingerprint ---------------------------------


def _fill(mod, seed, n=300, shift=0.0):
    mon = mod.QualityMonitor()
    rng = np.random.default_rng(seed)
    for e, m in zip(rng.gamma(2.0, 0.7, n) + shift, rng.gamma(1.5, 1.2, n)):
        mon.observe(float(e), float(m))
    mon.observe(float("nan"), float("inf"))  # "no signal"
    return mon


@pytest.mark.parametrize("shift", [0.0, 0.8])
def test_sketch_psi_and_drift_match_jax(shift):
    jref, tref = _fill(jq, 1), _fill(tq, 1)
    assert tref.stats() == jref.stats()
    assert tref.fingerprint(meta={"m": 1}) == jref.fingerprint(meta={"m": 1})
    jmon = jq.QualityMonitor(reference=jref.fingerprint())
    tmon = tq.QualityMonitor(reference=tref.fingerprint())
    rng = np.random.default_rng(9)
    for e, m in zip(rng.gamma(2.0, 0.7, 200) + shift, rng.gamma(1.5, 1.2, 200)):
        jmon.observe(float(e), float(m))
        tmon.observe(float(e), float(m))
    assert tmon.drift() == jmon.drift()
    assert (tmon.drift() > 0.25) == (shift > 0)
    for key, bins in (("entropy", "ENTROPY_BINS"), ("margin", "MARGIN_BINS")):
        assert getattr(tq, bins) == getattr(jq, bins)
        a = jq.QuantileSketch(getattr(jq, bins))
        b = tq.QuantileSketch(getattr(tq, bins))
        for v in rng.gamma(2.0, 0.7, 50):
            a.add(float(v))
            b.add(float(v))
        assert b.to_dict() == a.to_dict()
        assert tq.psi(b, getattr(tmon, key)) == jq.psi(a, getattr(jmon, key))
    lambdas = {"lambda_l1": 0.2, "lambda_l2": 0.35}
    assert tq.build_quality_row(tmon, 7, lambdas=lambdas) == \
        jq.build_quality_row(jmon, 7, lambdas=lambdas)


@pytest.mark.parametrize("writer,reader", [(jq, tq), (tq, jq)],
                         ids=["jax-to-port", "port-to-jax"])
def test_fingerprint_loads_in_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "fp.json")
    writer.save_fingerprint(path, _fill(writer, 4).fingerprint(meta={"model": "diff"}))
    rec = reader.load_fingerprint(path)
    assert rec == json.load(open(path))
    live = _fill(reader, 4)
    assert reader.QualityMonitor(reference=rec).drift() == 0.0  # thin evidence
    live.reference = rec  # the same traffic against its own record
    assert live.drift() == pytest.approx(0.0, abs=1e-12)


# -- the engine ------------------------------------------------------------


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


def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, SMALL["vocab_size"], size=n).tolist() for n in lens]


def _engine(tparams, tcfg, **kw):
    return ServingEngine(tparams, tcfg, ServingConfig(**{**POOL, **kw}),
                         device="cpu")


@pytest.fixture(scope="module")
def models():
    return {kind: _setup(kind) for kind in ("control", "diff")}


PAGED_SPEC = dict(kv_page_size=8, spec_mode="ngram", spec_draft_len=3)
MOTIF_PROMPTS = [[5, 9, 2] * 4, [7, 1] * 5 + [3], [11, 4, 4, 6] * 3]


@pytest.mark.parametrize("kind,extra", [("control", {}), ("diff", {}),
                                        ("diff", PAGED_SPEC)],
                         ids=["control", "diff", "diff-paged-spec"])
def test_greedy_quality_matches_jax_engine_and_tokens_do_not_move(models, kind, extra):
    jcfg, tcfg, jparams, tparams = models[kind]
    prompts = MOTIF_PROMPTS if extra else _prompts([3, 9, 14, 6])
    jeng = JServingEngine(jparams, jcfg, JServingConfig(
        **POOL, **extra, quality_telemetry=True))
    jouts = jeng.generate(prompts, max_new_tokens=8, temperature=0.0)
    on = _engine(tparams, tcfg, **extra, quality_telemetry=True)
    outs = on.generate(prompts, max_new_tokens=8, temperature=0.0)
    off = _engine(tparams, tcfg, **extra).generate(prompts, max_new_tokens=8,
                                                  temperature=0.0)
    assert [o.tokens for o in outs] == [o.tokens for o in off] == \
        [o.tokens for o in jouts]
    for o, j, f in zip(outs, jouts, off):
        assert f.quality is None
        assert set(o.quality) == set(j.quality)
        for key in ("tokens_observed", "rep_run_max"):
            assert o.quality[key] == j.quality[key]
        for key in ("entropy_mean", "margin_mean"):
            assert o.quality[key] == pytest.approx(j.quality[key], abs=1e-4)
    ts, js = on.quality_stats(), jeng.quality_stats()
    assert set(ts) == set(js)
    assert ts["tokens_observed"] == js["tokens_observed"] == 8 * len(prompts)
    for key in js:
        if key.startswith("lambda_l"):
            assert ts[key] == pytest.approx(js[key], abs=1e-5)
    if extra:
        assert on.stats["spec_accepted"] == jeng.stats["spec_accepted"] >= 1


def test_sampled_tokens_do_not_move_and_entropy_is_the_plain_one(models):
    _, tcfg, _, tparams = models["control"]
    prompts = _prompts([4, 7, 11], seed=8)
    kw = dict(max_new_tokens=6, temperature=0.8, top_k=5, seed=17)
    on = _engine(tparams, tcfg, quality_telemetry=True).generate(prompts, **kw)
    off = _engine(tparams, tcfg).generate(prompts, **kw)
    assert [o.tokens for o in on] == [o.tokens for o in off]
    with torch.no_grad():
        for p, o in zip(prompts, on):
            seq = torch.tensor([p + o.tokens[:-1]])
            logits = model_forward(tparams, seq, tcfg)[0][0, len(p) - 1:]
            kth = torch.topk(logits, 5, dim=-1).values[:, -1:]
            masked = torch.where(logits < kth, -torch.inf, logits)
            lp = torch.log_softmax(masked / 0.8, dim=-1)
            ent = -torch.where(torch.isfinite(lp), lp.exp() * lp, 0.0).sum(-1)
            assert o.quality["tokens_observed"] == 6
            assert o.quality["entropy_mean"] == pytest.approx(
                float(ent.mean()), abs=1e-4)
            top2 = torch.topk(logits, 2, dim=-1).values
            assert o.quality["margin_mean"] == pytest.approx(
                float((top2[:, 0] - top2[:, 1]).mean()), abs=1e-4)


def test_quality_nan_degrades_to_no_signal(models):
    _, tcfg, _, tparams = models["control"]
    prompts = _prompts([3, 6], seed=13)
    ref = _engine(tparams, tcfg).generate(prompts, max_new_tokens=6,
                                          temperature=0.0)
    faults.arm("quality_nan@1")
    eng = _engine(tparams, tcfg, quality_telemetry=True)
    outs = eng.generate(prompts, max_new_tokens=6, temperature=0.0)
    assert [o.tokens for o in outs] == [o.tokens for o in ref]
    assert all(o.finish_reason == "length" for o in outs)
    s = eng.quality_stats()
    assert s["no_signal_observations"] > 0
    assert s["drift"] == 0.0
    assert s["tokens_observed"] < 12


@pytest.mark.parametrize("kind", ["control", "diff"])
def test_quality_drift_trips_a_recorded_fingerprint(models, kind, tmp_path):
    _, tcfg, _, tparams = models[kind]
    prompts = _prompts([3, 9, 14, 6, 11, 7])
    clean = _engine(tparams, tcfg, quality_telemetry=True)
    ref = clean.generate(prompts, max_new_tokens=8, temperature=0.0)
    assert clean.quality_stats()["tokens_observed"] >= tq.MIN_DRIFT_COUNT
    fp = str(tmp_path / "fp.json")
    tq.save_fingerprint(fp, clean.quality_fingerprint(meta={"model": kind}))
    again = _engine(tparams, tcfg, quality_telemetry=True, quality_fingerprint=fp)
    again.generate(prompts, max_new_tokens=8, temperature=0.0)
    assert again.quality_stats()["drift"] == pytest.approx(0.0, abs=1e-9)
    faults.arm("quality_drift@1")
    eng = _engine(tparams, tcfg, quality_telemetry=True, quality_fingerprint=fp)
    outs = eng.generate(prompts, max_new_tokens=8, temperature=0.0)
    assert all(o.finish_reason == "length" for o in outs)
    s = eng.quality_stats()
    assert math.isfinite(s["drift"]) and s["drift"] > 0.25, s
    assert 'serving_quality_drift ' in eng.registry.render()
    if kind == "control":  # the lm-head rescale keeps the argmax
        assert [o.tokens for o in outs] == [o.tokens for o in ref]
    else:  # the lambda shift is the fault's visible gauge signature
        assert s["lambda_l1"] > 1.0
        assert 'serving_lambda_mean{layer="1"}' in eng.registry.render()
