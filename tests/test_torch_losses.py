"""The chunked lm-head loss of the port (``ops/losses.py:
fused_linear_cross_entropy``, ``ModelConfig.loss_chunk``) on the CPU.

- The function against JAX's ``fused_linear_cross_entropy``: a chunk
  that divides the positions and one that does not (JAX pads and masks
  the tail, the port runs a shorter one), with and without a bias, fp32
  and bf16; loss, ``dh``, ``dW`` and ``db``. fp32 within 1e-5 (the same
  math, sums in another order); bf16 within one bf16 step (2^-7) of the
  largest value, since XLA and PyTorch round the bf16 products apart.
- The models, as JAX's ``tests/test_losses.py`` holds its own: the
  chunked loss equals the dense loss for the three families, the logits
  come back as None (and without targets as logits), three train steps
  equal the dense steps; and a chunked train step equals JAX's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu.config import (
    ModelConfig as JModelConfig,
    TrainConfig as JTrainConfig,
)
from differential_transformer_replication_tpu.ops.losses import (
    fused_linear_cross_entropy as j_fused_ce,
)
from differential_transformer_replication_tpu.train.step import (
    create_train_state as j_create_train_state,
    make_train_step as j_make_train_step,
)
from differential_transformer_replication_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
)
from differential_transformer_replication_tpu_torch.models import (
    init_model,
    model_forward,
)
from differential_transformer_replication_tpu_torch.ops.losses import (
    dense_linear_cross_entropy,
    fused_linear_cross_entropy,
)
from differential_transformer_replication_tpu_torch.params import train_state_from_jax
from differential_transformer_replication_tpu_torch.train.step import (
    create_train_state,
    make_train_step,
)

FP32_TOL = 1e-5
SMALL = dict(vocab_size=64, n_embd=32, n_head=2, n_layer=2, block_size=16,
             n_terms=3, compute_dtype="float32")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(ref, got, bf16, what):
    ref, got = _np(ref), _np(got)
    tol = 2.0 ** -7 * float(np.max(np.abs(ref))) if bf16 else FP32_TOL
    err = float(np.max(np.abs(ref - got)))
    assert err <= tol, f"{what}: {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("chunk", [8, 7], ids=["divides", "tail"])
@pytest.mark.parametrize("jdt,tdt", [("float32", torch.float32),
                                     ("bfloat16", torch.bfloat16)],
                         ids=["fp32", "bf16"])
def test_fused_linear_cross_entropy_matches_jax(jdt, tdt, chunk, bias):
    rng = np.random.default_rng(11)
    Bn, T, E, V = 2, 12, 32, 48
    h = rng.standard_normal((Bn, T, E)).astype(np.float32)
    w = (0.2 * rng.standard_normal((E, V))).astype(np.float32)
    b = (0.1 * rng.standard_normal((V,))).astype(np.float32)
    t = rng.integers(0, V, (Bn, T))

    def jloss(h_, w_, b_):
        return j_fused_ce(h_, w_, b_ if bias else None, jnp.asarray(t), chunk)

    jl, (jdh, jdw, jdb) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(h).astype(jdt), jnp.asarray(w), jnp.asarray(b))
    th = torch.from_numpy(h).to(tdt).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True) if bias else None
    loss = fused_linear_cross_entropy(th, tw, tb, torch.from_numpy(t), chunk)
    loss.backward()
    bf16 = tdt == torch.bfloat16
    assert loss.dtype == torch.float32 and th.grad.dtype == tdt
    _close(jl, loss, bf16, "loss")
    _close(jdh, th.grad, bf16, "dh")
    _close(jdw, tw.grad, bf16, "dW")
    if bias:
        _close(jdb, tb.grad, bf16, "db")


def test_fused_loss_divides_by_n_total_and_equals_the_dense_loss():
    rng = np.random.default_rng(12)
    h = torch.from_numpy(rng.standard_normal((3, 10, 16)).astype(np.float32))
    w = torch.from_numpy((0.3 * rng.standard_normal((16, 40))).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal((40,))).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 40, (3, 10)))
    dense, _ = dense_linear_cross_entropy(h, w, b, t)
    for chunk in (1, 4, 30, 64):
        got = fused_linear_cross_entropy(h, w, b, t, chunk)
        assert abs(float(got) - float(dense)) <= FP32_TOL, chunk
        # a shard's share of a mean over 4x the tokens (the ring)
        share = fused_linear_cross_entropy(h, w, b, t, chunk, n_total=120)
        assert abs(float(share) * 4 - float(dense)) <= FP32_TOL, chunk


def _model(family):
    cfg = ModelConfig(model=family, **SMALL)
    g = torch.Generator()
    g.manual_seed(0)
    return cfg, init_model(g, cfg)


@pytest.mark.parametrize("family", ["control", "diff", "ndiff"])
def test_model_chunked_loss_matches_dense(family):
    cfg, params = _model(family)
    g = torch.Generator()
    g.manual_seed(1)
    x = torch.randint(0, SMALL["vocab_size"], (3, 16), generator=g)
    y = torch.roll(x, -1, -1)
    logits, ref = model_forward(params, x, cfg, targets=y)
    assert logits is not None
    chunked = cfg.replace(loss_chunk=8)
    logits_f, got = model_forward(params, x, chunked, targets=y)
    assert logits_f is None
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    # no targets: the logits, as the generators take them
    logits2, loss2 = model_forward(params, x, chunked)
    assert loss2 is None and logits2.shape == (3, 16, SMALL["vocab_size"])


def _train_cfg(loss_chunk=None):
    return TrainConfig(model=ModelConfig(model="diff", loss_chunk=loss_chunk, **SMALL),
                       vocab_size=SMALL["vocab_size"], micro_batch_size=4,
                       learning_rate=1e-2, warmup_iters=0, max_iters=100,
                       sampler="replacement")


def test_train_steps_with_the_chunked_loss_match_dense_steps():
    base, fused = _train_cfg(), _train_cfg(loss_chunk=8)
    g = torch.Generator()
    g.manual_seed(1)
    x = torch.randint(0, SMALL["vocab_size"], (1, 4, 16), generator=g)
    batch = {"x": x, "y": torch.roll(x, -1, -1)}
    states = []
    for cfg in (base, fused):
        g0 = torch.Generator()
        g0.manual_seed(0)
        states.append(create_train_state(g0, cfg, "cpu"))
    s_d, s_f = states
    step_d, step_f = make_train_step(base), make_train_step(fused)
    for _ in range(3):
        s_d, m_d = step_d(s_d, batch)
        s_f, m_f = step_f(s_f, batch)
        np.testing.assert_allclose(m_f["loss"], m_d["loss"], rtol=1e-5)
    for a, c in zip(jax.tree_util.tree_leaves(_np_tree(s_d["params"])),
                    jax.tree_util.tree_leaves(_np_tree(s_f["params"]))):
        np.testing.assert_allclose(c, a, atol=5e-5)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return _np(tree)


def test_chunked_train_step_matches_jax():
    common = dict(micro_batch_size=4, max_iters=100, learning_rate=1e-2,
                  warmup_iters=0, vocab_size=SMALL["vocab_size"])
    jcfg = JTrainConfig(model=JModelConfig(model="diff", loss_chunk=24, **SMALL),
                        **common)
    cfg = TrainConfig(model=ModelConfig(model="diff", loss_chunk=24, **SMALL),
                      sampler="replacement", **common)
    jstate = j_create_train_state(jax.random.PRNGKey(3), jcfg)
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                 cfg.resolved_model())
    x = np.random.default_rng(4).integers(0, SMALL["vocab_size"], (1, 4, 16))
    jbatch = {"x": jnp.asarray(x), "y": jnp.roll(jnp.asarray(x), -1, -1)}
    batch = {"x": torch.from_numpy(x), "y": torch.roll(torch.from_numpy(x), -1, -1)}
    jstate, jm = j_make_train_step(jcfg)(jstate, jbatch)
    state, m = make_train_step(cfg)(state, batch)
    assert abs(float(jm["loss"]) - m["loss"]) <= FP32_TOL
    assert abs(float(jm["grad_norm"]) - m["grad_norm"]) <= 1e-4 * float(jm["grad_norm"])
