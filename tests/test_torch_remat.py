"""Remat in the port (``models/common.py:remat_block``) on the CPU.

- Against the JAX package: loss and every param gradient of a 2-layer
  diff model (width 32, T 16, fp32, dropout 0) under each of the five
  ``remat_policy`` values, both sides rematerialized, within the
  tolerances of JAX's own ``tests/test_remat.py`` (rtol 1e-5, atol
  1e-6).
- Against the port unremat, bit for bit: control, diff and ndiff at
  dropout 0.1 (the head-major route, attention, residual and FFN masks
  redrawn in the recompute), each policy.
- What stays saved: under ``nothing`` the tensors that
  ``saved_tensors_hooks`` sees outside the blocks plus the block inputs
  the checkpoint keeps are under a third of the unremat forward's
  saved bytes.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu.config import ModelConfig as JModelConfig
from differential_transformer_replication_tpu.models import (
    init_model as j_init_model,
    model_forward as j_model_forward,
)
from differential_transformer_replication_tpu_torch.config import (
    REMAT_POLICIES,
    ModelConfig,
)
from differential_transformer_replication_tpu_torch.models import model_forward
from differential_transformer_replication_tpu_torch.models import common
from differential_transformer_replication_tpu_torch.params import params_from_jax
from differential_transformer_replication_tpu_torch.train.optim import leaves

TINY = dict(vocab_size=61, n_embd=32, n_head=2, n_layer=2, block_size=16,
            n_terms=2, compute_dtype="float32")
B, T = 2, 16


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, TINY["vocab_size"], (B, T)),
            rng.integers(0, TINY["vocab_size"], (B, T)))


def _port_params(kind, dropout=0.0, key=0):
    jcfg = JModelConfig(model=kind, dropout=dropout, **TINY)
    jparams = j_init_model(jax.random.PRNGKey(key), jcfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams)
    params = params_from_jax(tree, ModelConfig(model=kind, dropout=dropout, **TINY))
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    return jparams, params


def _loss_and_grads(params, cfg, idx, tgt, seed=None):
    _, loss = model_forward(params, torch.as_tensor(idx), cfg,
                            targets=torch.as_tensor(tgt), seed=seed)
    return loss.detach(), torch.autograd.grad(loss, leaves(params))


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_model_config_takes_each_policy(policy):
    from differential_transformer_replication_tpu_torch.config import TrainConfig

    cfg = TrainConfig(model=ModelConfig(remat=True, remat_policy=policy),
                      sampler="replacement").resolved_model()
    assert cfg.remat and cfg.remat_policy == policy
    assert ModelConfig(remat_policy=policy).remat is False
    with pytest.raises(ValueError, match="remat_policy must be one of"):
        ModelConfig(remat=True, remat_policy=policy + "_x")


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_remat_loss_and_grads_match_jax(policy):
    jcfg = JModelConfig(model="diff", remat=True, remat_policy=policy, **TINY)
    cfg = ModelConfig(model="diff", remat=True, remat_policy=policy, **TINY)
    jparams, params = _port_params("diff")
    idx, tgt = _inputs(1)

    def jloss(p):
        return j_model_forward(p, jnp.asarray(idx), jcfg, targets=jnp.asarray(tgt))[1]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    loss, grads = _loss_and_grads(params, cfg, idx, tgt)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-6)
    jleaves = leaves(params_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jg), cfg))
    assert len(jleaves) == len(grads)
    for ref, got in zip(jleaves, grads):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("policy", REMAT_POLICIES)
@pytest.mark.parametrize("kind", ["control", "diff", "ndiff"])
def test_remat_is_bit_equal_to_unremat_under_dropout(kind, policy):
    cfg = ModelConfig(model=kind, dropout=0.1, **TINY)
    _, params = _port_params(kind, 0.1)
    idx, tgt = _inputs(2)
    l0, g0 = _loss_and_grads(params, cfg, idx, tgt, seed=77)
    l1, g1 = _loss_and_grads(params, cfg.replace(remat=True, remat_policy=policy),
                             idx, tgt, seed=77)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    # a third seed draws other masks: the equality above is not vacuous
    l2, _ = _loss_and_grads(params, cfg, idx, tgt, seed=78)
    assert not torch.equal(l0, l2)


def _saved_bytes(params, cfg, idx, tgt):
    """Bytes of the distinct non-param tensors the forward saves for the
    backward, as ``saved_tensors_hooks`` sees them, and the block inputs
    (each block's ``x``)."""
    param_ids = {id(p) for p in leaves(params)}
    seen, inputs = {}, []

    def pack(t):
        if id(t) not in param_ids:
            seen[(t.data_ptr(), tuple(t.shape), t.dtype)] = t.numel() * t.element_size()
        return t

    mod = importlib.import_module(
        f"differential_transformer_replication_tpu_torch.models.{cfg.model}")
    orig = mod.block_forward

    def spy(x, *args):
        inputs.append(x.numel() * x.element_size())
        return orig(x, *args)

    mod.block_forward = spy
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model_forward(params, torch.as_tensor(idx), cfg,
                          targets=torch.as_tensor(tgt), seed=5)
    finally:
        mod.block_forward = orig
    return sum(seen.values()), sum(inputs)


@pytest.mark.parametrize("kind", ["control", "diff", "ndiff"])
def test_remat_nothing_saves_under_a_third_of_the_unremat_bytes(kind):
    cfg = ModelConfig(model=kind, dropout=0.1, **TINY)
    _, params = _port_params(kind, 0.1)
    idx, tgt = _inputs(3)
    full, _ = _saved_bytes(params, cfg, idx, tgt)
    outside, inputs = _saved_bytes(params, cfg.replace(remat=True, remat_policy="nothing"),
                                   idx, tgt)
    assert inputs == TINY["n_layer"] * B * T * TINY["n_embd"] * 4
    assert outside + inputs < full / 3, (outside, inputs, full)


def test_remat_without_grad_runs_the_block_as_it_is():
    cfg = ModelConfig(model="diff", remat=True, remat_policy="nothing", **TINY)
    calls = []

    def block(x, *args):
        calls.append(torch.is_grad_enabled())
        return x.sin()

    fn = common.remat_block(block, cfg)
    x = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        assert torch.equal(fn(x), torch.ones(3).sin())
    y = fn(x)
    y.sum().backward()
    # with grad: the forward, then the recompute in the backward
    assert calls == [False, True, True]
    assert common.remat_block(block, cfg.replace(remat_policy="everything")) is block
