"""The port's epoch sampler against the JAX package's, on the CPU.

``data/native.py`` of the port keeps the numpy Feistel permutation of the
JAX package's ``data/native.py`` (which calls the C++ library when it
builds and the same numpy code when it does not: the two are
bit-identical by design). Both ``permute_indices`` and
``EpochPermutation.take`` must give the same indices bit for bit, across
epoch boundaries, and the port's trainer must draw the windows the JAX
trainer's epoch branch draws from the same consumed-window count.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu.data import native as jnative
from differential_transformer_replication_tpu.data.sampler import (
    TokenWindows as JTokenWindows,
)
from differential_transformer_replication_tpu.data.sampler import (
    split_tokens as j_split_tokens,
)
from differential_transformer_replication_tpu_torch.config import ModelConfig, TrainConfig
from differential_transformer_replication_tpu_torch.data import native


@pytest.mark.parametrize("n", [1, 7, 1000, 2**20 + 3])
@pytest.mark.parametrize("seed", [0, 1337, 2**40 + 5])
def test_permute_indices_equal_jax(n, seed):
    starts = sorted({0, n // 3, max(n - 5000, 0)})
    for start in starts:
        count = min(5000, n - start)
        got = native.permute_indices(n, seed, start, count)
        want = jnative.permute_indices(n, seed, start, count)
        assert got.dtype == np.int64 and np.array_equal(got, want)
    if n <= 1000:  # the whole permutation: every index once
        full = native.permute_indices(n, seed, 0, n)
        assert np.array_equal(np.sort(full), np.arange(n))
    assert native.permute_indices(n, seed, 0, 0).shape == (0,)
    with pytest.raises(ValueError, match="exceeds domain"):
        native.permute_indices(n, seed, n, 1)


@pytest.mark.parametrize("n,takes", [(7, [3, 5, 9, 1, 14]),
                                     (1000, [256, 700, 333, 1000, 12]),
                                     (2**20 + 3, [4096, 8192])])
def test_epoch_permutation_take_equals_jax_across_epochs(n, takes):
    got, want = native.EpochPermutation(n, 11), jnative.EpochPermutation(n, 11)
    for count in takes:
        a, b = got.take(count), want.take(count)
        assert np.array_equal(a, b)
        assert (got.epoch, got.cursor) == (want.epoch, want.cursor)
    if n == 7:
        assert got.epoch >= 4  # rolled several epochs
        # each epoch is a permutation, and a fresh one
        p = native.EpochPermutation(n, 11)
        e0, e1 = p.take(n), p.take(n)
        assert sorted(e0) == sorted(e1) == list(range(n))
        assert not np.array_equal(e0, e1)
    # a fast-forward by divmod lands where streaming would have
    total = sum(takes)
    ff = native.EpochPermutation(n, 11)
    ff.epoch, ff.cursor = divmod(total, n)
    jnext = want.take(17)
    assert np.array_equal(ff.take(17), jnext)


def _record_draws(monkeypatch, trainer):
    """Swap the trainer's step for one that records each batch's x and
    advances the state without computing: the draws are the subject."""
    seen = []

    def fake_make_train_step(cfg, group=None):
        def step(state, batch, seed=None):
            seen.append(batch["x"].clone())
            state["step"] += 1
            state["opt_state"]["count"] += 1
            return state, {"loss": 1.0, "learning_rate": 0.0, "skipped": 0}
        return step

    monkeypatch.setattr(trainer, "make_train_step", fake_make_train_step)
    return seen


def _jax_draws(tokens, cfg, consumed, steps):
    """The JAX trainer's epoch branch (train/trainer.py): the permutation
    of the training windows, fast-forwarded to ``consumed`` windows, then
    ``grad_acc_steps * micro_batch_size`` offsets a step, shaped (A, B)."""
    train_tokens, _ = j_split_tokens(tokens, cfg.val_fraction)
    ds = JTokenWindows(train_tokens, cfg.model.block_size)
    perm = jnative.EpochPermutation(len(ds), cfg.seed)
    perm.epoch, perm.cursor = divmod(consumed, len(ds))
    A, B = cfg.grad_acc_steps, cfg.micro_batch_size
    return [np.asarray(ds.batches(perm.take(A * B).reshape(A, B))["x"])
            for _ in range(steps)], len(ds)


@pytest.mark.parametrize("grad_acc,micro", [(1, 8), (2, 3)])
def test_trainer_epoch_draws_equal_jax(monkeypatch, tmp_path, grad_acc, micro):
    from differential_transformer_replication_tpu_torch.train import trainer

    tokens = np.random.default_rng(3).integers(0, 64, 200).astype(np.int32)
    np.save(tmp_path / "t.npy", tokens)
    cfg = TrainConfig(
        model=ModelConfig(model="diff", vocab_size=64, n_embd=16, n_head=2,
                          n_layer=1, block_size=16, compute_dtype="float32"),
        vocab_size=64, micro_batch_size=micro, grad_acc_steps=grad_acc,
        max_iters=60, eval_interval=1000, log_interval=1000, seed=5,
        sampler="epoch", metrics_path=None,
        checkpoint_path=str(tmp_path / "best.ckpt"), last_checkpoint_path=None)
    seen = _record_draws(monkeypatch, trainer)
    state, _ = trainer.train(cfg, str(tmp_path / "t.npy"), device="cpu")
    want, n_windows = _jax_draws(tokens, cfg, 0, 60)
    assert 60 * grad_acc * micro > 2 * n_windows  # crosses epoch boundaries
    assert len(seen) == 60 and state["step"] == 60
    for i, (t, j) in enumerate(zip(seen, want)):
        assert t.dtype == torch.int64 and np.array_equal(t.numpy(), j), i


def test_trainer_fast_forward_equals_jax_from_consumed_windows(monkeypatch,
                                                               tmp_path):
    """A resumed run draws on from the checkpoint's consumed windows: a
    step-9 checkpoint of a micro-batch-4 run resumed at micro-batch 6
    (36 windows consumed, 6 steps of 6) continues the permutation where
    the JAX trainer's fast-forward puts it."""
    from differential_transformer_replication_tpu_torch.train import trainer

    tokens = np.random.default_rng(4).integers(0, 64, 300).astype(np.int32)
    np.save(tmp_path / "t.npy", tokens)
    model = ModelConfig(model="control", vocab_size=64, n_embd=16, n_head=2,
                        n_layer=1, block_size=16, compute_dtype="float32")
    common = dict(model=model, vocab_size=64, eval_interval=1000,
                  log_interval=1000, seed=9, metrics_path=None,
                  checkpoint_path=str(tmp_path / "best.ckpt"),
                  ckpt_interval=9, ckpt_async=False)
    first = TrainConfig(micro_batch_size=4, max_iters=9, **common)
    _record_draws(monkeypatch, trainer)
    trainer.train(first, str(tmp_path / "t.npy"), device="cpu")
    seen = _record_draws(monkeypatch, trainer)
    resumed = TrainConfig(micro_batch_size=6, max_iters=20, resume_from="auto",
                          **common)
    state, _ = trainer.train(resumed, str(tmp_path / "t.npy"), device="cpu")
    # the step count carries over; the windows go on from 36 consumed
    want, _ = _jax_draws(tokens, resumed, 36, 11)
    assert state["step"] == 20 and len(seen) == 11
    for t, j in zip(seen, want):
        assert np.array_equal(t.numpy(), j)
