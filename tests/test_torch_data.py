"""The port's data against the JAX package's, on the CPU: the epoch
sampler, and the corpus -> tokenizer -> token stream cache.

``data/native.py`` of the port keeps the numpy Feistel permutation of the
JAX package's ``data/native.py`` (which calls the C++ library when it
builds and the same numpy code when it does not: the two are
bit-identical by design). Both ``permute_indices`` and
``EpochPermutation.take`` must give the same indices bit for bit, across
epoch boundaries, and the port's trainer must draw the windows the JAX
trainer's epoch branch draws from the same consumed-window count.

``build_data`` from a corpus must name the same ``cache-<key>`` directory
as the JAX package's and write the same ``tokens.npy`` and tokenizer
files, and a cache written by either package must load in the other.
The trainer run from ``--dataset`` records the tokenizer's fingerprint
in every checkpoint, and a resume whose tokenizer has the checkpoint's
vocabulary size but other content is refused with the JAX message.
"""

from __future__ import annotations

import json
import sys

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


# ---------------------------------------------------------------------------
# the corpus -> tokenizer -> token stream cache (build_data's miss branch)
# ---------------------------------------------------------------------------


def _data_cfgs(tmp_path, dataset="synthetic", n=300):
    from differential_transformer_replication_tpu.config import (
        ModelConfig as JModelConfig,
    )
    from differential_transformer_replication_tpu.config import (
        TrainConfig as JTrainConfig,
    )

    tiny = dict(model="diff", n_embd=16, n_head=2, n_layer=1, block_size=16)
    common = dict(dataset=dataset, num_train_samples=n, seed=7,
                  tokenizer_dir=str(tmp_path / "tok"))
    return (JTrainConfig(model=JModelConfig(**tiny), **common),
            TrainConfig(model=ModelConfig(**tiny), **common))


def _cache_entry(tmp_path):
    (entry,) = [p for p in (tmp_path / "tok").iterdir() if p.name.startswith("cache-")]
    return entry


@pytest.mark.parametrize("first", ["jax", "port"])
def test_build_data_cache_equals_jax_and_loads_across(tmp_path, capsys, first):
    from differential_transformer_replication_tpu.train.trainer import (
        build_data as j_build_data,
    )
    from differential_transformer_replication_tpu_torch.data.tokenizer import (
        tokenizer_fingerprint,
    )
    from differential_transformer_replication_tpu_torch.train import trainer

    jcfg, pcfg = _data_cfgs(tmp_path / "a")
    _, fresh = _data_cfgs(tmp_path / "b")  # the port alone, a miss
    if first == "jax":
        jtok_, jvocab, _, _ = j_build_data(jcfg)
        capsys.readouterr()
        tok, vocab, train_ds, val_ds = trainer.build_data(pcfg, None, "cpu")
        assert "Loaded" in capsys.readouterr().out  # a hit on JAX's entry
    else:
        tok, vocab, train_ds, val_ds = trainer.build_data(pcfg, None, "cpu")
        capsys.readouterr()
        jtok_, jvocab, _, _ = j_build_data(jcfg)
        assert "Loaded" in capsys.readouterr().out  # a hit on the port's entry
    ftok, fvocab, _, _ = trainer.build_data(fresh, None, "cpu")
    assert "cache miss" in capsys.readouterr().out
    entry, fentry = _cache_entry(tmp_path / "a"), _cache_entry(tmp_path / "b")
    assert entry.name == fentry.name
    assert sorted(p.name for p in entry.iterdir()) == \
        sorted(p.name for p in fentry.iterdir()) == ["merges.txt", "tokens.npy",
                                                       "vocab.json"]
    for name in ("merges.txt", "tokens.npy", "vocab.json"):
        assert (entry / name).read_bytes() == (fentry / name).read_bytes(), name
        # the tokenizer also lands in tokenizer_dir itself
        if name != "tokens.npy":
            assert (tmp_path / "b" / "tok" / name).read_bytes() == \
                (entry / name).read_bytes()
    assert vocab == jvocab == fvocab == tok.get_vocab_size()
    assert tokenizer_fingerprint(tok) == tokenizer_fingerprint(ftok)
    tokens = np.load(entry / "tokens.npy")
    n = int(0.9 * len(tokens))
    assert torch.equal(train_ds.tokens.cpu(), torch.from_numpy(tokens[:n]).to(
        train_ds.tokens.dtype))
    assert len(val_ds) == len(tokens) - n - pcfg.model.block_size


@pytest.mark.parametrize("dataset", ["file", "tinystories"])
def test_cache_key_of_a_file_and_of_the_tinystories_fallback_equal_jax(
        tmp_path, monkeypatch, dataset):
    """A text file keys on its path, mtime and size; ``tinystories`` whose
    ``datasets`` load fails falls back to synthetic and keys on that."""
    import types

    from differential_transformer_replication_tpu.train.trainer import (
        build_data as j_build_data,
    )
    from differential_transformer_replication_tpu_torch.data.corpus import (
        synthetic_corpus,
    )
    from differential_transformer_replication_tpu_torch.train import trainer

    if dataset == "file":
        path = tmp_path / "corpus.txt"
        path.write_text("\n".join(synthetic_corpus(150, seed=2)) + "\n")
        name = str(path)
    else:
        stub = types.ModuleType("datasets")

        def load_dataset(*a, **k):
            raise ConnectionError("no network")

        stub.load_dataset = load_dataset
        monkeypatch.setitem(sys.modules, "datasets", stub)
        name = "tinystories"
    jcfg, pcfg = _data_cfgs(tmp_path / "j", dataset=name, n=150)
    _, pcfg_b = _data_cfgs(tmp_path / "p", dataset=name, n=150)
    j_build_data(jcfg)
    trainer.build_data(pcfg_b, None, "cpu")
    je, pe = _cache_entry(tmp_path / "j"), _cache_entry(tmp_path / "p")
    assert je.name == pe.name
    source = str(path) if dataset == "file" else "synthetic"
    assert je.name == f"cache-{trainer._cache_key(pcfg_b, source)}"
    assert (je / "tokens.npy").read_bytes() == (pe / "tokens.npy").read_bytes()


def test_trainer_from_the_corpus_records_the_fingerprint_and_refuses_another(
        tmp_path, capsys):
    """``--dataset`` with no ``--tokens``: every checkpoint (best, last,
    step) records the tokenizer's fingerprint, JAX's for the same files;
    a resume whose cache holds a tokenizer of the same size and other
    content exits with JAX's message; with its own it resumes."""
    import shutil

    from differential_transformer_replication_tpu.data import tokenizer as jtok
    from differential_transformer_replication_tpu_torch.data import tokenizer as ptok
    from differential_transformer_replication_tpu_torch.data.corpus import (
        synthetic_corpus,
    )
    from differential_transformer_replication_tpu_torch.train import __main__ as cli

    argv = ["--model", "diff", "--dataset", "synthetic", "--num-train-samples",
            "200", "--tokenizer-dir", str(tmp_path / "tok"), "--device", "cpu",
            "--n-embd", "16", "--n-head", "2", "--n-layer", "1",
            "--block-size", "16", "--micro-batch-size", "4",
            "--eval-interval", "3", "--eval-iters", "1", "--log-interval", "3",
            "--warmup-iters", "1", "--compute-dtype", "float32",
            "--checkpoint-path", str(tmp_path / "run" / "best.ckpt"),
            "--ckpt-interval", "3", "--no-ckpt-async", "--metrics-path", ""]
    state, _ = cli.run([*argv, "--max-iters", "6"])
    assert "cache miss" in capsys.readouterr().out
    entry = _cache_entry(tmp_path)
    fp = jtok.tokenizer_fingerprint(jtok.load_tokenizer(str(entry)))
    run = tmp_path / "run"
    metas = [run / "best.ckpt", run / "best.last.ckpt",
             run / "best.steps" / "step-00000003", run / "best.steps" / "step-00000006"]
    for m in metas:
        meta = json.loads((m / "meta.json").read_text())
        assert meta["tokenizer_fingerprint"] == fp, m
        assert meta["config"]["vocab_size"] == state["params"]["tok_emb"].shape[0]
    # a same-size tokenizer of other content in the cache entry
    keep = tmp_path / "keep"
    shutil.copytree(entry, keep)
    other = ptok.train_bpe_tokenizer(synthetic_corpus(200, seed=11), 12000, 2, None)
    assert other.get_vocab_size() == ptok.load_tokenizer(str(entry)).get_vocab_size()
    other.save_model(str(entry))
    step6 = str(run / "best.steps" / "step-00000006")
    with pytest.raises(SystemExit) as want:
        jtok.check_tokenizer_matches(jtok.load_tokenizer(str(entry)),
                                     other.get_vocab_size(), fp, context=step6)
    with pytest.raises(SystemExit) as got:
        cli.run([*argv, "--max-iters", "9", "--resume-from", "auto"])
    assert str(got.value) == str(want.value) and "fingerprint" in str(got.value)
    for name in ("vocab.json", "merges.txt"):
        shutil.copy(keep / name, entry / name)
    capsys.readouterr()
    state, _ = cli.run([*argv, "--max-iters", "9", "--resume-from", "auto"])
    out = capsys.readouterr().out
    assert "cache hit" in out and f"resuming from {step6}" in out
    assert state["step"] == 9


def test_data_bench_reads_the_trainers_data_lines(tmp_path, capsys):
    """``data/bench.py`` parses the seconds out of the ``[data]`` lines
    that ``corpus_tokens`` prints, so the two stay in step; its stream is
    the default config's at that corpus size, and ``--dir`` is removed."""
    from differential_transformer_replication_tpu_torch.data import bench
    from differential_transformer_replication_tpu_torch.data.corpus import (
        synthetic_corpus,
    )
    from differential_transformer_replication_tpu_torch.data.tokenizer import (
        encode_corpus,
        train_bpe_tokenizer,
    )

    d = tmp_path / "bench"
    assert bench.main(["--docs", "60", "--dir", str(d)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    texts = synthetic_corpus(60, 1337)
    tok = train_bpe_tokenizer(texts, 12000, 2, None)
    assert out["tokens"] == len(encode_corpus(tok, texts))
    assert out["vocab"] == tok.get_vocab_size() and out["docs"] == 60
    for key in ("corpus_s", "bpe_train_s", "encode_s", "cache_write_s", "hit_load_s"):
        assert out[key] >= 0, key
    assert out["encode_tokens_per_s"] > 0 and not d.exists()
