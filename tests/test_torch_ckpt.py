"""The port's checkpoints against the JAX package's, on the CPU.

The port writes ``state.msgpack`` with its own msgpack codec
(train/state_codec.py, no ``msgpack`` and no ``flax``): its bytes must
equal ``flax.serialization.to_bytes`` of the same train state, and it
must read what flax writes, chunked arrays included. Checkpoint
directories cross both ways (the JAX package loads and verifies the
port's, the port loads the JAX package's), a flipped byte raises a
``CheckpointError`` naming the file, an interrupted run resumed with
``--resume-from auto`` ends bit-equal to an uninterrupted one, and the
HTTP server on a checkpoint gives the JAX engine's greedy tokens. The
durability cases of tests/test_ckpt.py (atomic writes, manifests,
rotation and GC, the async writer, ``auto`` resolution) run here against
both packages' ``ckpt_writer``.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from differential_transformer_replication_tpu.config import ModelConfig as JModelConfig
from differential_transformer_replication_tpu.config import ServingConfig as JServingConfig
from differential_transformer_replication_tpu.config import TrainConfig as JTrainConfig
from differential_transformer_replication_tpu.serving.engine import (
    ServingEngine as JServingEngine,
)
from differential_transformer_replication_tpu.train import ckpt_writer as jcw
from differential_transformer_replication_tpu.train import checkpoint as jckpt
from differential_transformer_replication_tpu.train.step import (
    create_train_state as j_create_train_state,
)
from differential_transformer_replication_tpu.utils import faults as jfaults
from differential_transformer_replication_tpu_torch.config import ModelConfig, TrainConfig
from differential_transformer_replication_tpu_torch.params import (
    params_to_numpy,
    train_state_from_jax,
    train_state_to_jax,
)
from differential_transformer_replication_tpu_torch.train import checkpoint as ckpt
from differential_transformer_replication_tpu_torch.train import ckpt_writer as cw
from differential_transformer_replication_tpu_torch.train import state_codec
from differential_transformer_replication_tpu_torch.train.step import create_train_state
from differential_transformer_replication_tpu_torch.utils import faults as tfaults

REPO = Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=61, n_embd=32, n_head=2, n_layer=2, block_size=16,
            dropout=0.0, n_terms=3, compute_dtype="float32")
KINDS = ["control", "diff", "ndiff"]


def _cfgs(kind, **kw):
    return (JTrainConfig(model=JModelConfig(model=kind, **TINY), vocab_size=61,
                         **kw),
            TrainConfig(model=ModelConfig(model=kind, **TINY), vocab_size=61,
                        **kw))


def _jax_host_state(kind, seed=0):
    """A JAX train state on the host (jax.device_get: sorted dict keys,
    optax named tuples), guard dropped as the JAX checkpoint drops it,
    every float leaf filled from a seeded stream (moments included) and
    the step and both counts 3."""
    jcfg, cfg = _cfgs(kind)
    state = j_create_train_state(jax.random.PRNGKey(seed), jcfg)
    host = jax.device_get({k: v for k, v in state.items() if k != "guard"})
    rng = np.random.default_rng(seed + 100)

    def fill(x):
        x = np.asarray(x)
        if x.dtype.kind == "f":
            return rng.standard_normal(x.shape).astype(x.dtype)
        return np.asarray(3, x.dtype)

    return jcfg, cfg, jax.tree_util.tree_map(fill, host)


def _leaves_equal(a, b):
    fa = jax.tree_util.tree_leaves(a)
    fb = jax.tree_util.tree_leaves(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.shape == y.shape and np.array_equal(x, y)


def _port_state_equal(a, b):
    _leaves_equal(params_to_numpy(a["params"]), params_to_numpy(b["params"]))
    for m in ("mu", "nu"):
        _leaves_equal(params_to_numpy(a["opt_state"][m]),
                      params_to_numpy(b["opt_state"][m]))
    assert a["opt_state"]["count"] == b["opt_state"]["count"]
    assert a["step"] == b["step"]


# ---------------------------------------------------------------------------
# the codec: flax's bytes, both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_state_bytes_equal_flax_to_bytes(kind):
    _, cfg, host = _jax_host_state(kind)
    want = serialization.to_bytes(host)
    state = train_state_from_jax(host, cfg.resolved_model())
    got = state_codec.to_bytes(train_state_to_jax(state))
    assert got == want
    # and back: the port reads flax's bytes to the same tensors
    back = train_state_from_jax(
        state_codec.lists_from_index_maps(state_codec.from_bytes(want)),
        cfg.resolved_model())
    _port_state_equal(back, state)


def test_bf16_int32_scalar_and_edge_leaves_equal_flax():
    import jax.numpy as jnp

    w = np.asarray(jnp.arange(-40, 200, dtype=jnp.bfloat16).reshape(8, 30) / 7)
    tw = torch.arange(-40, 200, dtype=torch.bfloat16).reshape(8, 30) / 7
    tree = {"params": {"w": w, "b": np.zeros((0,), np.float32),
                       "h": np.float16(1.5) * np.ones((3,), np.float16),
                       "q": np.arange(-5, 5, dtype=np.int8)},
            "step": np.asarray(7, np.int32), "count": np.int32(9),
            "lr": np.float32(0.25), "blocks": [np.ones(4, np.float32)] * 2}
    port = dict(tree, params=dict(tree["params"], w=tw))
    want = serialization.to_bytes(tree)
    assert state_codec.to_bytes(port) == want
    back = state_codec.from_bytes(want)
    assert back["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["w"], tw)
    assert back["step"].dtype == np.int32 and back["step"].shape == ()
    assert back["count"] == np.int32(9) and type(back["count"]) is np.int32
    assert back["params"]["h"].dtype == np.float16
    assert state_codec.lists_from_index_maps(back)["blocks"][1].shape == (4,)


@pytest.mark.parametrize("kind", ["diff", "ndiff"])
def test_reads_flax_chunked_arrays(kind, monkeypatch):
    """flax splits arrays over MAX_CHUNK_SIZE bytes into a chunked map;
    lowered on the flax side only, every param leaf is chunked there."""
    _, cfg, host = _jax_host_state(kind)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 96)
    data = serialization.to_bytes(host)
    assert b"__msgpack_chunked_array__" in data
    tree = state_codec.lists_from_index_maps(state_codec.from_bytes(data))
    _leaves_equal(tree["params"], host["params"])
    got = train_state_from_jax(tree, cfg.resolved_model())
    _port_state_equal(got, train_state_from_jax(host, cfg.resolved_model()))
    # with the same limit the port chunks as flax does, byte for byte
    monkeypatch.setattr(state_codec, "MAX_CHUNK_SIZE", 96)
    assert state_codec.to_bytes(train_state_to_jax(got)) == data


def test_codec_refuses_what_flax_refuses():
    with pytest.raises(TypeError):
        state_codec.packb((1, 2))  # strict types: a tuple is no list
    with pytest.raises(ValueError, match="truncated"):
        state_codec.unpackb(state_codec.packb({"a": np.ones(3)})[:-2])
    with pytest.raises(ValueError, match="extra data"):
        state_codec.unpackb(state_codec.packb(1) + b"\x00")


# ---------------------------------------------------------------------------
# checkpoint directories across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_jax_checkpoint_dir_loads_in_the_port(kind, tmp_path):
    jcfg, cfg, host = _jax_host_state(kind)
    path = str(tmp_path / "j.ckpt")
    jckpt.save_checkpoint(path, host, 1.25, jcfg, consumed_windows=96)
    target = create_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    state, best = ckpt.load_checkpoint(path, cfg, target)
    assert best == 1.25 and "guard" in state  # a fresh guard re-attached
    _port_state_equal(state, train_state_from_jax(host, cfg.resolved_model()))
    params, model_cfg, meta = ckpt.load_params_for_inference(path)
    assert model_cfg == cfg.resolved_model() and meta["consumed_windows"] == 96
    _leaves_equal(params_to_numpy(params), host["params"])
    # the port's own save of the same state is the same bytes
    mine = str(tmp_path / "p.ckpt")
    ckpt.save_checkpoint(mine, state, 1.25, cfg, consumed_windows=96)
    assert (open(os.path.join(mine, "state.msgpack"), "rb").read()
            == open(os.path.join(path, "state.msgpack"), "rb").read())


@pytest.mark.parametrize("kind", KINDS)
def test_port_checkpoint_dir_loads_in_jax(kind, tmp_path):
    jcfg, cfg, host = _jax_host_state(kind, seed=3)
    state = train_state_from_jax(host, cfg.resolved_model())
    path = str(tmp_path / "p.ckpt")
    ckpt.save_checkpoint(path, state, 2.5, cfg, consumed_windows=48)
    manifest = jcw.verify_checkpoint(path)
    assert set(manifest["files"]) == {"state.msgpack", "meta.json"}
    assert manifest["step"] == 3 and manifest["config_hash"]
    meta = jckpt.read_meta(path)
    assert meta["config"] == jcfg.to_dict() and meta["iter_num"] == 3
    target = j_create_train_state(jax.random.PRNGKey(9), jcfg)
    jstate, best = jckpt.load_checkpoint(path, jcfg, target)
    assert best == 2.5
    _leaves_equal({k: v for k, v in jstate.items() if k != "guard"}, host)
    params, jmodel, _ = jckpt.load_params_for_inference(path)
    assert jmodel == jcfg.resolved_model()
    _leaves_equal(params, host["params"])


def test_flipped_byte_raises_checkpoint_error_naming_the_file(tmp_path):
    jcfg, cfg, host = _jax_host_state("diff")
    target = create_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    for writer in ("port", "jax"):
        path = str(tmp_path / f"{writer}.ckpt")
        if writer == "port":
            ckpt.save_checkpoint(path, train_state_from_jax(
                host, cfg.resolved_model()), 1.0, cfg)
        else:
            jckpt.save_checkpoint(path, host, 1.0, jcfg)
        sp = os.path.join(path, "state.msgpack")
        data = bytearray(open(sp, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(sp, "wb").write(bytes(data))
        for load in (lambda: ckpt.load_checkpoint(path, cfg, target),
                     lambda: ckpt.load_params_for_inference(path)):
            with pytest.raises(cw.CheckpointError, match="state.msgpack") as ei:
                load()
            assert "expected sha256" in str(ei.value)
        # without verification the codec still refuses a torn file
        open(sp, "wb").write(bytes(data[:-7]))
        with pytest.raises(cw.CheckpointError, match="state.msgpack"):
            ckpt.load_checkpoint(path, cfg, target, verify=False)


def test_wrong_model_checkpoint_raises_checkpoint_error(tmp_path):
    jcfg, _, host = _jax_host_state("diff")
    path = str(tmp_path / "j.ckpt")
    jckpt.save_checkpoint(path, host, 1.0, jcfg)
    other = TrainConfig(model=ModelConfig(model="diff", **{**TINY, "n_layer": 3}),
                        vocab_size=61)
    target = create_train_state(torch.Generator().manual_seed(0), other, "cpu")
    with pytest.raises(cw.CheckpointError, match="does not fit"):
        ckpt.load_checkpoint(path, other, target)
    # int8 weights load: every matmul weight quantized and dequantized,
    # the embeddings untouched; an unknown scheme is refused
    q, _, _ = ckpt.load_params_for_inference(path, quantize="int8")
    plain, _, _ = ckpt.load_params_for_inference(path)
    assert not torch.equal(q["lm_head"]["w"], plain["lm_head"]["w"])
    assert torch.equal(q["tok_emb"], plain["tok_emb"])
    with pytest.raises(ValueError, match="unsupported weight quantization"):
        ckpt.load_params_for_inference(path, quantize="int4")


@pytest.mark.parametrize("kind", KINDS)
def test_pretrained_dirs_cross_both_ways(kind, tmp_path):
    jcfg, cfg, host = _jax_host_state(kind)
    jm, pm = jcfg.resolved_model(), cfg.resolved_model()
    jckpt.save_pretrained(str(tmp_path / "j"), host["params"], jm)
    params, model_cfg = ckpt.from_pretrained(str(tmp_path / "j"))
    assert model_cfg == pm
    _leaves_equal(params_to_numpy(params), host["params"])
    ckpt.save_pretrained(str(tmp_path / "p"), params, model_cfg)
    assert (open(tmp_path / "p" / "params.msgpack", "rb").read()
            == open(tmp_path / "j" / "params.msgpack", "rb").read())
    jparams, jmodel = jckpt.from_pretrained(str(tmp_path / "p"))
    assert jmodel == jm
    _leaves_equal(jparams, host["params"])


# ---------------------------------------------------------------------------
# the trainer: resume after an interruption, elastic resume
# ---------------------------------------------------------------------------


def _tokens(tmp_path, n=1200, vocab=61, seed=0):
    np.save(tmp_path / "t.npy",
            np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32))
    return str(tmp_path / "t.npy")


def _resume_cfg(tmp_path, run, **kw):
    base = dict(model=ModelConfig(model="diff", **TINY), vocab_size=61,
                micro_batch_size=4, max_iters=10, eval_interval=5,
                eval_iters=1, log_interval=1, learning_rate=3e-3, min_lr=3e-4,
                warmup_iters=2, seed=7, ckpt_interval=5,
                checkpoint_path=str(tmp_path / run / "best.ckpt"),
                metrics_path=str(tmp_path / run / "m.jsonl"))
    os.makedirs(tmp_path / run, exist_ok=True)
    return TrainConfig(**{**base, **kw})


def _losses(path):
    return {r["iter"]: r["loss"] for r in map(json.loads, open(path))
            if "loss" in r}


@pytest.mark.parametrize("ckpt_async", [False, True], ids=["sync", "async"])
def test_sigterm_then_auto_resume_is_bit_equal(tmp_path, monkeypatch,
                                               ckpt_async):
    """10 steps in one run, against 5 steps stopped by SIGTERM (the last
    checkpoint written on the way out) and ``--resume-from auto`` to 10:
    the same per-step losses and the same state bytes."""
    from differential_transformer_replication_tpu_torch.train import trainer

    tokens = _tokens(tmp_path)
    whole = _resume_cfg(tmp_path, "a", ckpt_async=ckpt_async)
    state_a, _ = trainer.train(whole, tokens, device="cpu")

    real = trainer.make_train_step

    def stop_after_5(cfg, group=None):
        step = real(cfg, group)

        def wrapped(state, batch, seed=None):
            state, m = step(state, batch, seed)
            if state["step"] == 5:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, m
        return wrapped

    cut = _resume_cfg(tmp_path, "b", ckpt_async=ckpt_async)
    monkeypatch.setattr(trainer, "make_train_step", stop_after_5)
    state_b, _ = trainer.train(cut, tokens, device="cpu")
    monkeypatch.setattr(trainer, "make_train_step", real)
    assert state_b["step"] == 5
    assert cw.is_verified(cut.resolved_last_checkpoint_path())
    state_c, _ = trainer.train(cut.replace(resume_from="auto"), tokens,
                               device="cpu")
    _port_state_equal(state_a, state_c)
    a, c = _losses(whole.metrics_path), _losses(cut.metrics_path)
    assert list(a) == list(range(1, 11)) and [a[i] for i in a] == [c[i] for i in a]
    for name in ("best.last.ckpt", "best.steps/step-00000010"):
        assert (open(tmp_path / "a" / name / "state.msgpack", "rb").read()
                == open(tmp_path / "b" / name / "state.msgpack", "rb").read())
    recs = [json.loads(l) for l in open(whole.metrics_path)]
    assert any("ckpt_save_ms" in r and "ckpt_blocked_ms" in r for r in recs)


def test_elastic_resume_info_matches_jax():
    jcfg, cfg = _cfgs("diff", micro_batch_size=4, grad_acc_steps=2)
    metas = [
        {"iter_num": 6, "consumed_windows": 48, "config": jcfg.to_dict()},
        {"iter_num": 6, "config": jcfg.to_dict()},
        {"iter_num": 6, "consumed_windows": 40, "config": jcfg.to_dict()},
    ]
    for micro, acc in ((4, 2), (8, 1), (2, 3), (16, 1)):
        for inexact in (False, True):
            j = jcfg.replace(micro_batch_size=micro, grad_acc_steps=acc,
                             allow_inexact_resume=inexact)
            p = cfg.replace(micro_batch_size=micro, grad_acc_steps=acc,
                            allow_inexact_resume=inexact)
            for meta in metas:
                try:
                    want = jckpt.elastic_resume_info(meta, j)
                except jckpt.ElasticResumeError as e:
                    with pytest.raises(ckpt.ElasticResumeError) as ei:
                        ckpt.elastic_resume_info(meta, p)
                    assert str(ei.value) == str(e)
                else:
                    assert ckpt.elastic_resume_info(meta, p) == want
    other = cfg.replace(model=cfg.model.replace(n_layer=3))
    with pytest.raises(ckpt.ElasticResumeError, match="model.n_layer"):
        ckpt.elastic_resume_info(metas[0], other)


def test_trainer_inexact_elastic_resume_raises_unless_allowed(tmp_path, capsys):
    from differential_transformer_replication_tpu_torch.train import trainer

    tokens = _tokens(tmp_path)
    first = _resume_cfg(tmp_path, "e", max_iters=5, eval_interval=50)
    trainer.train(first, tokens, device="cpu")  # 20 windows consumed
    with pytest.raises(ckpt.ElasticResumeError, match="allow-inexact-resume"):
        trainer.train(first.replace(max_iters=8, micro_batch_size=3,
                                    resume_from="auto"), tokens, device="cpu")
    state, _ = trainer.train(first.replace(max_iters=8, micro_batch_size=3,
                                           resume_from="auto",
                                           allow_inexact_resume=True),
                             tokens, device="cpu")
    assert state["step"] == 8
    # the inexact run's position went on from 20 windows, by its batch
    meta = ckpt.read_meta(first.resolved_last_checkpoint_path())
    assert meta["consumed_windows"] == 20 + 3 * 3
    # an exact change of batch keeps the consumed windows
    step5 = os.path.join(first.resolved_ckpt_dir(), "step-00000005")
    state, _ = trainer.train(first.replace(max_iters=10, micro_batch_size=2,
                                           resume_from=step5),
                             tokens, device="cpu")
    meta = ckpt.read_meta(first.resolved_last_checkpoint_path())
    assert state["step"] == 10 and meta["consumed_windows"] == 20 + 5 * 2
    assert "resuming from" in capsys.readouterr().out


def test_cli_accepts_every_checkpoint_flag(tmp_path):
    from differential_transformer_replication_tpu_torch.train import __main__ as cli

    tokens = _tokens(tmp_path)
    argv = ["--model", "control", "--tokens", tokens, "--device", "cpu",
            "--n-embd", "32", "--n-head", "2", "--n-layer", "1",
            "--block-size", "16", "--vocab-size", "61", "--micro-batch-size", "4",
            "--max-iters", "6", "--eval-interval", "3", "--eval-iters", "1",
            "--log-interval", "3", "--metrics-path", "",
            "--checkpoint-path", str(tmp_path / "c" / "best.ckpt"),
            "--last-checkpoint-path", str(tmp_path / "c" / "last"),
            "--ckpt-interval", "2", "--ckpt-dir", str(tmp_path / "c" / "steps"),
            "--no-ckpt-async", "--ckpt-keep-last", "1", "--ckpt-keep-every", "4",
            "--checkpoint-min-interval-s", "0", "--allow-inexact-resume",
            "--resume-from", "auto"]
    state, _ = cli.run(argv)
    assert state["step"] == 6
    steps = [s for s, _ in cw.list_step_checkpoints(str(tmp_path / "c" / "steps"))]
    assert steps == [4, 6]  # keep the last one, and every 4th
    assert cw.is_verified(str(tmp_path / "c" / "last"))
    assert cw.is_verified(str(tmp_path / "c" / "best.ckpt"))
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert cfg.ckpt_async is False and cfg.allow_inexact_resume
    assert cfg.resolved_ckpt_dir() == str(tmp_path / "c" / "steps")


def test_failed_step_checkpoint_is_reported_and_the_run_goes_on(
        tmp_path, monkeypatch, capsys):
    from differential_transformer_replication_tpu_torch.train import trainer

    def failing_save(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(trainer, "save_step_checkpoint", failing_save)
    cfg = _resume_cfg(tmp_path, "f", max_iters=6, eval_interval=50,
                      ckpt_interval=3)
    state, history = trainer.train(cfg, _tokens(tmp_path), device="cpu")
    assert state["step"] == 6
    assert [m.get("ckpt_save_failed", 0) for m in history] == [0, 0, 1, 0, 0, 1]
    assert "step-checkpoint save failed at iter 3 (continuing)" in \
        capsys.readouterr().out
    # the last checkpoint still lands
    assert ckpt.read_meta(cfg.resolved_last_checkpoint_path())["iter_num"] == 6


def test_exception_inside_a_step_skips_the_last_checkpoint(tmp_path,
                                                           monkeypatch, capsys):
    """The port updates params in place, so a step that raises may leave
    them half-applied: the exception goes on and no last checkpoint is
    written (the JAX trainer, whose state is immutable, writes one)."""
    from differential_transformer_replication_tpu_torch.train import trainer

    real = trainer.make_train_step

    def breaks_at_3(cfg, group=None):
        step = real(cfg, group)

        def wrapped(state, batch, seed=None):
            if state["step"] == 3:
                raise RuntimeError("device lost mid-step")
            return step(state, batch, seed)
        return wrapped

    monkeypatch.setattr(trainer, "make_train_step", breaks_at_3)
    cfg = _resume_cfg(tmp_path, "x", max_iters=6, eval_interval=50,
                      ckpt_interval=2)
    with pytest.raises(RuntimeError, match="device lost"):
        trainer.train(cfg, _tokens(tmp_path), device="cpu")
    assert "interrupted mid-update" in capsys.readouterr().out
    assert not os.path.exists(cfg.resolved_last_checkpoint_path())
    # the step-2 checkpoint written before the failure resumes the run
    resolved, _ = ckpt.resolve_resume_auto(cfg)
    assert ckpt.read_meta(resolved)["iter_num"] == 2


def test_throttled_best_checkpoint_is_written_at_exit(tmp_path):
    from differential_transformer_replication_tpu_torch.train import trainer

    tokens = _tokens(tmp_path)
    cfg = _resume_cfg(tmp_path, "t", max_iters=6, eval_interval=2,
                      ckpt_interval=0, checkpoint_min_interval_s=3600.0,
                      last_checkpoint_path=None)
    trainer.train(cfg, tokens, device="cpu")
    # the first improvement writes at once; later ones are device copies,
    # the newest written on the way out
    meta = ckpt.read_meta(cfg.checkpoint_path)
    assert cw.is_verified(cfg.checkpoint_path) and meta["iter_num"] in (2, 4, 6)
    assert not os.path.exists(cfg.resolved_last_checkpoint_path() or "/nonexistent")


# ---------------------------------------------------------------------------
# serving a checkpoint
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_on_a_checkpoint_gives_the_jax_engines_greedy_tokens(tmp_path):
    """``python -m ...serving.server --checkpoint DIR`` against the JAX
    engine on JAX ``load_params_for_inference`` of the same directory
    (the seed and prompts of tests/test_torch_serving.py, which keep
    every greedy step off a near-tie)."""
    from differential_transformer_replication_tpu.models import init_model

    small = dict(vocab_size=61, n_embd=32, n_head=2, n_layer=2, block_size=32,
                 dropout=0.0, n_terms=3, compute_dtype="float32")
    jcfg = JTrainConfig(model=JModelConfig(model="diff", **small), vocab_size=61)
    tree = jax.tree_util.tree_map(np.asarray, init_model(
        jax.random.PRNGKey(0), jcfg.resolved_model()))
    rng = np.random.default_rng(5)
    for blk in tree["blocks"]:
        for key in ("lambda_q", "lambda_k"):
            blk["attn"][key] = (rng.standard_normal(blk["attn"][key].shape)
                                * 0.1).astype(np.float32)
    cfg = TrainConfig(model=ModelConfig(model="diff", **small), vocab_size=61)
    state = create_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    from differential_transformer_replication_tpu_torch.params import params_from_jax

    state["params"] = params_from_jax(tree, cfg.resolved_model())
    path = str(tmp_path / "serve.ckpt")
    ckpt.save_checkpoint(path, state, 3.0, cfg)

    prompts = [np.random.default_rng(1).integers(0, 61, size=n).tolist()
               for n in [3, 9, 14, 6, 11]]
    jparams, jmodel, _ = jckpt.load_params_for_inference(path)
    jeng = JServingEngine(jparams, jmodel, JServingConfig(
        num_slots=2, prefill_chunk=4, prefill_budget=6))
    want = [o.tokens for o in jeng.generate(prompts, max_new_tokens=8,
                                            temperature=0.0)]
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "differential_transformer_replication_tpu_torch.serving.server",
         "--checkpoint", path, "--device", "cpu", "--port", str(port),
         "--num-slots", "2", "--prefill-chunk", "4", "--prefill-budget", "6"],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(url + "/health", timeout=5) as r:
                    if json.load(r)["ok"]:
                        break
            except OSError:
                assert proc.poll() is None, proc.stdout.read()
                assert time.time() < deadline, "server did not come up"
                time.sleep(0.2)
        outs = [None] * len(prompts)

        def post(i):
            req = urllib.request.Request(
                url + "/generate", data=json.dumps({
                    "prompt_ids": prompts[i], "max_new_tokens": 8,
                    "temperature": 0.0}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                outs[i] = json.load(r)["tokens"]

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert outs == want
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out = proc.communicate(timeout=60)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            out = proc.communicate()[0]
    assert f"({path})" in out


# ---------------------------------------------------------------------------
# the durability cases of tests/test_ckpt.py, against both ckpt_writers
# ---------------------------------------------------------------------------

@pytest.fixture(params=["jax", "port"])
def side(request):
    """(ckpt_writer module, arm(point), the injected fault's type): the
    JAX package's writer and plan, or the port's writer and its own plan
    (utils/faults.py, a copy)."""
    faults = jfaults if request.param == "jax" else tfaults
    faults.reset()
    yield ((jcw, faults.arm, faults.FaultInjected) if request.param == "jax"
           else (cw, faults.arm, faults.FaultInjected))
    faults.reset()


def test_port_fault_points_are_inert_without_a_fault_plan(tmp_path):
    tfaults.reset()
    assert cw._faults() is tfaults  # the port's own plan, found
    assert not tfaults.armed()
    cw.atomic_write(str(tmp_path / "f"), b"x")
    assert open(tmp_path / "f", "rb").read() == b"x"


def _mk_raw_ckpt(mod, root, step, certify=True, payload=b"fake-state-bytes"):
    path = os.path.join(root, mod.step_dir_name(step))
    os.makedirs(path, exist_ok=True)
    mod.atomic_write(os.path.join(path, "state.msgpack"), payload + b"%d" % step)
    mod.atomic_write(os.path.join(path, "meta.json"),
                     json.dumps({"iter_num": step, "best_val_loss": 1.0}).encode())
    if certify:
        mod.write_manifest(path, step=step)
    return path


def _flip_byte(path):
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))


def test_write_fault_keeps_old_content(side, tmp_path):
    mod, arm, exc = side
    dest = str(tmp_path / "f")
    mod.atomic_write(dest, b"old")
    arm("ckpt_write")
    with pytest.raises(exc):
        mod.atomic_write(dest, b"new")
    assert open(dest, "rb").read() == b"old"
    assert not os.path.exists(dest + ".tmp")


def test_fsync_fault_fires_after_rename(side, tmp_path):
    mod, arm, exc = side
    dest = str(tmp_path / "f")
    mod.atomic_write(dest, b"old")
    arm("ckpt_fsync")
    with pytest.raises(exc):
        mod.atomic_write(dest, b"new")
    assert open(dest, "rb").read() == b"new"
    assert not os.path.exists(dest + ".tmp")


def test_manifest_roundtrip_digests_and_faults(side, tmp_path):
    mod, arm, exc = side
    root = str(tmp_path / "steps")
    path = _mk_raw_ckpt(mod, root, 5)
    manifest = mod.verify_checkpoint(path)
    assert set(manifest["files"]) == {"state.msgpack", "meta.json"}
    assert manifest["step"] == 5
    _flip_byte(os.path.join(path, "state.msgpack"))
    with pytest.raises(mod.CheckpointError, match="state.msgpack") as ei:
        mod.verify_checkpoint(path)
    assert "expected sha256" in str(ei.value) and not mod.is_verified(path)
    # truncation names the file and its sizes
    p2 = _mk_raw_ckpt(mod, root, 6)
    mp = os.path.join(p2, "meta.json")
    open(mp, "wb").write(open(mp, "rb").read()[:5])
    with pytest.raises(mod.CheckpointError, match="meta.json"):
        mod.verify_checkpoint(p2)
    # a missing or truncated manifest is uncertified
    p3 = _mk_raw_ckpt(mod, root, 7)
    mf = os.path.join(p3, mod.MANIFEST_NAME)
    open(mf, "wb").write(open(mf, "rb").read()[:20])
    assert not mod.is_verified(p3) and not mod.is_certified(p3)
    os.unlink(mf)
    with pytest.raises(mod.CheckpointError, match="manifest"):
        mod.verify_checkpoint(p3)
    # the manifest fault leaves complete data and no certification
    p4 = _mk_raw_ckpt(mod, root, 8, certify=False)
    arm("ckpt_manifest")
    with pytest.raises(exc):
        mod.write_manifest(p4, step=8)
    assert not os.path.exists(os.path.join(p4, mod.MANIFEST_NAME))
    mod.write_manifest(p4, step=8)
    assert mod.is_verified(p4)


def test_rotation_keep_last_plus_keep_every(side, tmp_path):
    mod, _, _ = side
    root = str(tmp_path / "steps")
    for s in (5, 10, 15, 20, 25, 30):
        _mk_raw_ckpt(mod, root, s)
    kept, deleted = mod.gc_step_checkpoints(root, keep_last=2, keep_every=10)
    assert sorted(s for s, _ in mod.list_step_checkpoints(root)) == [10, 20, 25, 30]
    assert len(deleted) == 2


def test_rotation_collects_uncertified_and_falls_back(side, tmp_path):
    mod, _, _ = side
    root = str(tmp_path / "steps")
    good = _mk_raw_ckpt(mod, root, 10)
    torn = _mk_raw_ckpt(mod, root, 20, certify=False)
    bad = _mk_raw_ckpt(mod, root, 30)
    _flip_byte(os.path.join(bad, "state.msgpack"))
    resolved, skipped = mod.latest_verified_checkpoint(root)
    assert resolved == good and [p for p, _ in skipped] == [bad, torn]
    kept, deleted = mod.gc_step_checkpoints(root, keep_last=3)
    assert torn in deleted and bad in kept


def test_gc_crash_leaves_uncertified_never_torn_certified(side, tmp_path):
    mod, arm, exc = side
    root = str(tmp_path / "steps")
    for s in (10, 20, 30):
        _mk_raw_ckpt(mod, root, s)
    arm("ckpt_gc")
    with pytest.raises(exc):
        mod.gc_step_checkpoints(root, keep_last=1)
    victim = os.path.join(root, mod.step_dir_name(10))
    assert os.path.isdir(victim) and not mod.is_verified(victim)
    assert mod.latest_verified_checkpoint(root)[0] == os.path.join(
        root, mod.step_dir_name(30))
    mod.gc_step_checkpoints(root, keep_last=1)
    assert [s for s, _ in mod.list_step_checkpoints(root)] == [30]


def test_async_writer_back_pressure_errors_and_drain(side, tmp_path):
    mod, _, _ = side
    w = mod.AsyncCheckpointWriter()
    assert not w.drained
    gate = threading.Event()
    ran = []
    t0 = time.perf_counter()
    assert w.submit(lambda: (gate.wait(10), ran.append(1))) < 0.05
    assert time.perf_counter() - t0 < 0.5 and not ran
    threading.Timer(0.3, gate.set).start()
    assert w.submit(lambda: ran.append(2)) >= 0.2  # back-pressure
    w.close()
    assert ran == [1, 2] and w.saves_completed == 2 and w.drained
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(lambda: None)
    # a failed job surfaces on the next submit, which still lands
    w = mod.AsyncCheckpointWriter()
    w.submit(lambda: (_ for _ in ()).throw(ValueError("disk on fire")))
    time.sleep(0.1)
    with pytest.raises(ValueError, match="disk on fire"):
        w.submit(lambda: ran.append(3))
    marker = str(tmp_path / "done")
    w.submit(lambda: (time.sleep(0.2), open(marker, "w").write("x")))
    w.close()
    assert ran[-1] == 3 and os.path.exists(marker) and w.saves_completed == 2


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_resolve_auto_picks_newest_verified_across_sources(pkg, tmp_path):
    jcfg, cfg, host = _jax_host_state("control")
    kw = dict(checkpoint_path=str(tmp_path / "best.ckpt"),
              ckpt_dir=str(tmp_path / "steps"))
    if pkg == "jax":
        c, mod = jcfg.replace(**kw), jckpt
        jckpt.save_checkpoint(c.checkpoint_path, host, 1.0, c)
    else:
        c, mod = cfg.replace(**kw), ckpt
        ckpt.save_checkpoint(c.checkpoint_path, train_state_from_jax(
            host, cfg.resolved_model()), 1.0, c)
    writer = jcw if pkg == "jax" else cw
    root = c.resolved_ckpt_dir()
    good = _mk_raw_ckpt(writer, root, 10)
    bad = _mk_raw_ckpt(writer, root, 20)
    _flip_byte(os.path.join(bad, "state.msgpack"))
    resolved, skipped = mod.resolve_resume_auto(c)
    assert resolved == good and [p for p, _ in skipped] == [bad]
    none = c.replace(checkpoint_path=str(tmp_path / "nope.ckpt"),
                     ckpt_dir=str(tmp_path / "none"))
    assert mod.resolve_resume_auto(none) == (None, [])
