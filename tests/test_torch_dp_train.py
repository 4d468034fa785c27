"""The trainer's command line on a mesh of ranks, and checkpoints across
mesh shapes, on the CPU.

Ranks are processes of ``tests/torch_ring_worker.py`` (task ``clis``:
several trainer command lines in turn on one launch of ranks, each run
joining the world's group; ``file://`` rendezvous under ``tmp_path``, a
time limit on the launch). Held here:

- ``--data-parallel 2``, ``--fsdp 2`` and ``--sequence-parallel 2
  --sequence-impl ulysses``, each with ``--dist-backend gloo --device
  cpu``, train two steps with an eval through the mesh; every rank
  reports the same losses;
- elastic resume, twins of JAX ``tests/test_elastic.py:190-235`` at the
  port's tiny size: a ``data=2`` run's last checkpoint resumed at
  ``data=2`` twice (byte-identical ``state.msgpack``), at ``data=1`` (in
  this process) and at ``fsdp=2`` gives loss trajectories equal within
  rtol 1e-5;
- an fsdp save (the gathered full state) loads in the JAX package's
  ``load_checkpoint`` and equals the ``data=2`` run's state within the
  step tolerance (2e-5);
- ``--tensor-parallel 2`` trains the ``data=2`` base run's steps with its
  losses (rtol 1e-5), every rank reporting the same ones, and its last
  checkpoint (the gathered full state) resumes at ``--data-parallel 2``
  as at ``data=1``;
- ``--pipeline-parallel 2`` trains the base run's steps with its losses
  (rtol 1e-5), every rank reporting the same ones; its last checkpoint
  holds the canonical list of blocks: it loads in JAX's
  ``load_checkpoint`` (the base run's params within 2e-5) and resumes at
  ``data=1`` (in this process) as the base does, and a one-rank
  checkpoint resumes at ``pipeline=2`` likewise.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np

from differential_transformer_replication_tpu.config import (
    ModelConfig as JModelConfig,
    TrainConfig as JTrainConfig,
)
from differential_transformer_replication_tpu.train import checkpoint as jckpt
from differential_transformer_replication_tpu.train.step import (
    create_train_state as j_create_train_state,
)
from differential_transformer_replication_tpu_torch.train import __main__ as cli

import torch_ring_worker  # tests/: torch and the port only

RANK_TIMEOUT_S = 240
TINY_ARGS = ["--model", "diff", "--device", "cpu", "--n-embd", "32", "--n-head", "2",
             "--n-layer", "2", "--block-size", "32", "--vocab-size", "64",
             "--micro-batch-size", "4", "--eval-interval", "2", "--eval-iters", "1",
             "--warmup-iters", "1", "--learning-rate", "3e-3", "--compute-dtype",
             "float32", "--metrics-path", "", "--seed", "5"]


def _state_bytes(run) -> bytes:
    return open(os.path.join(run, "last.ckpt", "state.msgpack"), "rb").read()


def test_mesh_command_lines_train_and_resume_across_mesh_shapes(tmp_path):
    rng = np.random.default_rng(51)
    tokens = tmp_path / "tokens.npy"
    np.save(tokens, ((rng.zipf(1.3, 20000) - 1) % 64).astype(np.int32))

    def argv(name, *extra, steps=2, resume=None):
        run = tmp_path / name
        a = TINY_ARGS + ["--tokens", str(tokens), "--max-iters", str(steps),
                         "--checkpoint-path", str(run / "best.ckpt"),
                         "--last-checkpoint-path", str(run / "last.ckpt"), *extra]
        if resume:
            a += ["--resume-from", str(tmp_path / resume / "last.ckpt")]
        return a

    gloo = ["--dist-backend", "gloo"]
    # a one-rank run of the base's steps, for a resume at pipeline=2
    cli.run(argv("solo", steps=4))
    runs = [argv("dp", "--data-parallel", "2", *gloo),
            argv("fsdp", "--fsdp", "2", *gloo),
            argv("uly", "--sequence-parallel", "2", "--sequence-impl", "ulysses",
                 "--dropout", "0.1", *gloo),
            # the elastic chain: a data=2 base, then its resumes
            argv("base", "--data-parallel", "2", *gloo, steps=4),
            argv("dp_a", "--data-parallel", "2", *gloo, steps=6, resume="base"),
            argv("dp_b", "--data-parallel", "2", *gloo, steps=6, resume="base"),
            argv("fsdp_c", "--fsdp", "2", *gloo, steps=6, resume="base"),
            # a tensor=2 run of the base's steps, resumed at data=2
            argv("tp", "--tensor-parallel", "2", *gloo, steps=4),
            argv("tp_dp", "--data-parallel", "2", *gloo, steps=6, resume="tp"),
            # pipeline=2: the base's steps, and a resume of the one-rank run
            argv("pp", "--pipeline-parallel", "2", *gloo, steps=4),
            argv("pp_solo", "--pipeline-parallel", "2", *gloo, steps=6, resume="solo")]
    outs = torch_ring_worker.run_ranks("clis", 2, tmp_path / "ranks",
                                       {"runs": np.array(json.dumps(runs))},
                                       RANK_TIMEOUT_S)
    for k in range(3):
        losses = outs[0][f"losses{k}"]
        assert len(losses) == 2 and np.all(np.isfinite(losses)), k
        # the loss is reduced over the mesh: every rank reports the same one
        assert np.array_equal(outs[1][f"losses{k}"], losses), k
    # two resumes of one checkpoint: byte-identical states, moments included
    assert _state_bytes(tmp_path / "dp_a") == _state_bytes(tmp_path / "dp_b")
    meta = json.load(open(tmp_path / "dp_a" / "last.ckpt" / "meta.json"))
    assert meta["consumed_windows"] == 6 * 4
    # data=1 in this process, from the same checkpoint
    _, history = cli.run(argv("one", steps=6, resume="base"))
    la, lc = outs[0]["losses4"], outs[0]["losses6"]
    lb = np.array([m["loss"] for m in history])
    assert len(la) == len(lb) == len(lc) == 2
    np.testing.assert_allclose(la, lb, rtol=1e-5)
    np.testing.assert_allclose(la, lc, rtol=1e-5)
    # the fsdp run's save is the gathered full state, in the JAX format
    jcfg = JTrainConfig(model=JModelConfig(model="diff", vocab_size=64, n_embd=32,
                                           n_head=2, n_layer=2, block_size=32,
                                           compute_dtype="float32"), vocab_size=64)
    target = j_create_train_state(jax.random.PRNGKey(0), jcfg)
    got, _ = jckpt.load_checkpoint(str(tmp_path / "fsdp_c" / "last.ckpt"), jcfg, target)
    target = j_create_train_state(jax.random.PRNGKey(0), jcfg)
    want, _ = jckpt.load_checkpoint(str(tmp_path / "dp_a" / "last.ckpt"), jcfg, target)
    assert int(got["step"]) == int(want["step"]) == 6
    for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(want["params"])):
        assert float(np.max(np.abs(np.asarray(a) - np.asarray(b)))) <= 2e-5
    # tensor=2: the base's losses on every rank, and a resume at another mesh
    lt = outs[0]["losses7"]
    assert np.array_equal(outs[1]["losses7"], lt)
    np.testing.assert_allclose(lt, outs[0]["losses3"], rtol=1e-5)
    _, history = cli.run(argv("tp_one", steps=6, resume="tp"))
    np.testing.assert_allclose(outs[0]["losses8"], [m["loss"] for m in history],
                               rtol=1e-5)
    # pipeline=2: the base's losses on every rank; its checkpoint is the
    # canonical layout (JAX reads it) and resumes at data=1; a one-rank
    # checkpoint resumes at pipeline=2
    lp = outs[0]["losses9"]
    assert np.array_equal(outs[1]["losses9"], lp)
    np.testing.assert_allclose(lp, outs[0]["losses3"], rtol=1e-5)
    target = j_create_train_state(jax.random.PRNGKey(0), jcfg)
    got, _ = jckpt.load_checkpoint(str(tmp_path / "pp" / "last.ckpt"), jcfg, target)
    target = j_create_train_state(jax.random.PRNGKey(0), jcfg)
    want, _ = jckpt.load_checkpoint(str(tmp_path / "base" / "last.ckpt"), jcfg, target)
    assert int(got["step"]) == int(want["step"]) == 4
    assert isinstance(got["params"]["blocks"], list)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert float(np.max(np.abs(np.asarray(a) - np.asarray(b)))) <= 2e-5
    _, history = cli.run(argv("pp_one", steps=6, resume="pp"))
    np.testing.assert_allclose([m["loss"] for m in history], lb, rtol=1e-5)
    assert np.array_equal(outs[1]["losses10"], outs[0]["losses10"])
    np.testing.assert_allclose(outs[0]["losses10"], lb, rtol=1e-5)
