"""Remat and the chunked loss over the sequence-parallel ring on the
CPU: two gloo ranks (``tests/torch_ring_worker.py``, task ``grads``)
run one step of a 2-layer diff model at dropout 0.1 from the same
params, batch and seed, plain, under remat ``nothing`` and ``dots``
(the recompute runs the ring's exchanges again inside the backward, on
every rank in the same order) and with remat and the chunked loss (each
rank's loss divided by the global token count). Remat is bit-equal to
the plain step; the chunked loss is within the fp32 bounds of
``tests/test_torch_train.py`` (1e-5 on the loss, 1e-4 of each leaf's
max on the gradients)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_ring_worker  # noqa: E402

from differential_transformer_replication_tpu_torch.config import ModelConfig  # noqa: E402
from differential_transformer_replication_tpu_torch.models import init_model  # noqa: E402
from differential_transformer_replication_tpu_torch.train.optim import leaves  # noqa: E402

TINY = dict(model="diff", vocab_size=64, n_embd=32, n_head=2, n_layer=2,
            block_size=32, dropout=0.1, compute_dtype="float32")
VARIANTS = ({}, {"remat": True, "remat_policy": "nothing"},
            {"remat": True, "remat_policy": "dots"},
            {"remat": True, "remat_policy": "nothing", "loss_chunk": 24})


def test_remat_and_the_chunked_loss_over_the_ring(tmp_path):
    P = 2
    params = init_model(torch.Generator().manual_seed(3), ModelConfig(**TINY))
    rng = np.random.default_rng(5)
    x = rng.integers(0, TINY["vocab_size"], (1, 2, TINY["block_size"]))
    y = rng.integers(0, TINY["vocab_size"], (1, 2, TINY["block_size"]))
    meta = {"models": [dict(TINY, **v) for v in VARIANTS], "seed": 17,
            "train": dict(micro_batch_size=2, vocab_size=TINY["vocab_size"],
                          sampler="replacement")}
    inputs = {"meta": np.array(json.dumps(meta)), "x": x, "y": y,
              "device": np.array("cpu")}
    inputs.update({f"p{i}": t.numpy() for i, t in enumerate(leaves(params))})
    outs = torch_ring_worker.run_ranks("grads", P, tmp_path, inputs, 120)
    n = len(leaves(params))
    for o in outs:
        for k in (1, 2):
            assert np.array_equal(o[f"loss{k}"], o["loss0"]), k
            for i in range(n):
                assert np.array_equal(o[f"g{k}_{i}"], o[f"g0_{i}"]), (k, i)
        assert abs(float(o["loss3"]) - float(o["loss0"])) <= 1e-5
        for i in range(n):
            ref = o[f"g0_{i}"]
            err = float(np.max(np.abs(o[f"g3_{i}"] - ref)))
            assert err <= 1e-4 * max(float(np.max(np.abs(ref))), 1e-12), i
    # the all-reduced loss and grads are the same on both ranks
    assert np.array_equal(outs[0]["loss1"], outs[1]["loss1"])
