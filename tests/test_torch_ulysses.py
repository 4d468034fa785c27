"""All-to-all (Ulysses) sequence parallelism of the port against the JAX
package, on the CPU: twins of JAX ``tests/test_ulysses.py``.

The ranks are processes of ``tests/torch_ring_worker.py`` (``file://``
rendezvous under ``tmp_path``, a time limit on every join); the JAX side
runs on the virtual CPU mesh of ``tests/conftest.py``, its Pallas
kernels in interpret mode. Held here:

- ``ulysses_multi_stream_attention`` at ``sequence`` 2 and 4 against
  JAX's with ``impl="pallas"``: the forward and every gradient, dcoeffs
  included, at dropout 0 and at 0.3 with each rank's seed words (those
  JAX's ``sequence_shard_map`` derives for its mesh position);
- the vanilla, diff and ndiff coefficient sets (JAX's three parity
  tests);
- ``model_forward`` of the three families with ``sequence_impl=
  "ulysses"`` against JAX's on the ``sequence`` mesh;
- one train step with ``sequence_impl="ulysses"`` from
  ``train_state_from_jax`` against JAX ``make_sharded_train_step``;
- uneven heads fail with JAX's text.

Tolerances: fp32 outputs 1e-5, gradients 1e-4 of each tensor's max,
the step as ``tests/test_torch_ring.py``.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu.config import (
    MeshConfig as JMeshConfig,
    ModelConfig as JModelConfig,
    TrainConfig as JTrainConfig,
)
from differential_transformer_replication_tpu.models import (
    init_model as j_init_model,
    model_forward as j_model_forward,
)
from differential_transformer_replication_tpu.ops import flash as jflash
from differential_transformer_replication_tpu.ops.streams import (
    diff_coeffs as j_diff_coeffs,
    ndiff_coeffs as j_ndiff_coeffs,
    vanilla_coeffs as j_vanilla_coeffs,
)
from differential_transformer_replication_tpu.parallel import create_mesh
from differential_transformer_replication_tpu.parallel.dp_step import (
    make_sharded_train_step as j_make_sharded_train_step,
)
from differential_transformer_replication_tpu.parallel.ulysses import (
    ulysses_multi_stream_attention as j_ulysses,
)
from differential_transformer_replication_tpu.train.step import (
    create_train_state as j_create_train_state,
)
from differential_transformer_replication_tpu_torch.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from differential_transformer_replication_tpu_torch.params import train_state_from_jax
from differential_transformer_replication_tpu_torch.parallel import ulysses
from differential_transformer_replication_tpu_torch.parallel.mesh import SequenceGroup
from differential_transformer_replication_tpu_torch.train.optim import leaves

import torch_ring_worker  # tests/: torch and the port only

FP32_TOL = 1e-5
GRAD_REL = 1e-4
RANK_TIMEOUT_S = 120


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _err(a, b) -> float:
    return float(np.max(np.abs(_np(a) - _np(b))))


def _top(x) -> float:
    return max(float(np.max(np.abs(_np(x)))), 1e-12)


def _leaf_arrays(tree, prefix):
    flat = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for x in node:
                walk(x)
        else:
            flat.append(np.asarray(node, np.float32))

    walk(tree)
    return {f"{prefix}{i}": a for i, a in enumerate(flat)}


B, T, D = 2, 64, 8

# (id, streams, heads, coefficient kind, dropout rate) per world size
ATTN_CASES = {
    2: [("multi", 2, 2, "multi", 0.0), ("multi-dropout", 2, 2, "multi", 0.3),
        ("vanilla", 1, 2, "vanilla", 0.0), ("diff", 2, 2, "diff", 0.0),
        ("ndiff", 3, 2, "ndiff", 0.0)],
    4: [("multi", 2, 4, "multi", 0.0), ("multi-dropout", 2, 4, "multi", 0.3)],
}
ATTN_IDS = [(P, i) for P, cases in ATTN_CASES.items() for i in range(len(cases))]


def _coeffs(kind, S, H, rng):
    if kind == "vanilla":
        return np.asarray(j_vanilla_coeffs(H))
    if kind == "diff":
        return np.asarray(j_diff_coeffs(jnp.asarray(
            (0.5 * rng.standard_normal(H)).astype(np.float32))))
    if kind == "ndiff":
        lams = np.abs(rng.standard_normal((S, H))).astype(np.float32) * 0.3 + 0.1
        signs = jnp.asarray(np.array([1.0, -1.0, 1.0], np.float32)[:S])
        return np.asarray(j_ndiff_coeffs(jnp.asarray(lams), signs))
    c = (0.5 * rng.standard_normal((S, H))).astype(np.float32)
    c[0] = 1.0
    return c


@pytest.fixture(scope="module")
def ulysses_runs(tmp_path_factory):
    refs, outs = {}, {}
    for P, cases in ATTN_CASES.items():
        mesh = create_mesh(JMeshConfig(sequence=P))
        key = jax.random.PRNGKey(10 + P)
        words = np.stack([np.asarray(jflash.dropout_seed_from_rng(
            jax.random.fold_in(key, p)))[0] for p in range(P)])
        inputs = {"rates": np.array([c[4] for c in cases]), "words": words,
                  "device": np.array("cpu")}
        for i, (_, S, H, kind, rate) in enumerate(cases):
            rng = np.random.default_rng([P, i])
            qs = rng.standard_normal((S, B, T, H, D)).astype(np.float32)
            ks = rng.standard_normal((S, B, T, H, D)).astype(np.float32)
            v = rng.standard_normal((B, T, H, 2 * D)).astype(np.float32)
            g = rng.standard_normal((B, T, H, 2 * D)).astype(np.float32)
            c = _coeffs(kind, S, H, rng)

            def jfn(qs, ks, v, c, g, rate=rate):
                out, vjp = jax.vjp(lambda *a: j_ulysses(
                    *a, mesh, "pallas", dropout_rate=rate,
                    dropout_rng=key if rate > 0 else None), qs, ks, v, c)
                return (out, *vjp(g))

            refs[(P, i)] = jax.jit(jfn)(*(jnp.asarray(a) for a in (qs, ks, v, c, g)))
            inputs.update({f"qs{i}": qs, f"ks{i}": ks, f"v{i}": v, f"g{i}": g,
                           f"coeffs{i}": c})
        outs[P] = torch_ring_worker.run_ranks("ulysses", P,
                                              tmp_path_factory.mktemp(f"uly{P}"), inputs,
                                              RANK_TIMEOUT_S)
    return refs, outs


@pytest.mark.parametrize("P,i", ATTN_IDS, ids=[f"P{P}-{ATTN_CASES[P][i][0]}"
                                              for P, i in ATTN_IDS])
def test_ulysses_attention_matches_jax(P, i, ulysses_runs):
    refs, outs = ulysses_runs
    jout, jdq, jdk, jdv, jdc = refs[(P, i)]
    got = {n: np.concatenate([o[f"{n}{i}"] for o in outs[P]], axis=axis)
           for n, axis in (("out", 1), ("dqs", 2), ("dks", 2), ("dv", 1))}
    got["dcoeffs"] = sum(o[f"dcoeffs{i}"] for o in outs[P])
    assert _err(jout, got["out"]) <= FP32_TOL
    for n, ref in (("dqs", jdq), ("dks", jdk), ("dv", jdv), ("dcoeffs", jdc)):
        assert _err(ref, got[n]) <= GRAD_REL * _top(ref), n
    # two all-to-alls forward, their two transposes backward
    for o in outs[P]:
        assert int(o[f"exchanges{i}"]) == 4
    if ATTN_CASES[P][i][3] == "vanilla":  # one stream: no other gradient
        assert got["dqs"].shape[0] == 1


def test_ulysses_dropout_masks_are_live(ulysses_runs):
    refs, _ = ulysses_runs
    for P in ATTN_CASES:
        assert _err(refs[(P, 0)][0], refs[(P, 1)][0]) > 1e-2


# ---------------------------------------------------------------------------
# the model and one train step
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=64, n_embd=32, n_head=2, n_layer=2, block_size=64,
            n_terms=2, dropout=0.0, compute_dtype="float32", sequence_impl="ulysses")
KINDS = ("control", "diff", "ndiff")


def test_model_forward_ulysses_matches_jax_mesh_forward(tmp_path):
    P, Bm = 2, 2
    mesh = create_mesh(JMeshConfig(sequence=P))
    rng = np.random.default_rng(80)
    inputs = {"kinds": np.array(KINDS), "device": np.array("cpu")}
    refs = {}
    for kind in KINDS:
        jcfg = JModelConfig(model=kind, attention_impl="pallas", **TINY)
        jparams = j_init_model(jax.random.PRNGKey(81), jcfg)
        jparams = jax.tree_util.tree_map(
            lambda a: a + 0.05 * jnp.asarray(
                rng.standard_normal(a.shape).astype(np.float32)), jparams)
        idx = rng.integers(0, TINY["vocab_size"], (Bm, TINY["block_size"]))
        tgt = rng.integers(0, TINY["vocab_size"], (Bm, TINY["block_size"]))
        refs[kind] = jax.jit(lambda p, i, t, jcfg=jcfg: j_model_forward(
            p, i, jcfg, targets=t, mesh=mesh))(jparams, jnp.asarray(idx), jnp.asarray(tgt))
        inputs.update(_leaf_arrays(jparams, f"p_{kind}_"))
        inputs[f"cfg_{kind}"] = np.array(json.dumps(dict(TINY, model=kind)))
        inputs[f"x_{kind}"], inputs[f"y_{kind}"] = idx, tgt
    outs = torch_ring_worker.run_ranks("model", P, tmp_path, inputs, RANK_TIMEOUT_S)
    for kind, (jlogits, jloss) in refs.items():
        logits = np.concatenate([o[f"logits_{kind}"] for o in outs], axis=1)
        loss = sum(float(o[f"loss_{kind}"]) for o in outs)
        assert _err(jlogits, logits) <= FP32_TOL * max(1.0, _top(jlogits)), kind
        assert abs(float(jloss) - loss) <= FP32_TOL, kind


def test_ulysses_train_step_matches_jax_sharded_step(tmp_path):
    P, kind = 2, "diff"
    common = dict(micro_batch_size=2, grad_acc_steps=2, max_iters=20,
                  learning_rate=3e-3, min_lr=3e-4, warmup_iters=0, weight_decay=0.1,
                  vocab_size=TINY["vocab_size"], anomaly_warmup_steps=1)
    jcfg = JTrainConfig(model=JModelConfig(model=kind, attention_impl="pallas", **TINY),
                        mesh=JMeshConfig(sequence=P), **common)
    jstate = j_create_train_state(jax.random.PRNGKey(9), jcfg)
    host = jax.tree_util.tree_map(np.asarray, jstate)
    cfg = TrainConfig(model=ModelConfig(model=kind, **TINY), mesh=MeshConfig(sequence=P),
                      sampler="replacement", **common)
    state = train_state_from_jax(host, cfg.resolved_model())
    rng = np.random.default_rng(90)
    x = rng.integers(0, TINY["vocab_size"], (2, 2, TINY["block_size"]))
    y = rng.integers(0, TINY["vocab_size"], (2, 2, TINY["block_size"]))
    jstep = j_make_sharded_train_step(jcfg, create_mesh(jcfg.mesh), jstate)
    jnew, jm = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    meta = {"model": dict(TINY, model=kind), "train": dict(common, sampler="replacement"),
            "count": state["opt_state"]["count"], "step": state["step"],
            "guard": {k: float(v) if k == "ema" else int(v)
                      for k, v in state["guard"].items()}}
    inputs = {"meta": np.array(json.dumps(meta)), "x": x, "y": y,
              "device": np.array("cpu")}
    for name, tree in (("p", state["params"]), ("mu", state["opt_state"]["mu"]),
                       ("nu", state["opt_state"]["nu"])):
        inputs.update({f"{name}{i}": t.detach().numpy() for i, t in enumerate(leaves(tree))})
    outs = torch_ring_worker.run_ranks("step", P, tmp_path, inputs, RANK_TIMEOUT_S)
    o = outs[0]
    assert abs(float(jm["loss"]) - float(o["loss"])) <= FP32_TOL
    assert abs(float(jm["grad_norm"]) - float(o["grad_norm"])) <= \
        GRAD_REL * float(jm["grad_norm"])
    jp = _leaf_arrays(jnew["params"], "p")
    for i in range(len(jp)):
        assert _err(jp[f"p{i}"], o[f"p{i}"]) <= 2e-5, i
        assert np.array_equal(outs[1][f"p{i}"], o[f"p{i}"]), i


def test_uneven_heads_fail_with_jax_text():
    """4 heads over 8 sequence ranks: refused before any exchange, with
    JAX's text, in the attention and in the config."""
    sg = SequenceGroup(0, 8, torch.device("cpu"), "gloo")
    q = torch.zeros(4, 1, 8, 8)
    with pytest.raises(ValueError, match="local heads divisible by the sequence axis: "
                                         "4 heads per tensor shard vs sequence=8"):
        ulysses.ulysses_flash_body(q, q, torch.zeros(4, 8, 16), torch.ones(1, 4), sg)
    with pytest.raises(ValueError, match="sequence_impl='ring', for uneven head counts"):
        TrainConfig(model=ModelConfig(model="diff", n_head=4, sequence_impl="ulysses"),
                    mesh=MeshConfig(sequence=8))
