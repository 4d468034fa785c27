"""Pipeline parallelism of the port against the JAX package, on the CPU.

The ranks are processes of ``tests/torch_ring_worker.py`` (torch and the
port only, task ``pipeline``) joined through a ``file://`` rendezvous
under ``tmp_path``, one launch per world size (2 and 4) running every
case in turn; the JAX side runs on the 8 virtual CPU devices of
``tests/conftest.py``. Both sides start from JAX-initialized params
(``train_state_from_jax``), which each rank cuts to its stage (and its
tensor shard). Held here:

- (a) one ``make_pipeline_train_step`` step against JAX's on the same
  ``MeshConfig`` and global batch: loss, grad norm and every updated
  param, gathered to the canonical layout. Meshes: ``pipeline=2`` (diff,
  control, ndiff), ``pipeline=4``, ``pipeline=2 x data=2``,
  ``pipeline=2 x tensor=2`` and ``pipeline=2 x sequence=2`` (twin of JAX
  ``tests/test_pipeline.py::TestPipelineTrainStep::
  test_step_matches_single_device_step``; JAX runs
  ``attention_impl="xla"``, as in the tensor tests);
- (b) every step, with M < P too, against the port's one-rank step with
  ``grad_acc_steps`` = M;
- (c) ``make_pipeline_eval_many`` against JAX's and against the mean of
  the per-batch evals;
- (d) a stage > 0 gives its blocks their global layer index: with live
  lambdas, the ``pipeline=4`` loss equals JAX's pipeline loss and the
  one-device mean (twin of ``test_traced_layer_index_matches_static_
  schedule``);
- (e) dropout: the same seed gives the same loss, another seed another,
  no seed the dropout-free loss, and the gradients flow (twin of
  ``test_dropout_through_pipeline``); given the seed words JAX derives
  for a (data position, microbatch, layer), the attention's keep masks
  and output equal JAX's;
- (f) ``stack_blocks``/``unstack_blocks`` round-trip, and stack as JAX's;
- (g) the refusals and warnings, with JAX's texts;
- (h) the point-to-point traffic of one step, by stage, kind, size and
  order, with M < P and M >= P;
- (i) the replicated leaves are bit-identical on every stage after a
  step, and a rank holds its stage's blocks only.

Tolerances are ``tests/test_torch_tensor.py``'s: fp32 loss 1e-5; grad
norms 1e-4 relative; updated params 2e-5.
"""

from __future__ import annotations

import json
import warnings

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
from differential_transformer_replication_tpu.models import model_forward as j_model_forward
from differential_transformer_replication_tpu.ops import flash as jflash
from differential_transformer_replication_tpu.parallel import create_mesh
from differential_transformer_replication_tpu.parallel import pipeline as jpipe
from differential_transformer_replication_tpu.train import checkpoint as jckpt
from differential_transformer_replication_tpu.train.step import (
    create_train_state as j_create_train_state,
)
from differential_transformer_replication_tpu_torch.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from differential_transformer_replication_tpu_torch.ops import flash as tflash
from differential_transformer_replication_tpu_torch.params import train_state_from_jax
from differential_transformer_replication_tpu_torch.parallel import pipeline
from differential_transformer_replication_tpu_torch.parallel.mesh import AXES, Line, Mesh
from differential_transformer_replication_tpu_torch.train.optim import leaves
from differential_transformer_replication_tpu_torch.train.step import make_train_step

import torch_ring_worker  # tests/: torch and the port only

FP32_TOL = 1e-5
GRAD_REL = 1e-4
PARAM_TOL = 2e-5
RANK_TIMEOUT_S = 240

# four layers: two a stage at P = 2, one at P = 4; four heads (two a
# tensor rank)
TINY = dict(vocab_size=64, n_embd=32, n_head=4, n_layer=4, block_size=32,
            n_terms=3, dropout=0.0, compute_dtype="float32")
COMMON = dict(micro_batch_size=4, max_iters=20, learning_rate=1e-3, min_lr=1e-4,
              warmup_iters=0, weight_decay=0.1, vocab_size=TINY["vocab_size"],
              anomaly_guard=False)
FAMILIES = ("control", "diff", "ndiff")
K_EVAL = 3

# (id, mesh, grad_acc_steps, family, extras) per world size: "jax" holds
# the step against JAX's; "eval", "dropout" and "loss_only" ask the
# worker for those parts
CASES = {
    2: [("diff-p2", dict(pipeline=2), 2, "diff", dict(jax=True, eval=True, dropout=True)),
        ("control-p2", dict(pipeline=2), 2, "control", dict(jax=True)),
        ("ndiff-p2", dict(pipeline=2), 2, "ndiff", dict(jax=True)),
        ("diff-p2-m1", dict(pipeline=2), 1, "diff", {})],
    4: [("diff-p4", dict(pipeline=4), 4, "diff", dict(jax=True, eval=True)),
        ("diff-p2-data2", dict(pipeline=2, data=2), 2, "diff", dict(jax=True, dropout=True)),
        ("diff-p2-tensor2", dict(pipeline=2, tensor=2), 2, "diff", dict(jax=True)),
        ("diff-p2-sequence2", dict(pipeline=2, sequence=2), 2, "diff", dict(jax=True)),
        ("diff-p4-m2", dict(pipeline=4), 2, "diff", {}),
        ("lambdas-p4", dict(pipeline=4), 4, "lambdas", dict(loss_only=True))],
}
STEP_IDS = [(P, i) for P, cases in CASES.items() for i, c in enumerate(cases)
            if not c[4].get("loss_only")]
JAX_IDS = [(P, i) for P, i in STEP_IDS if CASES[P][i][4].get("jax")]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _err(a, b) -> float:
    return float(np.max(np.abs(_np(a) - _np(b))))


def _flat(tree) -> list:
    """A param tree's leaves in the port's ``leaves`` order (sorted keys)."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for x in node:
                walk(x)
        else:
            out.append(np.asarray(node, np.float32))

    walk(tree)
    return out


def _model(family: str) -> dict:
    return dict(TINY, model="diff" if family == "lambdas" else family)


def _jcfg(mesh, A, family):
    return JTrainConfig(model=JModelConfig(attention_impl="xla", **_model(family)),
                        mesh=JMeshConfig(**mesh), grad_acc_steps=A, **COMMON)


def _port_cfg(mesh, A, family):
    return TrainConfig(model=ModelConfig(**_model(family)), mesh=MeshConfig(**mesh),
                       grad_acc_steps=A, sampler="replacement", **COMMON)


def _lambda_params(host: dict) -> dict:
    """``host``'s params with live lambdas (lambda_q 0.3, stream 0's
    lambda_k 0.2) and sharp attention (wq and wk x 20, so the two streams
    differ and each layer's lambda, its init schedule included, moves its
    output)."""
    params = jax.tree_util.tree_map(np.array, host["params"])
    for blk in params["blocks"]:
        blk["attn"]["wq"] = blk["attn"]["wq"] * 20
        blk["attn"]["wk"] = blk["attn"]["wk"] * 20
        blk["attn"]["lambda_q"] = np.full_like(blk["attn"]["lambda_q"], 0.3)
        lk = np.zeros_like(blk["attn"]["lambda_k"])
        lk[0] = 0.2
        blk["attn"]["lambda_k"] = lk
    return params


def _j_pipeline_step(host, mesh, A, family, x, y):
    """JAX's pipeline step from the canonical ``host`` state: (metrics,
    the updated params in the canonical layout)."""
    jcfg = _jcfg(mesh, A, family)
    jmesh = create_mesh(jcfg.mesh)
    stacked = jckpt._stack({k: v for k, v in host.items() if k != "guard"})
    sh = jpipe.pipeline_state_sharding(stacked, jmesh)
    jstate = jax.tree_util.tree_map(jax.device_put, stacked, sh)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        step = jpipe.make_pipeline_train_step(jcfg, jmesh, jstate)
        new, m = step(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    canon = jckpt.canonicalize_state(jax.device_get(new), TINY["n_layer"])
    return jax.tree_util.tree_map(np.asarray, m), canon["params"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's port step on its ranks; JAX's step, eval stream and
    lambda loss on the same inputs; the inputs themselves."""
    hosts, leaves_in = {}, {}
    for fam in FAMILIES:
        jcfg0 = _jcfg({}, 1, fam)
        host = jax.tree_util.tree_map(np.asarray,
                                      j_create_train_state(jax.random.PRNGKey(8), jcfg0))
        hosts[fam] = host
        state = train_state_from_jax(host, _port_cfg({}, 1, fam).resolved_model())
        for name, tree in (("p", state["params"]), ("mu", state["opt_state"]["mu"]),
                           ("nu", state["opt_state"]["nu"])):
            leaves_in.update({f"{fam}_{name}{i}": t.detach().numpy()
                              for i, t in enumerate(leaves(tree))})
    lam = _lambda_params(hosts["diff"])
    hosts["lambdas"] = dict(hosts["diff"], params=lam)
    leaves_in.update({f"lambdas_p{i}": a for i, a in enumerate(_flat(lam))})
    for name in ("mu", "nu"):
        leaves_in.update({f"lambdas_{name}{i}": leaves_in[f"diff_{name}{i}"]
                          for i in range(len(_flat(lam)))})
    rng = np.random.default_rng(47)
    V, T = TINY["vocab_size"], TINY["block_size"]
    batches = {A: (rng.integers(0, V, (A, 4, T)), rng.integers(0, V, (A, 4, T)))
               for A in (1, 2, 4)}
    xe, ye = rng.integers(0, V, (K_EVAL, 4, T)), rng.integers(0, V, (K_EVAL, 4, T))
    refs, outs = {}, {}
    for P, cases in CASES.items():
        meta = {"model": TINY, "train": dict(COMMON, sampler="replacement"),
                "count": 0, "step": 0, "cases": []}
        for i, (_, mesh, A, fam, extra) in enumerate(cases):
            case = {"mesh": mesh, "train": {"grad_acc_steps": A},
                    "model": {"model": _model(fam)["model"]}, "prefix": f"{fam}_",
                    "x": f"x{A}", "y": f"y{A}"}
            if extra.get("eval"):
                case.update(xe="xe", ye="ye")
            for k in ("dropout", "loss_only"):
                if extra.get(k):
                    case[k] = True
            meta["cases"].append(case)
            if extra.get("jax"):
                refs[(P, i)] = _j_pipeline_step(hosts[fam], mesh, A, fam, *batches[A])
        inputs = dict(leaves_in, meta=np.array(json.dumps(meta)),
                      device=np.array("cpu"), xe=xe, ye=ye,
                      **{f"{k}{A}": b[j] for A, b in batches.items()
                         for j, k in enumerate(("x", "y"))})
        outs[P] = torch_ring_worker.run_ranks("pipeline", P, tmp_path_factory.mktemp(f"pp{P}"),
                                              inputs, RANK_TIMEOUT_S)
    return dict(refs=refs, outs=outs, hosts=hosts, batches=batches, xe=xe, ye=ye)


def _out(o):
    return {k.split("/", 1)[1] if "/" in k else k: v for k, v in o.items()}


# ---------------------------------------------------------------------------
# (a) against JAX's pipeline step, (b) against the port's one-rank step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P,i", JAX_IDS, ids=[CASES[P][i][0] for P, i in JAX_IDS])
def test_pipeline_step_matches_jax_pipeline_step(P, i, runs):
    jm, jparams = runs["refs"][(P, i)]
    got = [_out(o) for o in runs["outs"][P]]
    o = got[0]
    assert abs(float(jm["loss"]) - float(o[f"{i}_loss"])) <= FP32_TOL
    assert abs(float(jm["grad_norm"]) - float(o[f"{i}_grad_norm"])) <= \
        GRAD_REL * float(jm["grad_norm"])
    want = _flat(jparams)
    for k, w in enumerate(want):
        assert _err(w, o[f"{i}_p{k}"]) <= PARAM_TOL, k
    # every rank: the same loss and norm, and the same gathered params
    for other in got[1:]:
        for name in ("loss", "grad_norm"):
            assert np.array_equal(other[f"{i}_{name}"], o[f"{i}_{name}"]), name
        for k in range(len(want)):
            assert np.array_equal(other[f"{i}_p{k}"], o[f"{i}_p{k}"]), k
    shape = JMeshConfig(**CASES[P][i][1]).shape
    for r, out in enumerate(got):
        assert tuple(out[f"{i}_coords"]) == tuple(np.unravel_index(r, shape))


@pytest.mark.parametrize("P,i", STEP_IDS, ids=[CASES[P][i][0] for P, i in STEP_IDS])
def test_pipeline_step_matches_the_one_rank_step(P, i, runs):
    """The one-rank step with grad_acc_steps = M on the global batch: the
    pipeline is gradient accumulation with the layers split."""
    _, _, A, fam, _ = CASES[P][i]
    cfg = _port_cfg({}, A, fam)
    state = train_state_from_jax(runs["hosts"][fam], cfg.resolved_model())
    x, y = runs["batches"][A]
    state, m = make_train_step(cfg)(state, {"x": torch.from_numpy(x),
                                            "y": torch.from_numpy(y)})
    o = _out(runs["outs"][P][0])
    assert abs(m["loss"] - float(o[f"{i}_loss"])) <= FP32_TOL
    assert abs(m["grad_norm"] - float(o[f"{i}_grad_norm"])) <= GRAD_REL * m["grad_norm"]
    for k, t in enumerate(leaves(state["params"])):
        assert _err(t, o[f"{i}_p{k}"]) <= PARAM_TOL, k


# ---------------------------------------------------------------------------
# (c) eval, (d) the global layer index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P,i", [(2, 0), (4, 0)], ids=["pipeline2", "pipeline4"])
def test_eval_stream_matches_jax_and_the_per_batch_mean(P, i, runs):
    _, mesh, A, fam, _ = CASES[P][i]
    jcfg = _jcfg(mesh, A, fam)
    jmesh = create_mesh(jcfg.mesh)
    params = jpipe.stack_blocks(jax.tree_util.tree_map(jnp.asarray,
                                                       runs["hosts"][fam]["params"]))
    want = float(jpipe.make_pipeline_eval_many(jcfg, jmesh)(
        params, jnp.asarray(runs["xe"]), jnp.asarray(runs["ye"])))
    for o in runs["outs"][P]:
        o = _out(o)
        assert abs(float(o[f"{i}_eval_many"]) - want) <= FP32_TOL
        np.testing.assert_allclose(float(o[f"{i}_eval_many"]),
                                   np.mean(o[f"{i}_eval_each"]), rtol=1e-5)


def test_a_later_stage_gives_its_blocks_their_global_layer_index(runs):
    """With live lambdas, each layer's lambda reads its init schedule at
    its GLOBAL index: the pipeline=4 loss (one layer a stage, local index
    1 everywhere) equals JAX's pipeline loss and the one-device mean."""
    i = [c[0] for c in CASES[4]].index("lambdas-p4")
    _, mesh, A, fam, _ = CASES[4][i]
    jcfg = _jcfg(mesh, A, fam)
    params = jax.tree_util.tree_map(jnp.asarray, runs["hosts"]["lambdas"]["params"])
    x, y = (jnp.asarray(t) for t in runs["batches"][A])
    m = jcfg.resolved_model()
    ref = float(jnp.mean(jnp.stack([j_model_forward(params, x[k], m, targets=y[k])[1]
                                    for k in range(A)])))
    got_j = float(jpipe.make_pipeline_loss(m, create_mesh(jcfg.mesh))(
        jpipe.stack_blocks(params), x, y))
    assert abs(got_j - ref) <= FP32_TOL
    for o in runs["outs"][4]:
        assert abs(float(_out(o)[f"{i}_loss"]) - ref) <= FP32_TOL
    # a stage that passed its blocks their local index (1 on every stage
    # here) computes another loss, by ten times the tolerance and more
    from differential_transformer_replication_tpu_torch.models import common, diff

    tparams = train_state_from_jax(runs["hosts"]["lambdas"],
                                   _port_cfg({}, A, fam).resolved_model())["params"]
    tcfg = _port_cfg({}, A, fam).resolved_model()
    local = []
    with torch.no_grad():
        for k in range(A):
            h = diff.embed(tparams, torch.tensor(np.asarray(x[k])), tcfg)
            for blk in tparams["blocks"]:
                h = diff.block_forward(h, blk, 1, tcfg)
            local.append(float(common.tail_and_loss(h, tparams, tcfg,
                                                    torch.tensor(np.asarray(y[k])))[1]))
    assert abs(np.mean(local) - ref) > 10 * FP32_TOL


# ---------------------------------------------------------------------------
# (e) dropout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P,i", [(2, 0), (4, 1)], ids=["pipeline2", "pipeline2-data2"])
def test_dropout_through_the_pipeline(P, i, runs):
    """Seed 2 twice, seed 3, no seed at dropout 0.3, and the dropout-free
    model: deterministic per seed, varying across seeds, inert without
    one; every rank the same losses; the gradients flow."""
    got = [_out(o) for o in runs["outs"][P]]
    la, lb, lc, l0, lref = got[0][f"{i}_dropout"]
    assert la == lb and np.isfinite(la)
    assert la != lc
    assert l0 == lref
    for o in got[1:]:
        assert np.array_equal(o[f"{i}_dropout"], got[0][f"{i}_dropout"])
    for o in got:
        gsq = float(o[f"{i}_dropout_gsq"])
        assert np.isfinite(gsq) and gsq > 0


def test_attention_masks_of_a_data_position_microbatch_and_layer_equal_jax():
    """JAX's pipeline key for (data position, microbatch, layer): fold the
    step key with each in turn, then the block's and the attention's
    splits. Given that key's seed words, the port's keep masks equal
    JAX's bit for bit, and its head-major attention JAX's flash
    attention with the key."""
    S, B, T, H, d, dv, rate = 2, 2, 32, 2, 8, 16, 0.3
    rng = np.random.default_rng(66)
    qs = rng.standard_normal((S, B, T, H, d)).astype(np.float32)
    ks = rng.standard_normal((S, B, T, H, d)).astype(np.float32)
    v = rng.standard_normal((B, T, H, dv)).astype(np.float32)
    coeffs = (0.5 * rng.standard_normal((S, H))).astype(np.float32)
    coeffs[0] = 1.0
    from differential_transformer_replication_tpu_torch.parallel.shard_flash import (
        shard_flash_multi_stream_attention,
    )

    seen = set()
    for pos, mb, li in ((0, 0, 1), (1, 0, 1), (0, 2, 1), (0, 0, 3)):
        key = jax.random.PRNGKey(11)
        for i in (pos, mb, li):
            key = jax.random.fold_in(key, i)
        r_attn = jax.random.split(key, 2)[0]  # block_forward: attention, ffn
        r_att = jax.random.split(r_attn, 2)[0]  # _attn: kernel, output
        words = np.asarray(jflash.dropout_seed_from_rng(r_att))
        seen.add(words.tobytes())
        want = np.asarray(jflash.dropout_keep_reference(jnp.asarray(words), B * H, S, T,
                                                        rate))
        got = tflash.dropout_keep_reference(torch.from_numpy(words), B * H, S, T, rate)
        assert np.array_equal(want, got.numpy())
        jout = jflash.multi_stream_flash_attention(
            *(jnp.asarray(a) for a in (qs, ks, v, coeffs)), dropout_rate=rate,
            dropout_rng=r_att, interpret=True)
        tout = shard_flash_multi_stream_attention(
            *(torch.from_numpy(a) for a in (qs, ks, v, coeffs)), dropout_rate=rate,
            dropout_seed=torch.from_numpy(words))
        assert _err(jout, tout) <= FP32_TOL
    assert len(seen) == 4  # each position, microbatch and layer its own masks


# ---------------------------------------------------------------------------
# (f) layouts, (g) refusals
# ---------------------------------------------------------------------------


def test_stack_unstack_round_trip_and_stack_as_jax():
    host = jax.tree_util.tree_map(np.asarray, j_create_train_state(
        jax.random.PRNGKey(1), _jcfg({}, 1, "diff")))
    state = train_state_from_jax(host, _port_cfg({}, 1, "diff").resolved_model())
    params = state["params"]
    stacked = pipeline.stack_blocks(params)
    jstacked = jpipe.stack_blocks(host["params"])
    assert [tuple(t.shape) for t in leaves(stacked["blocks"])] == \
        [tuple(a.shape) for a in _flat(jstacked["blocks"])]
    for a, b in zip(leaves(stacked), _flat(jstacked)):
        assert np.array_equal(_np(a), b)
    back = pipeline.unstack_blocks(stacked, TINY["n_layer"])
    assert len(back["blocks"]) == TINY["n_layer"]
    for a, b in zip(leaves(back), leaves(params)):
        assert torch.equal(a, b.detach())


def _mesh(**axes) -> Mesh:
    """Rank 0 of a mesh of ``axes`` with its lines, no process group (the
    refusals come before any collective)."""
    shape = tuple(axes.get(a, 1) for a in AXES)
    live = tuple(a for a, n in zip(AXES, shape) if n > 1)
    lines = {}
    for key in [(a,) for a in live] + [tuple(a for a in live if a != "pipeline")]:
        if key:
            n = int(np.prod([axes[a] for a in key]))
            lines[key] = Line(tuple(range(n)), 0)
    return Mesh(shape, 0, (0,) * 5, torch.device("cpu"), "gloo", lines)


def _jax_message(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_refusals_and_warnings_carry_jax_texts():
    m3 = ModelConfig(**dict(TINY, n_layer=3))
    jm3 = JModelConfig(**dict(TINY, n_layer=3))
    # a mesh without a pipeline axis; layers that do not split
    want = _jax_message(lambda: jpipe.make_pipeline_loss(
        JModelConfig(**TINY), create_mesh(JMeshConfig(data=2))))
    with pytest.raises(ValueError) as e:
        pipeline.make_pipeline_loss(ModelConfig(**TINY), _mesh(data=2))
    assert str(e.value) == want and "pipeline axis must be > 1" in want
    want = _jax_message(lambda: jpipe.make_pipeline_loss(
        jm3, create_mesh(JMeshConfig(pipeline=2, data=2))))
    with pytest.raises(ValueError) as e:
        pipeline.make_pipeline_loss(m3, _mesh(pipeline=2, data=2))
    assert str(e.value) == want == "n_layer=3 not divisible by pipeline=2"
    with pytest.raises(ValueError, match="n_layer=3 not divisible by pipeline=2"):
        TrainConfig(model=m3, mesh=MeshConfig(pipeline=2))
    # a micro-batch that does not split over data x fsdp
    jcfg = _jcfg(dict(pipeline=2, data=2), 2, "diff").replace(micro_batch_size=3)
    want = _jax_message(lambda: jpipe.make_pipeline_train_step(
        jcfg, create_mesh(jcfg.mesh), None))
    with pytest.raises(ValueError) as e:
        _port_cfg(dict(pipeline=2, data=2), 2, "diff").replace(micro_batch_size=3)
    assert str(e.value) == want
    # fsdp acts as a second data axis; fewer microbatches than stages
    cfg = _port_cfg(dict(pipeline=2, fsdp=2), 1, "diff")
    with pytest.warns(UserWarning) as rec:
        pipeline.make_pipeline_train_step(cfg, _mesh(pipeline=2, fsdp=2))
    texts = [str(w.message) for w in rec]
    assert any("the fsdp axis acts as a SECOND DATA axis only" in t for t in texts)
    assert "grad_acc_steps=1 < pipeline stages 2: the GPipe bubble dominates; use at " \
           "least 2 (ideally a few x) microbatches" in texts
    # the port runs tensor and sequence inside each stage: no warning there
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pipeline.make_pipeline_train_step(_port_cfg(dict(pipeline=2, tensor=2), 2, "diff"),
                                          _mesh(pipeline=2, tensor=2))


# ---------------------------------------------------------------------------
# (h) the traffic, (i) the replicated leaves
# ---------------------------------------------------------------------------


def _traffic_want(stage: int, P: int, M: int, n: int) -> list:
    """One GPipe step's sends (0) and receives (1) of a stage, with the
    peer's stage: the forward ticks receive from the stage before and
    send to the next, microbatch by microbatch; the backward ticks, in
    reverse, receive the gradient from the next stage and send the
    input's gradient to the stage before."""
    out = []
    for _ in range(M):
        if stage > 0:
            out.append((1, stage - 1, n))
        if stage < P - 1:
            out.append((0, stage + 1, n))
    for _ in range(M):
        if stage < P - 1:
            out.append((1, stage + 1, n))
        if stage > 0:
            out.append((0, stage - 1, n))
    return out


@pytest.mark.parametrize("P,i", STEP_IDS, ids=[CASES[P][i][0] for P, i in STEP_IDS])
def test_point_to_point_traffic_of_a_step_by_stage_kind_size_and_order(P, i, runs):
    _, mesh, A, _, _ = CASES[P][i]
    n_stages = mesh["pipeline"]
    rows = COMMON["micro_batch_size"] // mesh.get("data", 1)
    n = rows * (TINY["block_size"] // mesh.get("sequence", 1)) * TINY["n_embd"]
    for o in runs["outs"][P]:
        o = _out(o)
        stage = int(o[f"{i}_coords"][-1])
        got = [tuple(int(v) for v in row) for row in o[f"{i}_traffic"]]
        assert got == _traffic_want(stage, n_stages, A, n), (stage, got)


@pytest.mark.parametrize("P,i", STEP_IDS, ids=[CASES[P][i][0] for P, i in STEP_IDS])
def test_replicated_leaves_are_bit_identical_on_every_stage(P, i, runs):
    """After a step each rank's own embeddings, ln_f and lm_head (its
    tensor shard of them) equal those of the same tensor index on every
    other stage, bit for bit; a rank holds its stage's blocks alone."""
    got = [_out(o) for o in runs["outs"][P]]
    n_rep = len([k for k in got[0] if k.startswith(f"{i}_rep")])
    assert n_rep > 0
    by_rest = {}
    for o in got:
        coords = tuple(int(c) for c in o[f"{i}_coords"])
        by_rest.setdefault(coords[:-1], []).append(o)
    for line in by_rest.values():
        assert len(line) == CASES[P][i][1]["pipeline"]
        for o in line[1:]:
            for k in range(n_rep):
                assert np.array_equal(o[f"{i}_rep{k}"], line[0][f"{i}_rep{k}"]), k
    # the state at rest: the replicated leaves plus 1/P of the blocks
    host = runs["hosts"][CASES[P][i][3]]["params"]
    blocks = sum(a.size for a in _flat(host["blocks"]))
    rest = sum(a.size for a in _flat({k: v for k, v in host.items() if k != "blocks"}))
    mesh = CASES[P][i][1]
    if mesh.get("tensor", 1) == 1:
        for o in got:
            assert int(o[f"{i}_rest"]) == rest + blocks // mesh["pipeline"]
