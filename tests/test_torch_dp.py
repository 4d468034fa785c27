"""Data parallelism and FSDP of the port against the JAX package, on the
CPU.

The ranks are processes of ``tests/torch_ring_worker.py`` (torch and
the port only), joined through a ``file://`` rendezvous under
``tmp_path`` with a time limit on every join; the JAX side runs on the
8 virtual CPU devices of ``tests/conftest.py``. Both sides start from
JAX-initialized params (``train_state_from_jax``). Held here:

- (a) one train step of ``make_sharded_train_step`` at ``data=2`` with
  ``dp_overlap`` on and off, ``fsdp=2``, ``data=2, fsdp=2`` and
  ``data=2, sequence=2`` (the ring, and Ulysses), at ``grad_acc_steps``
  1 and 2, against JAX ``make_sharded_train_step`` on ``create_mesh`` of
  the same ``MeshConfig`` and the same global batch: loss, grad norm,
  per-group norms and every updated param (twin of JAX
  ``tests/test_parallel.py::TestShardedStep`` on meshes without
  ``tensor``); the params equal on every rank afterwards (gathered
  under fsdp);
- (b) the collectives of each path, by kind and size, in order: the
  overlap path's bucket means in backward order, then the loss (twin of
  JAX ``tests/test_fused_ffn.py::test_bucket_counts``); one whole-tree
  mean at ``grad_acc_steps`` 2; one flat all-reduce; under fsdp a
  gather per bucket in forward order and a reduce-scatter per bucket in
  backward order, each microbatch;
- (c) ``overlap_eligible`` against JAX's on JAX's mesh list;
- (d) dropout: each rank's attention on its shard with the seed words of
  its mesh position equals JAX's ``shard_flash`` (data, data x fsdp)
  and ring (data x sequence) attention on that shard, forward and every
  gradient, so the keep masks are JAX's for the position; the overlap
  path folds the data index into the step's seed (twin of
  ``test_overlap_shards_draw_independent_dropout_masks``);
- (e) the state at rest under fsdp: 1/fsdp of the elements, up to the
  padding; the refusals of a batch the mesh cannot split and of the
  tensor and pipeline axes.

The JAX side runs ``attention_impl="xla"`` in the step twins (dense
attention, the same math as the port's plain head-major and token-major
routes at dropout 0; its Pallas kernels are held against the port in
``tests/test_torch_flash_bh.py`` and ``tests/test_torch_ring.py``), and
its Pallas kernels in interpret mode for the dropout masks.

Tolerances are the ring's: fp32 loss 1e-5; grad norms 1e-4 relative;
gradients 1e-4 of each tensor's max; updated params 2e-5.
"""

from __future__ import annotations

import copy
import json
import math
from types import SimpleNamespace

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
from differential_transformer_replication_tpu.ops import flash as jflash
from differential_transformer_replication_tpu.parallel import create_mesh
from differential_transformer_replication_tpu.parallel.dp_step import (
    make_sharded_train_step as j_make_sharded_train_step,
    overlap_eligible as j_overlap_eligible,
)
from differential_transformer_replication_tpu.parallel.ring import (
    ring_multi_stream_attention as j_ring,
)
from differential_transformer_replication_tpu.parallel.shard_flash import (
    shard_flash_multi_stream_attention as j_shard_flash,
)
from differential_transformer_replication_tpu.train.step import (
    create_train_state as j_create_train_state,
)
from differential_transformer_replication_tpu_torch.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from differential_transformer_replication_tpu_torch.models import init_model
from differential_transformer_replication_tpu_torch.ops.dropout import fold_seed
from differential_transformer_replication_tpu_torch.params import train_state_from_jax
from differential_transformer_replication_tpu_torch.parallel import dp_step, sharding
from differential_transformer_replication_tpu_torch.train import __main__ as cli
from differential_transformer_replication_tpu_torch.train.optim import leaves
from differential_transformer_replication_tpu_torch.train.step import (
    make_train_step,
    train_state,
)

import torch_ring_worker  # tests/: torch and the port only

FP32_TOL = 1e-5
GRAD_REL = 1e-4
PARAM_TOL = 2e-5
RANK_TIMEOUT_S = 180

TINY = dict(vocab_size=64, n_embd=32, n_head=2, n_layer=2, block_size=32,
            n_terms=3, dropout=0.0, compute_dtype="float32")
COMMON = dict(micro_batch_size=4, max_iters=20, learning_rate=3e-3, min_lr=3e-4,
              warmup_iters=0, weight_decay=0.1, vocab_size=TINY["vocab_size"],
              anomaly_warmup_steps=1)

# (id, mesh, TrainConfig overrides, ModelConfig overrides): one launch of
# ranks per world size
CASES = {
    2: [("data2-overlap-bucket1", dict(data=2), dict(dp_bucket_layers=1), {}),
        ("data2-overlap-acc2", dict(data=2), dict(grad_acc_steps=2), {}),
        ("data2-flat", dict(data=2), dict(dp_overlap=False), {}),
        ("data2-flat-acc2", dict(data=2), dict(dp_overlap=False, grad_acc_steps=2), {}),
        ("fsdp2", dict(fsdp=2), {}, {}),
        ("fsdp2-acc2", dict(fsdp=2), dict(grad_acc_steps=2), {})],
    4: [("data2-fsdp2", dict(data=2, fsdp=2), {}, {}),
        ("data2-fsdp2-acc2", dict(data=2, fsdp=2), dict(grad_acc_steps=2), {}),
        ("data2-seq2-ring", dict(data=2, sequence=2), {}, {}),
        ("data2-seq2-ring-acc2", dict(data=2, sequence=2), dict(grad_acc_steps=2), {}),
        ("data2-seq2-ulysses-acc2", dict(data=2, sequence=2), dict(grad_acc_steps=2),
         dict(sequence_impl="ulysses"))],
}
CASE_IDS = [(P, i) for P, cases in CASES.items() for i in range(len(cases))]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _err(a, b) -> float:
    return float(np.max(np.abs(_np(a) - _np(b))))


def _top(x) -> float:
    return max(float(np.max(np.abs(_np(x)))), 1e-12)


def _leaf_arrays(tree, prefix):
    """A param tree's leaves in the port's ``leaves`` order (sorted keys)
    as npz entries ``prefix0``, ``prefix1``, ..."""
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


def _jcfg(mesh, train, model):
    return JTrainConfig(model=JModelConfig(model="diff", attention_impl="xla",
                                           **dict(TINY, **model)),
                        mesh=JMeshConfig(**mesh), **dict(COMMON, **train))


def _port_cfg(mesh, train, model):
    return TrainConfig(model=ModelConfig(model="diff", **dict(TINY, **model)),
                       mesh=MeshConfig(**mesh), sampler="replacement",
                       **dict(COMMON, **train))


@pytest.fixture(scope="module")
def mesh_steps(tmp_path_factory):
    """Each case's port step on its ranks and JAX's step on its mesh,
    from one JAX-initialized state and one global batch per A."""
    jcfg0 = _jcfg({}, {}, {})
    host = jax.tree_util.tree_map(np.asarray,
                                  j_create_train_state(jax.random.PRNGKey(8), jcfg0))
    state = train_state_from_jax(host, _port_cfg({}, {}, {}).resolved_model())
    rng = np.random.default_rng(41)
    batches = {A: (rng.integers(0, TINY["vocab_size"], (A, 4, TINY["block_size"])),
                   rng.integers(0, TINY["vocab_size"], (A, 4, TINY["block_size"])))
               for A in (1, 2)}
    meta_base = {"model": TINY, "train": dict(COMMON, sampler="replacement"),
                 "count": state["opt_state"]["count"], "step": state["step"],
                 "guard": {k: float(v) if k == "ema" else int(v)
                           for k, v in state["guard"].items()}}
    leaves_in = {}
    for name, tree in (("p", state["params"]), ("mu", state["opt_state"]["mu"]),
                       ("nu", state["opt_state"]["nu"])):
        leaves_in.update({f"{name}{i}": t.detach().numpy()
                          for i, t in enumerate(leaves(tree))})
    refs, outs = {}, {}
    for P, cases in CASES.items():
        meta = dict(meta_base, cases=[])
        for i, (_, mesh, train, model) in enumerate(cases):
            A = train.get("grad_acc_steps", 1)
            meta["cases"].append({"mesh": mesh, "train": train, "model": dict(model, model="diff"),
                                  "x": f"x{A}", "y": f"y{A}"})
            jcfg = _jcfg(mesh, train, model)
            jmesh = create_mesh(jcfg.mesh)
            jstate = jax.tree_util.tree_map(jnp.asarray, host)
            jstep = j_make_sharded_train_step(jcfg, jmesh, jstate)
            x, y = batches[A]
            jnew, jm = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
            refs[(P, i)] = (jax.tree_util.tree_map(np.asarray, jm),
                            _leaf_arrays(jnew["params"], "p"))
        inputs = dict(leaves_in, meta=np.array(json.dumps(meta)), device=np.array("cpu"),
                      x1=batches[1][0], y1=batches[1][1], x2=batches[2][0],
                      y2=batches[2][1])
        outs[P] = torch_ring_worker.run_ranks("mesh_step", P,
                                              tmp_path_factory.mktemp(f"mesh{P}"),
                                              inputs, RANK_TIMEOUT_S)
    return refs, outs, state


@pytest.mark.parametrize("P,i", CASE_IDS, ids=[CASES[P][i][0] for P, i in CASE_IDS])
def test_mesh_step_matches_jax_sharded_step(P, i, mesh_steps):
    refs, outs, _ = mesh_steps
    jm, jp = refs[(P, i)]
    o = outs[P][0]
    assert abs(float(jm["loss"]) - float(o[f"{i}_loss"])) <= FP32_TOL
    assert abs(float(jm["grad_norm"]) - float(o[f"{i}_grad_norm"])) <= \
        GRAD_REL * float(jm["grad_norm"])
    jg = np.asarray(jm["grad_norm_groups"])
    assert np.max(np.abs(jg - o[f"{i}_groups"])) <= GRAD_REL * float(np.max(jg))
    for k in range(len(jp)):
        assert _err(jp[f"p{k}"], o[f"{i}_p{k}"]) <= PARAM_TOL, k
    # every rank ends with the same params (gathered under fsdp): bit for
    # bit on each data line, and here on every line
    for other in outs[P][1:]:
        for k in range(len(jp)):
            assert np.array_equal(other[f"{i}_p{k}"], o[f"{i}_p{k}"]), k
        for name in ("loss", "grad_norm", "groups"):
            assert np.array_equal(other[f"{i}_{name}"], o[f"{i}_{name}"]), name
    # the ranks sit at the row-major coordinates of their world rank
    shape = JMeshConfig(**CASES[P][i][1]).shape
    for r, out in enumerate(outs[P]):
        assert tuple(out[f"{i}_coords"]) == tuple(np.unravel_index(r, shape))


def _bucket_sizes(params, bucket_layers):
    return [sum(int(t.numel()) for t in leaves(b.subtree(params)))
            for b in sharding.param_buckets(params, bucket_layers)]


@pytest.mark.parametrize("P,i", CASE_IDS, ids=[CASES[P][i][0] for P, i in CASE_IDS])
def test_collectives_per_path_kind_size_and_order(P, i, mesh_steps):
    _, outs, state = mesh_steps
    name, mesh, train, _ = CASES[P][i]
    A = train.get("grad_acc_steps", 1)
    total = sum(int(t.numel()) for t in leaves(state["params"]))
    sizes = _bucket_sizes(state["params"], train.get("dp_bucket_layers", 2))
    ALL_REDUCE, REDUCE_SCATTER, ALL_GATHER = 0, 1, 2
    for o in outs[P]:
        calls = [tuple(c) for c in o[f"{i}_calls"]]
        if mesh.get("fsdp", 1) > 1:
            f = mesh["fsdp"]
            shard = [-(-n // f) for n in sizes]
            rest = mesh.get("data", 1) > 1
            per_micro = [(ALL_GATHER, s) for s in shard]
            for s in reversed(shard):  # backward order: tail first
                per_micro.append((REDUCE_SCATTER, s * f))
                if rest:
                    per_micro.append((ALL_REDUCE, s))
            # then the loss over the world, and the per-group squared sums
            # over the fsdp line
            want = per_micro * A + [(ALL_REDUCE, 1), (ALL_REDUCE, TINY["n_layer"] + 2)]
        elif name.startswith("data2-overlap") and A == 1:
            # one bucket mean each: tail, blocks from the last, embeddings
            want = [(ALL_REDUCE, n) for n in reversed(sizes)] + [(ALL_REDUCE, 1)]
            assert len(sizes) == math.ceil(TINY["n_layer"] / train["dp_bucket_layers"]) + 2
        elif name.startswith("data2-overlap"):
            want = [(ALL_REDUCE, total), (ALL_REDUCE, 1)]  # one whole-tree mean
        else:
            want = [(ALL_REDUCE, total + 1)]  # the flat step: loss and grads
        assert calls == want, (name, calls)


def test_overlap_eligible_equals_jax_on_jax_meshes():
    """JAX's list (``tests/test_fused_ffn.py:358-360``); the port's
    ``MeshConfig`` refuses ``tensor``, so its side reads the same fields
    from a stand-in."""
    base = dict(vocab_size=128, learning_rate=1e-2, min_lr=1e-3, warmup_iters=2,
                max_iters=100, control_head_multiplier=1)
    meshes = [dict(data=8), dict(data=4, tensor=2), dict(data=4, fsdp=2),
              dict(data=4, sequence=2), dict(data=1)]
    for overlap in (True, False):
        for m in meshes:
            jcfg = JTrainConfig(model=JModelConfig(model="diff", **{
                k: v for k, v in TINY.items() if k != "vocab_size"}), mesh=JMeshConfig(**m),
                dp_overlap=overlap, **base)
            full = dict(dict(data=1, fsdp=1, tensor=1, sequence=1, pipeline=1), **m)
            stand_in = SimpleNamespace(dp_overlap=overlap, mesh=SimpleNamespace(**full))
            assert dp_step.overlap_eligible(stand_in) == j_overlap_eligible(jcfg), (m, overlap)
    assert dp_step.overlap_eligible(_port_cfg(dict(data=2), {}, {}))
    assert not dp_step.overlap_eligible(_port_cfg(dict(data=2, sequence=2), {}, {}))


def test_fsdp_state_at_rest_is_a_shard_per_rank(mesh_steps):
    _, outs, state = mesh_steps
    total = sum(int(t.numel()) for t in leaves(state["params"]))
    for P, i, f in ((2, 4, 2), (4, 0, 2)):
        n_buckets = len(_bucket_sizes(state["params"], 2))
        for o in outs[P]:
            rest = o[f"{i}_rest"]
            # params, mu and nu alike: 1/fsdp of the elements, up to the
            # padding of each bucket to a multiple of fsdp
            assert rest[0] == rest[1] == rest[2]
            assert total / f <= rest[0] < total / f + n_buckets


# ---------------------------------------------------------------------------
# (d) dropout
# ---------------------------------------------------------------------------

ATTN = dict(S=2, B=4, T=32, H=2, d=8, dv=16)
ATTN_CASES = {2: [dict(data=2)], 4: [dict(data=2, fsdp=2), dict(data=2, sequence=2)]}


@pytest.mark.parametrize("P", [2, 4])
def test_each_rank_draws_jax_attention_masks_for_its_mesh_position(P, tmp_path):
    """At dropout 0.3 every rank's attention output and gradients on its
    shard equal JAX's on that shard, given the seed words JAX derives
    for the rank's mesh position (``fold_in(key, position)``): the flat
    path's shard_flash fold, the ring's full fold over data x sequence
    (whose exchanges run along the sequence line only). The masks are
    live: rate 0 gives another output."""
    S, B, T, H, d, dv = (ATTN[k] for k in ("S", "B", "T", "H", "d", "dv"))
    rng = np.random.default_rng(60 + P)
    qs = rng.standard_normal((S, B, T, H, d)).astype(np.float32)
    ks = rng.standard_normal((S, B, T, H, d)).astype(np.float32)
    v = rng.standard_normal((B, T, H, dv)).astype(np.float32)
    g = rng.standard_normal((B, T, H, dv)).astype(np.float32)
    coeffs = (0.5 * rng.standard_normal((S, H))).astype(np.float32)
    coeffs[0] = 1.0
    key = jax.random.PRNGKey(P)
    words = np.stack([np.asarray(jflash.dropout_seed_from_rng(
        jax.random.fold_in(key, p)))[0] for p in range(P)])
    rate = 0.3
    refs = []
    for m in ATTN_CASES[P]:
        jmesh = create_mesh(JMeshConfig(**m))
        fn = j_ring if m.get("sequence", 1) > 1 else j_shard_flash

        def jfn(qs, ks, v, c, g, fn=fn, jmesh=jmesh):
            kw = dict(dropout_rate=rate, dropout_rng=key)
            args = (jmesh, "pallas") if fn is j_ring else (jmesh,)
            out, vjp = jax.vjp(lambda *a: fn(*a, *args, **kw), qs, ks, v, c)
            return (out, *vjp(g))

        refs.append(jax.jit(jfn)(*(jnp.asarray(a) for a in (qs, ks, v, coeffs, g))))
    meta = {"cases": [{"mesh": m, "rate": rate} for m in ATTN_CASES[P]]}
    outs = torch_ring_worker.run_ranks("mesh_attention", P, tmp_path, dict(
        meta=np.array(json.dumps(meta)), qs=qs, ks=ks, v=v, g=g, coeffs=coeffs,
        words=words, device=np.array("cpu")), RANK_TIMEOUT_S)
    for c, (m, (jout, jdq, jdk, jdv, jdc)) in enumerate(zip(ATTN_CASES[P], refs)):
        n_seq = m.get("sequence", 1)
        n_batch = m.get("data", 1) * m.get("fsdp", 1)
        Bl, Tl = B // n_batch, T // n_seq
        got = {k: np.zeros_like(ref) for k, ref in (("out", jout), ("dv", jdv))}
        got["dqs"], got["dks"] = np.zeros_like(jdq), np.zeros_like(jdk)
        for o in outs:
            b, s, pos = (int(x) for x in o[f"{c}_where"])
            rows, cols = slice(b * Bl, (b + 1) * Bl), slice(s * Tl, (s + 1) * Tl)
            # the position is JAX's fold: data major, sequence last
            assert pos == b * n_seq + s
            got["out"][rows, cols] = o[f"{c}_out"]
            got["dv"][rows, cols] = o[f"{c}_dv"]
            got["dqs"][:, rows, cols] = o[f"{c}_dqs"]
            got["dks"][:, rows, cols] = o[f"{c}_dks"]
        assert _err(jout, got["out"]) <= FP32_TOL, m
        for name, ref in (("dqs", jdq), ("dks", jdk), ("dv", jdv)):
            assert _err(ref, got[name]) <= GRAD_REL * _top(ref), (m, name)
        dc = sum(o[f"{c}_dcoeffs"] for o in outs)
        assert _err(jdc, dc) <= GRAD_REL * _top(jdc), m
    # the masks are live: without them the output differs
    jmesh = create_mesh(JMeshConfig(**ATTN_CASES[P][0]))
    plain = jax.jit(lambda *a: j_shard_flash(*a, jmesh))(
        *(jnp.asarray(a) for a in (qs, ks, v, coeffs)))
    assert _err(plain, refs[0][0]) > 1e-2


def test_overlap_shards_draw_independent_dropout_masks(tmp_path):
    """Two data shards each holding the SAME example at dropout 0.5: the
    overlap step folds the data index into the step's seed, so its loss
    is the mean of the single-card losses with seeds fold_seed(seed, i)
    (each rank's masks its own) and not the single-card loss with the
    seed itself (the correlated-mask bug JAX's test guards against)."""
    model = dict(TINY, model="diff", dropout=0.5)
    cfg = _port_cfg(dict(data=2), dict(micro_batch_size=2), dict(dropout=0.5))
    params = init_model(torch.Generator().manual_seed(4), cfg.resolved_model())
    rng = np.random.default_rng(70)
    one = rng.integers(0, TINY["vocab_size"], (1, 1, TINY["block_size"] + 1))
    tiled = np.tile(one, (1, 2, 1))
    seed = 7
    single = _port_cfg({}, dict(micro_batch_size=1), dict(dropout=0.5))

    def single_loss(s):
        # a fresh state each time: the step updates its params in place
        st = train_state(copy.deepcopy(params), single, "cpu")
        _, m = make_train_step(single)(st, {"x": torch.from_numpy(one[..., :-1]),
                                            "y": torch.from_numpy(one[..., 1:])}, s)
        return m["loss"]

    meta = {"model": model, "train": dict(COMMON, sampler="replacement",
                                          micro_batch_size=2),
            "count": 0, "step": 0,
            "guard": {"ema": 0.0, "good_steps": 0, "bad_streak": 0, "skipped": 0},
            "cases": [{"mesh": dict(data=2), "train": {}, "model": {}, "seed": seed}]}
    inputs = {"meta": np.array(json.dumps(meta)), "device": np.array("cpu"),
              "x": tiled[..., :-1], "y": tiled[..., 1:]}
    zeros = {f"{n}{i}": np.zeros_like(t.numpy()) for n in ("mu", "nu")
             for i, t in enumerate(leaves(params))}
    inputs.update({f"p{i}": t.numpy() for i, t in enumerate(leaves(params))}, **zeros)
    outs = torch_ring_worker.run_ranks("mesh_step", 2, tmp_path, inputs, RANK_TIMEOUT_S)
    got = float(outs[0]["0_loss"])
    per_shard = [single_loss(fold_seed(seed, i)) for i in range(2)]
    assert abs(got - sum(per_shard) / 2) <= FP32_TOL
    assert abs(got - single_loss(seed)) > 1e-4
    assert float(outs[1]["0_loss"]) == got


# ---------------------------------------------------------------------------
# (e) refusals
# ---------------------------------------------------------------------------


def test_a_batch_or_an_axis_the_mesh_cannot_take_is_refused(capsys):
    with pytest.raises(ValueError, match=r"micro_batch_size 6 must split into data x "
                                         r"fsdp = 2 x 2 = 4"):
        TrainConfig(mesh=MeshConfig(data=2, fsdp=2), micro_batch_size=6)
    assert TrainConfig(mesh=MeshConfig(data=2, fsdp=2), micro_batch_size=8).mesh.fsdp == 2
    # the pipeline axis runs, and refuses what JAX's pipeline refuses,
    # with its texts: layers that do not split into the stages, a batch
    # that does not split over data x fsdp
    assert MeshConfig(pipeline=2).pipeline == 2
    with pytest.raises(ValueError, match="n_layer=3 not divisible by pipeline=2"):
        cli.run(["--tokens", "t.npy", "--n-layer", "3", "--pipeline-parallel", "2"])
    with pytest.raises(ValueError, match=r"micro_batch_size=6 not divisible by the "
                                         r"data\*fsdp shard count 4"):
        TrainConfig(mesh=MeshConfig(data=2, fsdp=2, pipeline=2), micro_batch_size=6)
    assert not capsys.readouterr().err
    # the tensor axis runs, and refuses a width it cannot split (JAX's jit
    # refuses the spec): heads, vocab, the SwiGLU width, diff's positions
    assert MeshConfig(tensor=2).tensor == 2
    assert cli.config_from_args(cli.build_parser().parse_args(
        ["--tokens", "t.npy", "--tensor-parallel", "2"])).mesh.tensor == 2
    model = ModelConfig(model="diff", **dict(TINY, n_head=4, vocab_size=64))
    ok = TrainConfig(model=model, mesh=MeshConfig(tensor=2), vocab_size=64)
    assert ok.mesh.tensor == 2
    for kw, tensor, what in (
            (dict(n_head=3), 2, "n_head 3"), (dict(vocab_size=63), 2, "vocab_size 63"),
            (dict(model="control", n_head=3, vocab_size=66), 3,
             "the SwiGLU width 4 x n_embd 128"),
            (dict(block_size=33), 2, r"block_size \(diff's pos_emb rows\) 33")):
        m = model.replace(**kw)
        with pytest.raises(ValueError, match=f"{what} must split into tensor = {tensor}"):
            TrainConfig(model=m, mesh=MeshConfig(tensor=tensor), vocab_size=m.vocab_size)
