"""Tensor parallelism of the port against the JAX package, on the CPU.

The ranks are processes of ``tests/torch_ring_worker.py`` (torch and the
port only) joined through a ``file://`` rendezvous under ``tmp_path``,
one launch per world size running every case in turn; the JAX side runs
on the 8 virtual CPU devices of ``tests/conftest.py``. Both sides start
from JAX-initialized params (``train_state_from_jax``), which each rank
cuts to its shards. Held here:

- (a) one train step of ``make_sharded_train_step`` at ``tensor=2`` for
  control and ndiff, and diff at ``grad_acc_steps`` 2,
  ``data=2 x tensor=2``, ``fsdp=2 x tensor=2`` (at ``grad_acc_steps``
  2) and ``tensor=2 x sequence=2`` (the ring; Ulysses at
  ``grad_acc_steps`` 2), against JAX ``make_sharded_train_step`` on ``create_mesh`` of
  the same ``MeshConfig`` and the same global batch: loss, grad norm,
  per-group norms and every updated param (gathered); every rank of a
  tensor line ends with the same replicated leaves, bit for bit (twin of
  JAX ``tests/test_parallel.py::TestShardedStep`` and
  ``TestShardFlash::test_pallas_sharded_step_matches_single_device``);
- (b) the tensor half of the spec table (``sharding.tensor_dim``) equals
  JAX's ``make_param_specs`` for the three families;
- (c) each rank's attention on its (batch, head) shard at ``data=2 x
  tensor=2`` with dropout, given the seed words of its mesh position,
  equals JAX's ``shard_flash_multi_stream_attention`` on that shard,
  forward and every gradient (twin of JAX
  ``TestShardFlash::test_shard_flash_op_matches_single_device``);
- (d) the GroupLayerNorm of two ranks' columns equals the full-width
  norm, forward and backward; the vocab-parallel losses, dense and
  chunked, equal the one-rank losses, forward and backward; the
  residual/FFN dropout masks are equal across a tensor line and the
  attention's differ;
- (e) the collectives of one tensor=2 step, by kind, size and order,
  per layer; the state at rest is 1/tp of each sharded leaf.

The JAX side runs ``attention_impl="xla"`` in the step twins (dense
attention, the math of the port's plain routes at dropout 0) and its
Pallas kernels in interpret mode for the masks. Tolerances are
``tests/test_torch_dp.py``'s: fp32 loss 1e-5; grad norms 1e-4 relative;
gradients 1e-4 of each tensor's max; updated params 2e-5.
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
from differential_transformer_replication_tpu.models import init_model as j_init_model
from differential_transformer_replication_tpu.ops import flash as jflash
from differential_transformer_replication_tpu.ops.norms import layer_norm as j_layer_norm
from differential_transformer_replication_tpu.parallel import create_mesh
from differential_transformer_replication_tpu.parallel.dp_step import (
    make_sharded_train_step as j_make_sharded_train_step,
)
from differential_transformer_replication_tpu.parallel.shard_flash import (
    shard_flash_multi_stream_attention as j_shard_flash,
)
from differential_transformer_replication_tpu.parallel.sharding import make_param_specs
from differential_transformer_replication_tpu.train.step import (
    create_train_state as j_create_train_state,
)
from differential_transformer_replication_tpu_torch.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from differential_transformer_replication_tpu_torch.models import init_model
from differential_transformer_replication_tpu_torch.ops.losses import (
    dense_linear_cross_entropy,
    fused_linear_cross_entropy,
)
from differential_transformer_replication_tpu_torch.params import train_state_from_jax
from differential_transformer_replication_tpu_torch.parallel import sharding
from differential_transformer_replication_tpu_torch.train.optim import leaves

import torch_ring_worker  # tests/: torch and the port only

FP32_TOL = 1e-5
GRAD_REL = 1e-4
PARAM_TOL = 2e-5
RANK_TIMEOUT_S = 180

# four heads: two per tensor rank, and one per rank of a sequence line
# inside each (Ulysses)
TINY = dict(vocab_size=64, n_embd=32, n_head=4, n_layer=2, block_size=32,
            n_terms=3, dropout=0.0, compute_dtype="float32")
# lr 1e-3 (test_torch_dp.py's 3e-3 / 3): the first AdamW step moves a
# param by about +-lr whatever its gradient's size, so where a gradient is
# near AdamW's eps a rounding of the sum picks the move; JAX's own tensor=2
# step differs from its one-device step by 1.97e-5 at lr 3e-3 (control)
COMMON = dict(micro_batch_size=4, max_iters=20, learning_rate=1e-3, min_lr=1e-4,
              warmup_iters=0, weight_decay=0.1, vocab_size=TINY["vocab_size"],
              anomaly_warmup_steps=1)
FAMILIES = ("control", "diff", "ndiff")

# (id, mesh, TrainConfig overrides, ModelConfig overrides): one launch of
# ranks per world size
CASES = {
    2: [("control-tensor2", dict(tensor=2), {}, dict(model="control")),
        ("ndiff-tensor2", dict(tensor=2), {}, dict(model="ndiff")),
        ("diff-tensor2-acc2", dict(tensor=2), dict(grad_acc_steps=2), {})],
    4: [("data2-tensor2", dict(data=2, tensor=2), {}, {}),
        ("fsdp2-tensor2-acc2", dict(fsdp=2, tensor=2), dict(grad_acc_steps=2), {}),
        ("tensor2-seq2-ring", dict(tensor=2, sequence=2), {}, {}),
        ("tensor2-seq2-ulysses-acc2", dict(tensor=2, sequence=2), dict(grad_acc_steps=2),
         dict(sequence_impl="ulysses"))],
}
CASE_IDS = [(P, i) for P, cases in CASES.items() for i in range(len(cases))]

# (c): the attention shard
ATTN = dict(S=2, B=4, T=32, H=4, d=8, dv=16)
ATTN_MESH = dict(data=2, tensor=2)
# (d): the GroupLayerNorm and the losses
GN = dict(B=2, T=8, C=32)
CE = dict(N=40, E=16, V=64, chunk=16)
SEED_MESHES = {2: [dict(tensor=2)], 4: [dict(data=2, tensor=2), dict(tensor=2, sequence=2)]}


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
    model = dict(TINY, **dict(dict(model="diff"), **model))
    return JTrainConfig(model=JModelConfig(attention_impl="xla", **model),
                        mesh=JMeshConfig(**mesh), **dict(COMMON, **train))


def _port_cfg(mesh, train, model):
    model = dict(TINY, **dict(dict(model="diff"), **model))
    return TrainConfig(model=ModelConfig(**model), mesh=MeshConfig(**mesh),
                       sampler="replacement", **dict(COMMON, **train))


def _attn_inputs():
    S, B, T, H, d, dv = (ATTN[k] for k in ("S", "B", "T", "H", "d", "dv"))
    rng = np.random.default_rng(64)
    qs = rng.standard_normal((S, B, T, H, d)).astype(np.float32)
    ks = rng.standard_normal((S, B, T, H, d)).astype(np.float32)
    v = rng.standard_normal((B, T, H, dv)).astype(np.float32)
    g = rng.standard_normal((B, T, H, dv)).astype(np.float32)
    coeffs = (0.5 * rng.standard_normal((S, H))).astype(np.float32)
    coeffs[0] = 1.0
    return dict(qs=qs, ks=ks, v=v, g=g, coeffs=coeffs)


def _parts_inputs():
    rng = np.random.default_rng(65)
    B, T, C = GN["B"], GN["T"], GN["C"]
    N, E, V = CE["N"], CE["E"], CE["V"]
    return dict(gn_x=rng.standard_normal((B, T, C)).astype(np.float32),
                gn_w=(1 + 0.3 * rng.standard_normal(C)).astype(np.float32),
                gn_b=(0.3 * rng.standard_normal(C)).astype(np.float32),
                gn_g=rng.standard_normal((B, T, C)).astype(np.float32),
                ce_h=rng.standard_normal((N, E)).astype(np.float32),
                ce_w=(0.3 * rng.standard_normal((E, V))).astype(np.float32),
                ce_b=(0.1 * rng.standard_normal(V)).astype(np.float32),
                ce_t=rng.integers(0, V, N))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's port step on its ranks and JAX's step on its mesh, from
    one JAX-initialized state per family and one global batch per A; the
    P = 2 launch also runs ``tensor_parts``, the P = 4 launch the
    attention shards at ``data=2 x tensor=2``."""
    hosts, leaves_in = {}, {}
    for fam in FAMILIES:
        jcfg0 = _jcfg({}, {}, dict(model=fam))
        host = jax.tree_util.tree_map(np.asarray,
                                      j_create_train_state(jax.random.PRNGKey(8), jcfg0))
        hosts[fam] = host
        state = train_state_from_jax(host, _port_cfg({}, {}, dict(model=fam)).resolved_model())
        for name, tree in (("p", state["params"]), ("mu", state["opt_state"]["mu"]),
                           ("nu", state["opt_state"]["nu"])):
            leaves_in.update({f"{fam}_{name}{i}": t.detach().numpy()
                              for i, t in enumerate(leaves(tree))})
    guard = {k: float(v) if k == "ema" else int(v)
             for k, v in state["guard"].items()}
    rng = np.random.default_rng(43)
    batches = {A: (rng.integers(0, TINY["vocab_size"], (A, 4, TINY["block_size"])),
                   rng.integers(0, TINY["vocab_size"], (A, 4, TINY["block_size"])))
               for A in (1, 2)}
    attn, parts = _attn_inputs(), _parts_inputs()
    key = jax.random.PRNGKey(5)
    n_pos = 4
    words = np.stack([np.asarray(jflash.dropout_seed_from_rng(
        jax.random.fold_in(key, p)))[0] for p in range(n_pos)])
    refs, outs = {}, {}
    for P, cases in CASES.items():
        meta = {"model": TINY, "train": dict(COMMON, sampler="replacement"),
                "count": 0, "step": 0, "guard": guard, "cases": []}
        for i, (_, mesh, train, model) in enumerate(cases):
            A = train.get("grad_acc_steps", 1)
            fam = model.get("model", "diff")
            meta["cases"].append({"mesh": mesh, "train": train,
                                  "model": dict(model, model=fam), "prefix": f"{fam}_",
                                  "x": f"x{A}", "y": f"y{A}"})
            jcfg = _jcfg(mesh, train, model)
            jmesh = create_mesh(jcfg.mesh)
            jstate = jax.tree_util.tree_map(jnp.asarray, hosts[fam])
            jstep = j_make_sharded_train_step(jcfg, jmesh, jstate)
            x, y = batches[A]
            jnew, jm = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
            refs[(P, i)] = (jax.tree_util.tree_map(np.asarray, jm),
                            _leaf_arrays(jnew["params"], "p"))
        inputs = dict(leaves_in, meta_mesh_step=np.array(json.dumps(meta)),
                      device=np.array("cpu"), x1=batches[1][0], y1=batches[1][1],
                      x2=batches[2][0], y2=batches[2][1])
        if P == 2:
            task = "mesh_step+tensor_parts"
            inputs.update(parts, meta_tensor_parts=np.array(json.dumps(
                {"chunk": CE["chunk"], "seed": 11, "seed_meshes": SEED_MESHES[2]})))
        else:
            task = "mesh_step+mesh_attention+tensor_parts"
            inputs.update(attn)
            inputs.update(parts, words=words,
                          meta_mesh_attention=np.array(json.dumps(
                              {"cases": [{"mesh": ATTN_MESH, "rate": 0.3}]})),
                          meta_tensor_parts=np.array(json.dumps(
                              {"chunk": CE["chunk"], "seed": 11,
                               "seed_meshes": SEED_MESHES[4]})))
        outs[P] = torch_ring_worker.run_ranks(task, P, tmp_path_factory.mktemp(f"tp{P}"),
                                              inputs, RANK_TIMEOUT_S)
    return refs, outs, hosts, dict(attn, words=words, key=key), parts


def _out(o, task):
    return {k.split("/", 1)[1]: v for k, v in o.items() if k.startswith(task + "/")}


# ---------------------------------------------------------------------------
# (a) the step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P,i", CASE_IDS, ids=[CASES[P][i][0] for P, i in CASE_IDS])
def test_tensor_step_matches_jax_sharded_step(P, i, runs):
    refs, outs, _, _, _ = runs
    jm, jp = refs[(P, i)]
    got = [_out(o, "mesh_step") for o in outs[P]]
    o = got[0]
    assert abs(float(jm["loss"]) - float(o[f"{i}_loss"])) <= FP32_TOL
    assert abs(float(jm["grad_norm"]) - float(o[f"{i}_grad_norm"])) <= \
        GRAD_REL * float(jm["grad_norm"])
    jg = np.asarray(jm["grad_norm_groups"])
    assert np.max(np.abs(jg - o[f"{i}_groups"])) <= GRAD_REL * float(np.max(jg))
    for k in range(len(jp)):
        assert _err(jp[f"p{k}"], o[f"{i}_p{k}"]) <= PARAM_TOL, k
    # every rank: the same loss and norms, and after the gathers the same
    # params, bit for bit (the replicated leaves are its own copies)
    for other in got[1:]:
        for k in range(len(jp)):
            assert np.array_equal(other[f"{i}_p{k}"], o[f"{i}_p{k}"]), k
        for name in ("loss", "grad_norm", "groups"):
            assert np.array_equal(other[f"{i}_{name}"], o[f"{i}_{name}"]), name
    shape = JMeshConfig(**CASES[P][i][1]).shape
    for r, out in enumerate(got):
        assert tuple(out[f"{i}_coords"]) == tuple(np.unravel_index(r, shape))


def test_state_at_rest_is_a_tensor_shard_per_rank(runs):
    """1/tp of every sharded leaf, the replicated leaves whole (params,
    mu and nu alike); under fsdp x tensor 1/fsdp of that, up to padding."""
    _, outs, hosts, _, _ = runs
    for P, i in CASE_IDS:
        _, mesh, _, model = CASES[P][i]
        fam = model.get("model", "diff")
        params = train_state_from_jax(
            hosts[fam], _port_cfg({}, {}, model).resolved_model())["params"]
        dims = sharding.tensor_dims(params)
        tp = mesh["tensor"]
        want = sum(t.numel() // (tp if d is not None else 1)
                   for t, d in zip(leaves(params), dims))
        assert any(d is not None for d in dims) and any(d is None for d in dims)
        for o in outs[P]:
            rest = _out(o, "mesh_step")[f"{i}_rest"]
            assert rest[0] == rest[1] == rest[2]
            f = mesh.get("fsdp", 1)
            assert want / f <= rest[0] < want / f + (TINY["n_layer"] + 2) * f, (P, i)


# ---------------------------------------------------------------------------
# (b) the spec table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_tensor_dims_equal_jax_param_specs(family):
    jcfg = _jcfg({}, {}, dict(model=family))
    jparams = j_init_model(jax.random.PRNGKey(0), jcfg.resolved_model())
    specs = make_param_specs(jparams)
    want = [None if "tensor" not in tuple(s) else tuple(s).index("tensor")
            for s in jax.tree_util.tree_leaves(specs, is_leaf=lambda s: isinstance(
                s, jax.sharding.PartitionSpec))]
    params = init_model(torch.Generator().manual_seed(0),
                        _port_cfg({}, {}, dict(model=family)).resolved_model())
    got = sharding.tensor_dims(params)
    assert got == want
    assert sum(d is not None for d in got) > sum(d is None for d in got) / 2


def test_a_jax_state_crosses_cut_to_a_tensor_shard():
    """``train_state_from_jax(..., tensor=line)`` keeps this rank's block
    of every leaf ``tensor_dim`` names (params and moments alike) and the
    replicated leaves whole; ``TensorLayout.shard_state`` of the full
    state is the same cut."""
    from differential_transformer_replication_tpu_torch.parallel.mesh import Line

    jcfg = _jcfg({}, {}, {})
    host = jax.tree_util.tree_map(np.asarray,
                                  j_create_train_state(jax.random.PRNGKey(3), jcfg))
    cfg = _port_cfg({}, {}, {}).resolved_model()
    full = train_state_from_jax(host, cfg)
    line = Line((0, 1), 1)
    cut = train_state_from_jax(host, cfg, tensor=line)
    again = sharding.TensorLayout(line).shard_state(full)
    for part in ("params", "mu", "nu"):
        whole = full["params"] if part == "params" else full["opt_state"][part]
        got = cut["params"] if part == "params" else cut["opt_state"][part]
        other = again["params"] if part == "params" else again["opt_state"][part]
        for t, g, o, d in zip(leaves(whole), leaves(got), leaves(other),
                              sharding.tensor_dims(whole)):
            want = t if d is None else t.narrow(d, t.shape[d] // 2, t.shape[d] // 2)
            assert torch.equal(g, want) and torch.equal(o, want) and g.is_contiguous()
    assert all(t.requires_grad for t in leaves(cut["params"]))


# ---------------------------------------------------------------------------
# (c) the attention shard
# ---------------------------------------------------------------------------


def test_each_rank_draws_jax_shard_flash_masks_on_its_heads(runs):
    """At dropout 0.3 on ``data=2 x tensor=2``, every rank's attention on
    its (batch, head) shard, given the seed words JAX derives for its mesh
    position ``(data * fsdp + fsdp_idx) * tensor + tensor_idx``, equals
    JAX's ``shard_flash`` on that shard, forward and every gradient."""
    _, outs, _, a, _ = runs
    jmesh = create_mesh(JMeshConfig(**ATTN_MESH))
    rate = 0.3

    def jfn(qs, ks, v, c, g):
        out, vjp = jax.vjp(lambda *x: j_shard_flash(*x, jmesh, dropout_rate=rate,
                                                    dropout_rng=a["key"]), qs, ks, v, c)
        return (out, *vjp(g))

    jout, jdq, jdk, jdv, jdc = jax.jit(jfn)(*(jnp.asarray(a[k]) for k in (
        "qs", "ks", "v", "coeffs", "g")))
    B, H = ATTN["B"], ATTN["H"]
    Bl = B // ATTN_MESH["data"]
    got = {"out": np.zeros_like(jout), "dv": np.zeros_like(jdv),
           "dqs": np.zeros_like(jdq), "dks": np.zeros_like(jdk),
           "dc": np.zeros_like(jdc)}
    positions = set()
    for o in outs[4]:
        o = _out(o, "mesh_attention")
        b, _, pos = (int(x) for x in o["0_where"])
        h0, h1 = (int(x) for x in o["0_heads"])
        positions.add(pos)
        assert pos == b * ATTN_MESH["tensor"] + h0 // (H // ATTN_MESH["tensor"])
        rows = slice(b * Bl, (b + 1) * Bl)
        got["out"][rows, :, h0:h1] = o["0_out"]
        got["dv"][rows, :, h0:h1] = o["0_dv"]
        got["dqs"][:, rows, :, h0:h1] = o["0_dqs"]
        got["dks"][:, rows, :, h0:h1] = o["0_dks"]
        got["dc"][:, h0:h1] += o["0_dcoeffs"]
    assert positions == {0, 1, 2, 3}
    assert _err(jout, got["out"]) <= FP32_TOL
    for name, ref in (("dqs", jdq), ("dks", jdk), ("dv", jdv), ("dc", jdc)):
        assert _err(ref, got[name]) <= GRAD_REL * _top(ref), name
    plain = jax.jit(lambda *x: j_shard_flash(*x, jmesh))(
        *(jnp.asarray(a[k]) for k in ("qs", "ks", "v", "coeffs")))
    assert _err(plain, jout) > 1e-2  # the masks are live


# ---------------------------------------------------------------------------
# (d) the GroupLayerNorm, the losses, the masks
# ---------------------------------------------------------------------------


def test_group_norm_across_a_tensor_line_is_the_full_width_norm(runs):
    """Each rank's columns after the gathered norm equal the full-width
    LayerNorm's (JAX ``ops/norms.py:layer_norm`` over the head concat),
    and the gradients of its columns and its ``gn`` block equal the
    full-width ones: the reduce-scatters sum the other ranks' parts."""
    _, outs, _, _, parts = runs
    x, w, b, g = (jnp.asarray(parts[k]) for k in ("gn_x", "gn_w", "gn_b", "gn_g"))
    y, vjp = jax.vjp(lambda x, w, b: j_layer_norm(x, w, b), x, w, b)
    dx, dw, db = vjp(g)
    for P in (2, 4):
        got = [_out(o, "tensor_parts") for o in outs[P]]
        # the P = 4 launch's tensor line is the world of four ranks
        cat = {k: np.concatenate([o[k] for o in got], -1)
               for k in ("gn_y", "gn_dx", "gn_dw", "gn_db")}
        assert _err(y, cat["gn_y"]) <= FP32_TOL, P
        for name, ref in (("gn_dx", dx), ("gn_dw", dw), ("gn_db", db)):
            assert _err(ref, cat[name]) <= GRAD_REL * _top(ref), (P, name)
    # a norm of each rank's columns alone is another function
    C = GN["C"] // 2
    alone = j_layer_norm(x[..., :C], w[:C], b[:C])
    assert _err(alone, _out(outs[2][0], "tensor_parts")["gn_y"]) > 1e-2


@pytest.mark.parametrize("kind", ["dense", "chunked"])
def test_vocab_parallel_loss_equals_the_one_rank_loss(kind, runs):
    _, outs, _, _, parts = runs
    h = torch.from_numpy(parts["ce_h"]).requires_grad_(True)
    w = torch.from_numpy(parts["ce_w"]).requires_grad_(True)
    b = torch.from_numpy(parts["ce_b"]).requires_grad_(True)
    t = torch.from_numpy(parts["ce_t"])
    if kind == "dense":
        loss, logits = dense_linear_cross_entropy(h, w, b, t)
    else:
        loss = fused_linear_cross_entropy(h, w, b, t, CE["chunk"])
    loss.backward()
    loss = loss.detach()
    for P in (2, 4):
        got = [_out(o, "tensor_parts") for o in outs[P]]
        for o in got:  # every rank holds the global loss and the summed dh
            assert abs(float(o[f"ce_{kind}_loss"]) - float(loss)) <= FP32_TOL, P
            assert _err(h.grad, o[f"ce_{kind}_dh"]) <= GRAD_REL * _top(h.grad), P
        assert len({float(o[f"ce_{kind}_loss"]) for o in got}) == 1
        dw = np.concatenate([o[f"ce_{kind}_dw"] for o in got], -1)
        db = np.concatenate([o[f"ce_{kind}_db"] for o in got], -1)
        assert _err(w.grad, dw) <= GRAD_REL * _top(w.grad), P
        assert _err(b.grad, db) <= GRAD_REL * _top(b.grad), P
        if kind == "dense":  # the logits a rank returns are its vocab shard
            cat = np.concatenate([o["ce_logits"] for o in got], -1)
            assert _err(logits, cat) <= FP32_TOL


def test_replicated_masks_equal_across_a_tensor_line_attention_masks_not(runs):
    """The forward's seed folds data, fsdp and sequence (``rank_seed``):
    the residual/FFN dropout masks of the ranks of a tensor line are one
    mask, and differ between batch or sequence shards; the attention's
    seed folds the tensor index too (``attention_seed``), so every rank's
    attention masks are its own."""
    _, outs, _, _, _ = runs
    for P in (2, 4):
        got = [_out(o, "tensor_parts") for o in outs[P]]
        for c, axes in enumerate(SEED_MESHES[P]):
            shape = JMeshConfig(**axes).shape
            t_axis = 2  # the tensor coordinate, in JAX's axis order
            by_line = {}
            for o in got:
                coords = tuple(o[f"seed{c}_coords"])
                rest = coords[:t_axis] + coords[t_axis + 1:]
                by_line.setdefault(rest, []).append(o)
            assert len(by_line) == int(np.prod(shape)) // axes["tensor"]
            residual = []
            for line in by_line.values():
                r0 = line[0][f"seed{c}_residual"]
                assert 0 < np.count_nonzero(r0) < r0.size
                for o in line[1:]:
                    assert np.array_equal(o[f"seed{c}_residual"], r0)
                    assert not np.array_equal(o[f"seed{c}_attention"],
                                              line[0][f"seed{c}_attention"])
                residual.append(r0)
            for a in residual[1:]:  # other batch / sequence shards: their own
                assert not np.array_equal(a, residual[0])


# ---------------------------------------------------------------------------
# (e) the collectives
# ---------------------------------------------------------------------------


def test_collectives_of_a_tensor_step_by_kind_size_and_order(runs):
    """One diff step at ``tensor=2`` (no other axis), two microbatches:
    for each, in the forward the embeddings' sum, then per layer the
    gathers of the GroupLayerNorm's params and of the head concat, the
    attention's out-projection sum and the FFN's; the loss's (N, 2)
    statistics; in the backward the lm head input's sum, then per layer
    from the last the FFN input's sum, the reduce-scatters of the gathers
    and the attention input's sum; then the sharded leaves' squared
    norms. No other collective: the plane of every axis but tensor is
    this rank alone."""
    _, outs, _, _, _ = runs
    i = [c[0] for c in CASES[2]].index("diff-tensor2-acc2")
    AR, RS, AG = 0, 1, 2
    E, L = TINY["n_embd"], TINY["n_layer"]
    H, dv = TINY["n_head"], 2 * (E // (2 * TINY["n_head"]))
    N = COMMON["micro_batch_size"] * TINY["block_size"]
    C = H * dv // 2  # one rank's columns of the head concat
    fwd = [(AR, N * E)]
    for _ in range(L):
        fwd += [(AG, 2 * C), (AG, N * C), (AR, N * E), (AR, N * E)]
    fwd += [(AG, 2 * N)]
    bwd = [(AR, N * E)]
    for _ in range(L):
        bwd += [(AR, N * E), (RS, 2 * N * C), (RS, 2 * 2 * C), (AR, N * E)]
    want = (fwd + bwd) * 2 + [(AR, L + 2)]
    for o in outs[2]:
        calls = [tuple(c) for c in _out(o, "mesh_step")[f"{i}_calls"]]
        assert calls == want, calls
