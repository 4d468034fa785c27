"""The port's sequence-parallel ring against the JAX package, on the CPU.

Inputs come from numpy with a seed and go to both sides; the JAX side
runs its Pallas kernels in interpret mode (``auto_interpret``) on the
virtual CPU mesh of ``tests/conftest.py``. Held here:

- (a) the chunk op's plain version (the CPU route of ``_FlashChunkFn``)
  against JAX ``flash_chunk_attention``: (o_all, lse) and dq, dk, dv for
  random do and dlse, at causal offsets 0, +T, -T, +2T and T/2, S 1, 2,
  4, 5, T 64 and 96, dropout 0 and 0.3 with the same seed words (the
  keep masks are then bit-identical);
- (b) ``_Rotate`` against a hand permutation, forward and backward;
- (c) ``ring_multi_stream_attention`` on P = 2 and 4 gloo ranks against
  JAX ``ring_multi_stream_attention(..., impl="pallas")`` on
  ``create_mesh(MeshConfig(sequence=P))``: the forward and every
  gradient, dcoeffs included; with dropout 0.3 each rank gets the seed
  words JAX derives for its mesh position;
- (c') ``ring_vanilla_attention``, ``ring_diff_attention`` and
  ``ring_ndiff_attention`` at P = 2 against their JAX counterparts, the
  lambdas' gradients included;
- (d) the three families' forward at P = 2 against JAX ``model_forward(...,
  mesh=)``; one SP train step at P = 2 from ``train_state_from_jax``
  against JAX ``make_sharded_train_step``;
- (e) the command line: ``--sequence-parallel 2 --dist-backend gloo
  --device cpu`` trains, Ulysses is refused, nccl without one card per
  rank raises; the row bounds reject the chunk's planted faults.

The ranks are processes running ``tests/torch_ring_worker.py`` (torch and
the port only): inputs and outputs pass as ``.npz`` files under
``tmp_path``, the rendezvous is a ``file://`` there (no TCP port), and
each multi-process call joins its ranks with a time limit, then kills
them, so a deadlock fails instead of hanging the suite.

Tolerances: fp32 outputs 1e-5 max-abs, gradients 1e-4 of each tensor's
max |value| (the same math, sums in another order); the train step as
``tests/test_torch_train.py``.
"""

from __future__ import annotations

import json
from pathlib import Path

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
from differential_transformer_replication_tpu.parallel import create_mesh
from differential_transformer_replication_tpu.parallel.dp_step import (
    make_sharded_train_step as j_make_sharded_train_step,
)
from differential_transformer_replication_tpu.parallel.ring import (
    ring_diff_attention as j_ring_diff,
    ring_multi_stream_attention as j_ring,
    ring_ndiff_attention as j_ring_ndiff,
    ring_vanilla_attention as j_ring_vanilla,
)
from differential_transformer_replication_tpu.train.step import (
    create_train_state as j_create_train_state,
)
from differential_transformer_replication_tpu_torch import testing
from differential_transformer_replication_tpu_torch.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from differential_transformer_replication_tpu_torch.ops import flash as tflash
from differential_transformer_replication_tpu_torch.params import train_state_from_jax
from differential_transformer_replication_tpu_torch.parallel import mesh as tmesh
from differential_transformer_replication_tpu_torch.train import __main__ as cli
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


def _seed_pair(rng):
    return rng.integers(0, 1 << 24, (1, 2)).astype(np.float32)


def run_ranks(task: str, P: int, d: Path, inputs: dict) -> list:
    return torch_ring_worker.run_ranks(task, P, d, inputs, RANK_TIMEOUT_S)


# ---------------------------------------------------------------------------
# (a) the chunk op against JAX flash_chunk_attention
# ---------------------------------------------------------------------------

# (offset in units of T: off = round(mult * T), S, T, rate): each offset
# with both rates, every S and T among them; and T 96 at +40, an offset
# off the kernels' tile grids that the card's tests use (tiles partly
# visible; the other, -24, is held against the dense math below)
CHUNK_CASES = [
    (0.0, 2, 64, 0.0), (0.0, 1, 96, 0.3), (1.0, 4, 64, 0.3), (1.0, 5, 96, 0.0),
    (-1.0, 2, 96, 0.3), (-1.0, 1, 64, 0.0), (2.0, 1, 64, 0.3), (2.0, 2, 96, 0.0),
    (0.5, 5, 64, 0.3), (0.5, 4, 96, 0.0), (40 / 96, 2, 96, 0.0), (40 / 96, 2, 96, 0.3),
]
BH, D, DV = 3, 8, 16


def _chunk_inputs(rng, S, T):
    return (rng.standard_normal((BH, S, T, D)).astype(np.float32),
            rng.standard_normal((BH, S, T, D)).astype(np.float32),
            rng.standard_normal((BH, T, DV)).astype(np.float32),
            rng.standard_normal((BH, S, T, DV)).astype(np.float32),
            rng.standard_normal((BH, S, T)).astype(np.float32))


@pytest.mark.parametrize("mult,S,T,rate", CHUNK_CASES)
def test_chunk_op_matches_jax_flash_chunk_attention(mult, S, T, rate):
    off = int(round(mult * T))
    rng = np.random.default_rng([S, T, int(rate * 10), int(mult * 4) + 8])
    q, k, v, do, dlse = _chunk_inputs(rng, S, T)
    seed = _seed_pair(rng)

    def jfn(q, k, v, do, dlse):
        out, vjp = jax.vjp(lambda *a: jflash.flash_chunk_attention(
            *a, jnp.full((1, 1), float(off), jnp.float32), jnp.asarray(seed),
            (16, 16, 16, 16), jflash.auto_interpret(), rate), q, k, v)
        return (*out, *vjp((do, dlse)))

    jo, jl, jdq, jdk, jdv = jax.jit(jfn)(*(jnp.asarray(a) for a in (q, k, v, do, dlse)))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o, lse = tflash.flash_chunk_attention(tq, tk, tv, off, torch.from_numpy(seed), rate)
    assert o.shape == (BH, S, T, DV) and lse.shape == (BH, S, T)
    assert torch.isfinite(lse).all() and torch.isfinite(o).all()
    torch.autograd.backward([o, lse], [torch.from_numpy(do), torch.from_numpy(dlse)])
    assert _err(jo, o) <= FP32_TOL
    assert _err(jl, lse) <= FP32_TOL * _top(jl)
    if off <= -T:  # every pair masked: o = 0, lse = -1e30, no gradient
        assert float(o.detach().abs().max()) == 0.0
        assert float(lse.detach().max()) == float(np.float32(-1e30))
        assert float(tq.grad.abs().max()) == 0.0
    for ref, got in ((jdq, tq.grad), (jdk, tk.grad), (jdv, tv.grad)):
        assert _err(ref, got) <= GRAD_REL * _top(ref)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_chunk_op_matches_dense_math_off_the_block_grid(rate):
    """The chunk op at offset -24, T 96 (rows 0-23 see no key), forward
    and every gradient against the dense float64 math. JAX's chunk kernel
    is not the reference here: where a negative offset does not fall on
    its 16-row blocks it gives the rows with no visible key of a partly
    visible block (16-23) nonzero outputs; the ring's offsets, multiples of
    the chunk length, never meet that."""
    S, T, off = 2, 96, -24
    rng = np.random.default_rng([S, T, int(rate * 10), 3])
    q, k, v, do, dlse = (torch.from_numpy(a) for a in _chunk_inputs(rng, S, T))
    seed = torch.from_numpy(_seed_pair(rng))
    pos = torch.arange(T)
    vis = pos[None, :] <= pos[:, None] + off
    live = vis.any(-1)[:, None]  # rows with a visible key

    def dense(q, k, v):
        s = torch.einsum("bsqd,bskd->bsqk", q, k) / D ** 0.5
        s = s.masked_fill(~vis, float("-inf"))
        m = s.amax(-1, keepdim=True).masked_fill(~live, 0.0)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)
        if rate > 0:
            keep = tflash._keep_block(tflash.seed_words(seed), rate, BH, S, pos,
                                      pos - off, "cpu")
            p = torch.where(keep, p / (1.0 - rate), 0.0)
        o = torch.einsum("bsqk,bkc->bsqc", p, v) / l
        lse = torch.where(live, m + torch.log(l), torch.full_like(m, -1e30))
        return o, lse[..., 0]

    got_in = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_in = [t.double().requires_grad_(True) for t in (q, k, v)]
    o, lse = tflash.flash_chunk_attention(*got_in, off, seed, rate)
    r_o, r_lse = dense(*ref_in)
    assert _err(r_o, o) <= FP32_TOL
    assert torch.equal(lse[:, :, :-off], torch.full((BH, S, -off), np.float32(-1e30)))
    assert _err(r_lse[:, :, -off:], lse[:, :, -off:]) <= FP32_TOL * _top(r_lse[:, :, -off:])
    torch.autograd.backward([o, lse], [do, dlse])
    torch.autograd.backward([r_o, r_lse], [do.double(), dlse.double()])
    for ref, got in zip(ref_in, got_in):
        assert _err(ref.grad, got.grad) <= GRAD_REL * _top(ref.grad)


def test_chunk_routes_follow_the_jax_thresholds():
    assert tflash.chunk_fwd_route(4096) == "chunk-resident"
    assert tflash.chunk_fwd_route(8192) == "chunk-tiled"
    assert tflash.chunk_bwd_route(4096) == "chunk-split"
    assert tflash.chunk_bwd_route(4097) == "chunk-tiled"
    # the aligned head-major routes are unchanged
    assert tflash.fwd_route(4096) == "resident" and tflash.bwd_route(2, 512) == "fused"


@pytest.mark.parametrize("fault", ["offset ignored", "dv from one stream"])
def test_row_bounds_reject_planted_chunk_faults(fault):
    """The row-by-row bounds the chunk kernels are held to on the card
    (``testing.py``) reject a kernel that ignores the offset or sums dv
    over one stream only (here as plain results with the fault planted)."""
    rng = np.random.default_rng(11)
    S, T, off = 2, 96, 48
    q, k, v, do, _ = (torch.from_numpy(a) for a in _chunk_inputs(rng, S, T))
    delta = torch.from_numpy(rng.standard_normal((BH, S, T)).astype(np.float32))
    _, r_o, r_lse = tflash.bh_attention_fwd_reference(q, k, v, None, 0.0, (0, 0), off)
    ref = tflash.bh_attention_bwd_reference(q, k, v, do, r_lse, delta, None, 0.0,
                                            (0, 0), off)
    if fault == "offset ignored":
        _, f_o, _ = tflash.bh_attention_fwd_reference(q, k, v, None, 0.0, (0, 0), 0)
        assert testing.row_ratio(f_o, r_o, testing.FP32_FWD_ROW,
                                 testing.FP32_FWD_FLOOR) > 1.0
        bad = tflash.bh_attention_bwd_reference(q, k, v, do, r_lse, delta, None,
                                                0.0, (0, 0), 0)
        assert min(testing.grad_ratio(a, b) for a, b in zip(bad, ref)) > 1.0
    else:
        one = do.clone()
        one[:, 1:] = 0
        bad_dv = tflash.bh_attention_bwd_reference(q, k, v, one, r_lse, delta, None,
                                                   0.0, (0, 0), off)[2]
        assert testing.grad_ratio(bad_dv, ref[2]) > 1.0
    # and the right results pass
    for a in ref:
        assert testing.grad_ratio(a, a.clone()) == 0.0


# ---------------------------------------------------------------------------
# (b) the rotation
# ---------------------------------------------------------------------------


def test_rotate_is_the_ring_permutation_and_its_inverse(tmp_path):
    P = 3
    outs = run_ranks("rotate", P, tmp_path, {"device": np.array("cpu")})
    for r, o in enumerate(outs):
        # forward: rank r receives rank r - 1's tensor; backward: rank r's
        # input gets the cotangent of the rank it sent to, r + 1
        assert np.all(o["y"] == float((r - 1) % P))
        assert np.all(o["gx"] == float(10 * ((r + 1) % P) + 1))


# ---------------------------------------------------------------------------
# (c) ring attention against JAX's ring on a sequence mesh
# ---------------------------------------------------------------------------

RING = dict(S=2, B=2, T=64, H=2, d=8, dv=16)
RATES = (0.0, 0.3)


@pytest.mark.parametrize("P", [2, 4])
def test_ring_attention_matches_jax_ring(P, tmp_path):
    S, B, T, H, d, dv = (RING[k] for k in ("S", "B", "T", "H", "d", "dv"))
    rng = np.random.default_rng(20 + P)
    qs = rng.standard_normal((S, B, T, H, d)).astype(np.float32)
    ks = rng.standard_normal((S, B, T, H, d)).astype(np.float32)
    v = rng.standard_normal((B, T, H, dv)).astype(np.float32)
    g = rng.standard_normal((B, T, H, dv)).astype(np.float32)
    coeffs = (0.5 * rng.standard_normal((S, H))).astype(np.float32)
    coeffs[0] = 1.0
    mesh = create_mesh(JMeshConfig(sequence=P))
    key = jax.random.PRNGKey(P)
    # the seed words JAX's sequence_shard_map hands mesh position p
    words = np.stack([np.stack([
        np.asarray(jflash.dropout_seed_from_rng(jax.random.fold_in(key, p)))[0]
        for p in range(P)]) for _ in RATES])
    refs = []
    for rate in RATES:
        def jfn(qs, ks, v, c, g, rate=rate):
            out, vjp = jax.vjp(
                lambda *a: j_ring(*a, mesh, "pallas", dropout_rate=rate,
                                  dropout_rng=key if rate > 0 else None),
                qs, ks, v, c)
            return (out, *vjp(g))

        refs.append(jax.jit(jfn)(*(jnp.asarray(a) for a in (qs, ks, v, coeffs, g))))
    outs = run_ranks("ring", P, tmp_path, dict(
        qs=qs, ks=ks, v=v, g=g, coeffs=coeffs, words=words,
        rates=np.array(RATES), dtype=np.array("float32"), device=np.array("cpu")))
    for i, (jout, jdq, jdk, jdv, jdc) in enumerate(refs):
        got = {n: np.concatenate([o[f"{n}{i}"] for o in outs], axis=axis)
               for n, axis in (("out", 1), ("dqs", 2), ("dks", 2), ("dv", 1))}
        got["dcoeffs"] = sum(o[f"dcoeffs{i}"] for o in outs)
        assert _err(jout, got["out"]) <= FP32_TOL, RATES[i]
        for n, ref in (("dqs", jdq), ("dks", jdk), ("dv", jdv), ("dcoeffs", jdc)):
            assert _err(ref, got[n]) <= GRAD_REL * _top(ref), (RATES[i], n)
    if P == 2:  # dropout changes the result: the masks are live on the ring
        assert _err(refs[0][0], refs[1][0]) > 1e-2
    # P - 1 exchanges forward (JAX's unused P-th rotation is skipped) and
    # as many backward, on every rank
    for o in outs:
        for i in range(len(RATES)):
            assert int(o[f"fwd_exchanges{i}"]) == P - 1
            assert int(o[f"exchanges{i}"]) == 2 * (P - 1)


@pytest.fixture(scope="module")
def ring_wrapper_runs(tmp_path_factory):
    """The three ring wrappers at P = 2 (one set of rank processes) and
    their JAX counterparts' forward and vjp on the same inputs."""
    P, n, B, T, H, d, dv = 2, 3, 1, 64, 2, 8, 16
    rng = np.random.default_rng(31)
    inp = dict(qs=rng.standard_normal((n, B, T, H, d)).astype(np.float32),
               ks=rng.standard_normal((n, B, T, H, d)).astype(np.float32),
               v=rng.standard_normal((B, T, H, dv)).astype(np.float32),
               g=rng.standard_normal((B, T, H, dv)).astype(np.float32),
               lam=(0.5 * rng.standard_normal(H)).astype(np.float32),
               lams=(0.5 * rng.standard_normal((n, H))).astype(np.float32),
               signs=np.array([1.0, -1.0, 1.0], np.float32))
    mesh = create_mesh(JMeshConfig(sequence=P))
    signs = jnp.asarray(inp["signs"])
    fns = {
        "vanilla": lambda qs, ks, v, lam, lams: j_ring_vanilla(
            qs[0], ks[0], v, mesh, "pallas"),
        "diff": lambda qs, ks, v, lam, lams: j_ring_diff(
            qs[0], ks[0], qs[1], ks[1], v, lam, mesh, "pallas"),
        "ndiff": lambda qs, ks, v, lam, lams: j_ring_ndiff(
            qs, ks, v, lams, signs, mesh, "pallas"),
    }
    args = [jnp.asarray(inp[k]) for k in ("qs", "ks", "v", "lam", "lams")]
    refs = {}
    for kind, fn in fns.items():
        def jfn(*a, fn=fn):
            out, vjp = jax.vjp(fn, *a)
            return (out, *vjp(jnp.asarray(inp["g"])))

        refs[kind] = jax.jit(jfn)(*args)
    inp["device"] = np.array("cpu")
    outs = run_ranks("wrappers", P, tmp_path_factory.mktemp("wrappers"), inp)
    return refs, outs


@pytest.mark.parametrize("kind", ["vanilla", "diff", "ndiff"])
def test_ring_wrappers_match_jax(kind, ring_wrapper_runs):
    refs, outs = ring_wrapper_runs
    jout, jdq, jdk, jdv, jdlam, jdlams = refs[kind]
    got = {n: np.concatenate([o[f"{kind}_{n}"] for o in outs], axis=axis)
           for n, axis in (("out", 1), ("dqs", 2), ("dks", 2), ("dv", 1))}
    assert _err(jout, got["out"]) <= FP32_TOL
    grads = [("dqs", jdq), ("dks", jdk), ("dv", jdv)]
    # lambda is replicated: each rank's grad is its shard's share
    lam_name, jlam = {"diff": ("dlam", jdlam), "ndiff": ("dlams", jdlams)}.get(
        kind, (None, None))
    if lam_name:
        got[lam_name] = sum(o[f"{kind}_{lam_name}"] for o in outs)
        grads.append((lam_name, jlam))
    for n, ref in grads:
        assert _err(ref, got[n]) <= GRAD_REL * _top(ref), n
    if kind == "vanilla":  # one stream: the others get no gradient
        assert not np.any(got["dqs"][1:]) and not np.any(got["dks"][1:])


# ---------------------------------------------------------------------------
# (d) the model forward and one train step at P = 2 against JAX's mesh path
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=64, n_embd=32, n_head=2, n_layer=2, block_size=64,
            n_terms=3, dropout=0.0, compute_dtype="float32")
KINDS = ("control", "diff", "ndiff")


def _leaf_arrays(tree, prefix):
    """A JAX param tree's leaves in the port's ``leaves`` order (sorted
    keys), as npz entries ``prefix0``, ``prefix1``, ..."""
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


def test_model_forward_matches_jax_mesh_forward(tmp_path):
    P, B, T = 2, 2, TINY["block_size"]
    mesh = create_mesh(JMeshConfig(sequence=P))
    rng = np.random.default_rng(30)
    inputs = {"kinds": np.array(KINDS), "device": np.array("cpu")}
    refs = {}
    for kind in KINDS:
        jcfg = JModelConfig(model=kind, attention_impl="pallas", **TINY)
        jparams = j_init_model(jax.random.PRNGKey(31), jcfg)
        jparams = jax.tree_util.tree_map(
            lambda a: a + 0.05 * jnp.asarray(
                rng.standard_normal(a.shape).astype(np.float32)), jparams)
        idx = rng.integers(0, TINY["vocab_size"], (B, T))
        tgt = rng.integers(0, TINY["vocab_size"], (B, T))
        refs[kind] = jax.jit(lambda p, i, t, jcfg=jcfg: j_model_forward(
            p, i, jcfg, targets=t, mesh=mesh))(jparams, jnp.asarray(idx), jnp.asarray(tgt))
        inputs.update(_leaf_arrays(jparams, f"p_{kind}_"))
        inputs[f"cfg_{kind}"] = np.array(json.dumps(dict(TINY, model=kind)))
        inputs[f"x_{kind}"], inputs[f"y_{kind}"] = idx, tgt
    outs = run_ranks("model", P, tmp_path, inputs)
    for kind, (jlogits, jloss) in refs.items():
        logits = np.concatenate([o[f"logits_{kind}"] for o in outs], axis=1)
        loss = sum(float(o[f"loss_{kind}"]) for o in outs)
        assert _err(jlogits, logits) <= FP32_TOL * max(1.0, _top(jlogits)), kind
        assert abs(float(jloss) - loss) <= FP32_TOL, kind


def test_sp_train_step_matches_jax_sharded_step(tmp_path):
    P, kind = 2, "diff"
    common = dict(micro_batch_size=2, max_iters=20, learning_rate=3e-3,
                  min_lr=3e-4, warmup_iters=0, weight_decay=0.1,
                  vocab_size=TINY["vocab_size"], anomaly_warmup_steps=1)
    jcfg = JTrainConfig(model=JModelConfig(model=kind, attention_impl="pallas", **TINY),
                        mesh=JMeshConfig(sequence=P), **common)
    cfg = TrainConfig(model=ModelConfig(model=kind, **TINY),
                      mesh=MeshConfig(sequence=P), sampler="replacement", **common)
    jstate = j_create_train_state(jax.random.PRNGKey(8), jcfg)
    host = jax.tree_util.tree_map(np.asarray, jstate)
    state = train_state_from_jax(host, cfg.resolved_model())
    rng = np.random.default_rng(40)
    x = rng.integers(0, TINY["vocab_size"], (1, 2, TINY["block_size"]))
    y = rng.integers(0, TINY["vocab_size"], (1, 2, TINY["block_size"]))
    mesh = create_mesh(jcfg.mesh)
    jstep = j_make_sharded_train_step(jcfg, mesh, jstate)
    jgrads = jax.jit(jax.grad(lambda p: j_model_forward(
        p, jnp.asarray(x[0]), jcfg.resolved_model(), targets=jnp.asarray(y[0]),
        mesh=mesh)[1]))(jstate["params"])
    jnew, jm = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)})

    meta = {"model": dict(TINY, model=kind),
            "train": dict(common, sampler="replacement"),
            "count": state["opt_state"]["count"], "step": state["step"],
            "guard": {k: float(v) if k == "ema" else int(v)
                      for k, v in state["guard"].items()}}
    inputs = {"meta": np.array(json.dumps(meta)), "x": x, "y": y,
              "device": np.array("cpu")}
    for name, tree in (("p", state["params"]), ("mu", state["opt_state"]["mu"]),
                       ("nu", state["opt_state"]["nu"])):
        inputs.update({f"{name}{i}": t.detach().numpy() for i, t in enumerate(leaves(tree))})
    outs = run_ranks("step", P, tmp_path, inputs)
    o = outs[0]
    assert abs(float(jm["loss"]) - float(o["loss"])) <= FP32_TOL
    assert abs(float(jm["grad_norm"]) - float(o["grad_norm"])) <= \
        GRAD_REL * float(jm["grad_norm"])
    jg = _leaf_arrays(jgrads, "g")
    jp = _leaf_arrays(jnew["params"], "p")
    n = len(jg)
    for i in range(n):
        ref = jg[f"g{i}"]
        assert _err(ref, o[f"g{i}"]) <= GRAD_REL * _top(ref), i
        assert _err(jp[f"p{i}"], o[f"p{i}"]) <= 2e-5, i
    # the ranks end with bit-identical params
    for other in outs[1:]:
        for i in range(n):
            assert np.array_equal(other[f"p{i}"], o[f"p{i}"]), i


# ---------------------------------------------------------------------------
# (e) the command line and the group's refusals
# ---------------------------------------------------------------------------


def test_cli_trains_sequence_parallel_over_gloo_on_the_cpu(tmp_path):
    rng = np.random.default_rng(50)
    tokens = tmp_path / "tokens.npy"
    np.save(tokens, ((rng.zipf(1.3, 20000) - 1) % 64).astype(np.int32))
    argv = ["--model", "diff", "--tokens", str(tokens), "--sampler", "replacement",
            "--device", "cpu", "--n-embd", "32", "--n-head", "2", "--n-layer", "2",
            "--block-size", "64", "--vocab-size", "64", "--micro-batch-size", "2",
            "--max-iters", "2", "--eval-interval", "2", "--eval-iters", "1",
            "--warmup-iters", "1", "--learning-rate", "3e-3", "--dropout", "0.1",
            "--compute-dtype", "float32", "--metrics-path", "",
            "--sequence-parallel", "2", "--dist-backend", "gloo"]
    outs = run_ranks("cli", 2, tmp_path / "ranks", {"argv": np.array(argv)})
    losses = outs[0]["losses"]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    # the loss is reduced over the ring: every rank reports the same one
    assert np.array_equal(outs[1]["losses"], losses)


def test_cli_trains_sequence_parallel_from_the_corpus_over_gloo(tmp_path):
    """``--dataset`` on a ring: rank 0 trains the BPE and writes the cache
    entry and ``tokenizer_dir`` while rank 1 waits, then rank 1 loads the
    entry (no BPE of its own); both train on that stream to the same
    losses, and the checkpoints record the tokenizer's fingerprint."""
    from differential_transformer_replication_tpu_torch.data.tokenizer import (
        load_tokenizer,
        tokenizer_fingerprint,
    )
    from differential_transformer_replication_tpu_torch.train.checkpoint import (
        read_meta,
    )

    tok_dir, run = tmp_path / "tok", tmp_path / "run"
    argv = ["--model", "diff", "--dataset", "synthetic", "--num-train-samples", "200",
            "--tokenizer-dir", str(tok_dir), "--device", "cpu", "--n-embd", "32",
            "--n-head", "2", "--n-layer", "1", "--block-size", "64",
            "--micro-batch-size", "2", "--max-iters", "2", "--eval-interval", "2",
            "--eval-iters", "1", "--warmup-iters", "1", "--compute-dtype", "float32",
            "--metrics-path", "", "--checkpoint-path", str(run / "best.ckpt"),
            "--sequence-parallel", "2", "--dist-backend", "gloo"]
    outs = run_ranks("cli_corpus", 2, tmp_path / "ranks", {"argv": np.array(argv)})
    assert [int(o["bpe_trainings"]) for o in outs] == [1, 0]
    losses = outs[0]["losses"]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert np.array_equal(outs[1]["losses"], losses)
    entries = sorted(p.name for p in tok_dir.iterdir() if p.is_dir())
    assert len(entries) == 1 and entries[0].startswith("cache-")  # no tmp left
    fp = tokenizer_fingerprint(load_tokenizer(str(tok_dir)))
    assert fp == tokenizer_fingerprint(load_tokenizer(str(tok_dir / entries[0])))
    for ckpt in ("best.ckpt", "best.last.ckpt"):
        assert read_meta(str(run / ckpt))["tokenizer_fingerprint"] == fp


def test_cli_refuses_ulysses_and_a_bad_split():
    """Ulysses runs where the heads split over the sequence ranks; it is
    refused, with JAX's text, where they do not. The pipeline axis
    runs too, and refuses the splits JAX refuses: the pipeline's layers."""
    with pytest.raises(ValueError, match="n_layer=3 not divisible by pipeline=2"):
        cli.run(["--tokens", "t.npy", "--sequence-parallel", "2", "--n-layer", "3",
                 "--pipeline-parallel", "2", "--dist-backend", "gloo"])
    with pytest.raises(ValueError, match="local heads divisible"):
        TrainConfig(model=ModelConfig(model="diff", sequence_impl="ulysses"),
                    mesh=MeshConfig(sequence=8), control_head_multiplier=1)
    assert TrainConfig(model=ModelConfig(model="diff", sequence_impl="ulysses"),
                       mesh=MeshConfig(sequence=2)).mesh.sequence == 2
    with pytest.raises(ValueError, match="equal sequence shards"):
        TrainConfig(model=ModelConfig(block_size=97), mesh=MeshConfig(sequence=2))
    # a shard off the kernels' 32-row tile grid is fine: they mask past it
    assert TrainConfig(model=ModelConfig(block_size=100),
                       mesh=MeshConfig(sequence=2)).mesh.sequence == 2
    assert MeshConfig(sequence=2, pipeline=2).n_devices == 4
    args = cli.build_parser().parse_args(["--tokens", "t.npy", "--sequence-parallel", "4",
                                          "--block-size", "1024"])
    assert args.dist_backend == "nccl"
    assert cli.config_from_args(args).mesh.sequence == 4


def test_each_rank_folds_its_rank_into_the_dropout_seed():
    """On the ring every rank's dropout masks are its own: the forward's
    seed is fold_seed(seed, rank) there (as JAX folds the mesh position
    into the attention key), unchanged without a ring."""
    from differential_transformer_replication_tpu_torch.models import common
    from differential_transformer_replication_tpu_torch.ops.dropout import fold_seed

    ranks = [tmesh.SequenceGroup(r, 4, torch.device("cpu"), "gloo") for r in range(4)]
    seeds = [common.rank_seed(77, sg) for sg in ranks]
    assert seeds == [fold_seed(77, r) for r in range(4)] and len(set(seeds)) == 4
    assert common.rank_seed(None, ranks[1]) is None
    assert common.rank_seed(77, None) == 77
    assert common.rank_seed(77, tmesh.SequenceGroup(0, 1, torch.device("cpu"), "gloo")) == 77
    assert [common.shard_start(32, sg) for sg in ranks] == [0, 32, 64, 96]


def test_nccl_without_a_card_per_rank_raises(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="--dist-backend gloo"):
        tmesh.init_sequence_group("nccl", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tmesh.init_sequence_group("mpi", device="cpu")
    assert not torch.distributed.is_initialized()
