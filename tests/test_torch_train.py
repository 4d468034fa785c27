"""The PyTorch port's training slice against the JAX package, on the CPU.

Inputs and cotangents come from numpy with a seed and go to both sides;
the JAX side runs its Pallas kernels in interpret mode, as its own tests
do. Held against ``jax.vjp`` / ``jax.value_and_grad``:

- the backward kernels' plain versions (the port's CPU route of every
  ``autograd.Function``): add+LayerNorm (with and without the carry
  cotangent), LayerNorm, SwiGLU, token-major attention per-array (S = 1,
  2, 4) and packed (S = 2), every cotangent including ``dcoeffs``;
- the model: loss and every param gradient of control, diff and ndiff
  (2 layers, narrow widths, T = 32) against JAX ``model_forward`` with
  ``attention_impl="pallas", ffn_impl="pallas"``;
- the slice end to end: three optimizer steps of ``make_train_step``
  from one JAX-initialised train state, and one step with
  ``grad_acc_steps = 2``;
- data: ``TokenWindows`` batches for one numpy seed.

Tolerances, fp32: 1e-5 max-abs on outputs (the same fp32 math, sums in
another order) and 1e-4 of each leaf's max |grad| on gradients (the
backward sums over T or M terms in another order). bf16 cases: one bf16
step (2^-7) of the largest output, plus the terms stated beside them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu.config import (
    ModelConfig as JModelConfig,
    TrainConfig as JTrainConfig,
)
from differential_transformer_replication_tpu.data.sampler import (
    TokenWindows as JTokenWindows,
)
from differential_transformer_replication_tpu.models import (
    init_model as j_init_model,
    model_forward as j_model_forward,
)
from differential_transformer_replication_tpu.ops.fused_ffn import (
    fused_swiglu as j_fused_swiglu,
)
from differential_transformer_replication_tpu.ops.fused_norm_residual import (
    fused_add_norm as j_fused_add_norm,
    fused_norm as j_fused_norm,
)
from differential_transformer_replication_tpu.ops.flash import (
    multi_stream_flash_attention_tm as j_tm,
    multi_stream_flash_attention_tm_packed as j_tm_packed,
)
from differential_transformer_replication_tpu.train.step import (
    create_train_state as j_create_train_state,
    make_train_step as j_make_train_step,
)
from differential_transformer_replication_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
)
from differential_transformer_replication_tpu_torch.data.sampler import (
    TokenWindows,
    split_tokens,
)
from differential_transformer_replication_tpu_torch.models import model_forward
from differential_transformer_replication_tpu_torch.ops import flash as tflash
from differential_transformer_replication_tpu_torch.ops import fused_ffn as tffn
from differential_transformer_replication_tpu_torch.ops import (
    fused_norm_residual as tfnr,
)
from differential_transformer_replication_tpu_torch.params import (
    params_from_jax,
    train_state_from_jax,
)
from differential_transformer_replication_tpu_torch.train.optim import leaves
from differential_transformer_replication_tpu_torch.train.step import (
    make_eval_step,
    make_train_step,
)

FP32_TOL = 1e-5
GRAD_REL = 1e-4


def _rng(seed):
    return np.random.default_rng(seed)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(dtype)


def _t(a, dtype=torch.float32, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return t.requires_grad_(grad)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _err(a, b) -> float:
    return float(np.max(np.abs(_np(a) - _np(b))))


def _grad_ok(ref, got, what=""):
    scale = max(float(np.max(np.abs(_np(ref)))), 1e-12)
    err = _err(ref, got)
    assert err <= GRAD_REL * scale, f"{what}: {err:.3g} > {GRAD_REL} * {scale:.3g}"


def _bf16_ulp(ref) -> float:
    return 2.0 ** -7 * float(np.max(np.abs(_np(ref))))


# ---------------------------------------------------------------------------
# the backward kernels' plain versions against jax.vjp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_gx", [True, False], ids=["carry_ct", "no_carry_ct"])
@pytest.mark.parametrize("jdt,tdt", [("float32", torch.float32),
                                     ("bfloat16", torch.bfloat16)],
                         ids=["fp32", "bf16"])
def test_add_norm_backward_matches_jax_vjp(jdt, tdt, with_gx):
    rng = _rng(21)
    M, E = 10, 48
    x, d = _randn(rng, 2, 5, E), _randn(rng, 2, 5, E)
    w, b = _randn(rng, E) + 1.0, _randn(rng, E)
    gx, gn = _randn(rng, 2, 5, E), _randn(rng, 2, 5, E)
    (jc, jn), vjp = jax.vjp(j_fused_add_norm, _j(x, jdt), _j(d, jdt), _j(w), _j(b))
    jct = (_j(gx, jdt) if with_gx else jnp.zeros_like(jc), _j(gn, jdt))
    jdx, jdd, jdw, jdb = vjp(jct)
    tx, td = _t(x, tdt, True), _t(d, tdt, True)
    tw, tb = _t(w, grad=True), _t(b, grad=True)
    carry, normed = tfnr.fused_add_norm(tx, td, tw, tb)
    assert carry.grad_fn is not None and normed.grad_fn is not None
    outs = [normed] + ([carry] if with_gx else [])
    cts = [_t(gn, tdt)] + ([_t(gx, tdt)] if with_gx else [])
    torch.autograd.backward(outs, cts)
    assert _err(jc, carry) == 0.0
    if tdt == torch.float32:
        assert _err(jn, normed) <= FP32_TOL
        for r, g, n in ((jdx, tx.grad, "dx"), (jdd, td.grad, "ddelta"),
                        (jdw, tw.grad, "dw"), (jdb, tb.grad, "db")):
            _grad_ok(r, g, n)
    else:
        # dx is rounded to bf16 once on each side from fp32 math
        assert _err(jdx, tx.grad) <= _bf16_ulp(jdx)
        assert _err(jdd, td.grad) <= _bf16_ulp(jdd)
        # fp32 column sums of the same bf16 inputs
        _grad_ok(jdw, tw.grad, "dw")
        _grad_ok(jdb, tb.grad, "db")
    assert M == 10 and tfnr.add_norm_bwd.launches == 0


def test_norm_backward_matches_jax_vjp():
    rng = _rng(22)
    x = _randn(rng, 7, 64, scale=2.0) - 0.3
    w, b, gn = _randn(rng, 64) + 1.0, _randn(rng, 64), _randn(rng, 7, 64)
    jn, vjp = jax.vjp(j_fused_norm, _j(x), _j(w), _j(b))
    jdx, jdw, jdb = vjp(_j(gn))
    tx, tw, tb = _t(x, grad=True), _t(w, grad=True), _t(b, grad=True)
    out = tfnr.fused_norm(tx, tw, tb)
    out.backward(_t(gn))
    assert _err(jn, out) <= FP32_TOL
    for r, g, n in ((jdx, tx.grad, "dx"), (jdw, tw.grad, "dw"), (jdb, tb.grad, "db")):
        _grad_ok(r, g, n)


@pytest.mark.parametrize("jdt,tdt", [("float32", torch.float32),
                                     ("bfloat16", torch.bfloat16)],
                         ids=["fp32", "bf16"])
def test_swiglu_backward_matches_jax_vjp(jdt, tdt):
    rng = _rng(23)
    E, F = 32, 128
    x = _randn(rng, 3, 5, E)
    wg, wx = _randn(rng, E, F, scale=0.2), _randn(rng, E, F, scale=0.2)
    bg, bx = _randn(rng, F, scale=0.1), _randn(rng, F, scale=0.1)
    gh = _randn(rng, 3, 5, F)
    jh, vjp = jax.vjp(j_fused_swiglu, _j(x, jdt), _j(wg), _j(bg), _j(wx), _j(bx))
    jgrads = vjp(_j(gh, jdt))
    targs = [_t(x, tdt, True)] + [_t(a, grad=True) for a in (wg, bg, wx, bx)]
    h = tffn.fused_swiglu(*targs)
    assert h.grad_fn is not None
    h.backward(_t(gh, tdt))
    names = ("dx", "dWg", "dbg", "dWx", "dbx")
    if tdt == torch.float32:
        assert _err(jh, h) <= FP32_TOL
        for r, t, n in zip(jgrads, targs, names):
            _grad_ok(r, t.grad, n)
    else:
        # both sides round dg/dt to bf16 and use the rounded values in
        # the weight grads, which (like the bias grads) are then cast to
        # bf16 (the weights were cast to x's dtype) and widened: one bf16
        # step of each result; dx is one bf16 matmul result each side
        for r, t, n in zip(jgrads, targs, names):
            assert _err(r, t.grad) <= 2 * _bf16_ulp(r), n
    assert tffn.swiglu_bwd.launches == 0


def _tm_inputs(rng, S, B, T, H, d, dv):
    qs = [_randn(rng, B, T, H, d) for _ in range(S)]
    ks = [_randn(rng, B, T, H, d) for _ in range(S)]
    v = _randn(rng, B, T, H, dv)
    c = _randn(rng, S, H, scale=0.5)
    c[0] = 1.0
    g = _randn(rng, B, T, H, dv)
    return qs, ks, v, c, g


@pytest.mark.parametrize("S", [1, 2, 4])
def test_tm_attention_per_array_matches_jax_vjp(S):
    rng = _rng(30 + S)
    B, T, H, d, dv = 2, 24, 2, 8, 16
    qs, ks, v, c, g = _tm_inputs(rng, S, B, T, H, d, dv)

    def jfn(qs_, ks_, v_, c_):
        return j_tm(tuple(qs_), tuple(ks_), v_, c_, B, H)

    jout, vjp = jax.vjp(jfn, [_j(a) for a in qs], [_j(a) for a in ks], _j(v), _j(c))
    jdq, jdk, jdv, jdc = vjp(_j(g))
    tq = [_t(a, grad=True) for a in qs]
    tk = [_t(a, grad=True) for a in ks]
    tv, tc = _t(v, grad=True), _t(c, grad=True)
    out = tflash.multi_stream_flash_attention_tm(tq, tk, tv, tc, B, H)
    out.backward(_t(g))
    assert _err(jout, out) <= FP32_TOL
    for s in range(S):
        _grad_ok(jdq[s], tq[s].grad, f"dq{s}")
        _grad_ok(jdk[s], tk[s].grad, f"dk{s}")
    _grad_ok(jdv, tv.grad, "dv")
    _grad_ok(jdc, tc.grad, "dcoeffs")
    assert tflash.flash_tm_fwd.launches == tflash.flash_tm_bwd.launches == 0


@pytest.mark.parametrize("jdt,tdt", [("float32", torch.float32),
                                     ("bfloat16", torch.bfloat16)],
                         ids=["fp32", "bf16"])
def test_tm_attention_packed_matches_jax_vjp(jdt, tdt):
    rng = _rng(40)
    S, B, T, H, d, dv = 2, 2, 24, 2, 8, 16
    W = 2 * S * H * d + H * dv
    proj = _randn(rng, B, T, W)
    c = np.array([[1.0, 1.0], [-0.3, -0.6]], np.float32)
    g = _randn(rng, B, T, H, dv)
    jout, vjp = jax.vjp(lambda p_, c_: j_tm_packed(p_, c_, B, H, S, d, dv),
                        _j(proj, jdt), _j(c))
    jdp, jdc = vjp(_j(g, jdt))
    tp, tc = _t(proj, tdt, True), _t(c, grad=True)
    out = tflash.multi_stream_flash_attention_tm_packed(tp, tc, B, H, S, d, dv)
    out.backward(_t(g, tdt))
    if tdt == torch.float32:
        assert _err(jout, out) <= FP32_TOL
        _grad_ok(jdp, tp.grad, "dproj")
        _grad_ok(jdc, tc.grad, "dcoeffs")
    else:
        # same rounding points on both sides (p before PV, ds before its
        # products); fp32 sums in another order can flip a rounding: two
        # bf16 steps of the largest value
        assert _err(jout, out) <= 2 * _bf16_ulp(jout)
        assert _err(jdp, tp.grad) <= 2 * _bf16_ulp(jdp)
        assert _err(jdc, tc.grad) <= 2 * _bf16_ulp(jdc)


def test_tm_reference_matches_dense_attention():
    """The token-major plain version against the port's dense
    multi-stream op (ops/attention.py) in fp32."""
    from differential_transformer_replication_tpu_torch.ops.attention import (
        causal_mask,
        ndiff_attention,
    )

    rng = _rng(41)
    S, B, T, H, d, dv = 3, 2, 16, 2, 8, 16
    qs, ks, v, c, _ = _tm_inputs(rng, S, B, T, H, d, dv)
    out = tflash.multi_stream_flash_attention_tm(
        [_t(a) for a in qs], [_t(a) for a in ks], _t(v), _t(c), B, H)
    ref = ndiff_attention(_t(np.stack(qs)), _t(np.stack(ks)), _t(v), _t(c),
                          torch.ones(S), mask=causal_mask(T))
    assert _err(ref, out) <= FP32_TOL


def test_tm_refuses_shapes_outside_its_envelope():
    """The token-major entries take only their envelope and name the
    head-major entry for the rest; training outside it (attention
    dropout, T > 512) is no longer refused: it runs head-major."""
    x = torch.zeros(1, 600, 2, 4)
    with pytest.raises(ValueError, match="multi_stream_flash_attention_bh"):
        tflash.multi_stream_flash_attention_tm([x], [x], x, torch.ones(1, 2), 1, 2)
    assert tflash.use_tm(4, 512, 0.0) and not tflash.use_tm(2, 512, 0.1)
    assert not tflash.use_tm(5, 512, 0.0)
    for model in (ModelConfig(dropout=0.1), ModelConfig(block_size=2048)):
        assert callable(make_train_step(TrainConfig(model=model)))


# ---------------------------------------------------------------------------
# the model: loss and every param gradient
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=64, n_embd=32, n_head=2, n_layer=2, block_size=32,
            n_terms=3, dropout=0.0, compute_dtype="float32")


def _tree_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("kind", ["control", "diff", "ndiff"])
def test_model_loss_and_grads_match_jax(kind):
    jcfg = JModelConfig(model=kind, attention_impl="pallas", ffn_impl="pallas",
                        **TINY)
    cfg = ModelConfig(model=kind, **TINY)
    jparams = j_init_model(jax.random.PRNGKey(5), jcfg)
    # non-zero lambda vectors and LayerNorm params, so their grads and
    # the coefficient path are exercised
    rng = _rng(50)
    jparams = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jnp.asarray(_randn(rng, *a.shape)), jparams)
    B, T = 2, 32
    idx = rng.integers(0, TINY["vocab_size"], (B, T))
    tgt = rng.integers(0, TINY["vocab_size"], (B, T))

    def jloss(p):
        return j_model_forward(p, jnp.asarray(idx), jcfg,
                               targets=jnp.asarray(tgt))[1]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    params = params_from_jax(_tree_np(jparams), cfg)
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    logits, loss = model_forward(params, torch.as_tensor(idx), cfg,
                                 targets=torch.as_tensor(tgt))
    assert logits.shape == (B, T, TINY["vocab_size"]) and not logits.requires_grad
    loss.backward()
    assert abs(float(jl) - float(loss.detach())) <= FP32_TOL
    ref, got = _flat(_tree_np(jg)), _flat(params)
    assert ref.keys() == got.keys()
    for name in ref:
        _grad_ok(ref[name], got[name].grad, name)
    # eval: no residuals, same loss
    with torch.no_grad():
        _, again = model_forward(params, torch.as_tensor(idx), cfg,
                                 targets=torch.as_tensor(tgt))
    assert abs(float(again) - float(loss.detach())) <= FP32_TOL


# ---------------------------------------------------------------------------
# the slice end to end: optimizer steps from one JAX-initialised state
# ---------------------------------------------------------------------------


def _train_cfgs(kind, grad_acc):
    common = dict(grad_acc_steps=grad_acc, micro_batch_size=2, max_iters=20,
                  learning_rate=3e-3, min_lr=3e-4, warmup_iters=2,
                  weight_decay=0.1, vocab_size=TINY["vocab_size"],
                  anomaly_warmup_steps=1)
    jm = JModelConfig(model=kind, attention_impl="pallas", ffn_impl="pallas",
                      **TINY)
    return (JTrainConfig(model=jm, **common),
            TrainConfig(model=ModelConfig(model=kind, **TINY),
                        sampler="replacement", **common))


@pytest.mark.parametrize("kind,n_steps,grad_acc",
                         [("diff", 3, 1), ("control", 1, 2)],
                         ids=["diff_3_steps", "control_grad_acc_2"])
def test_train_steps_match_jax(kind, n_steps, grad_acc):
    jcfg, cfg = _train_cfgs(kind, grad_acc)
    jstate = j_create_train_state(jax.random.PRNGKey(7), jcfg)
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                 cfg.resolved_model())
    jstep, step = j_make_train_step(jcfg), make_train_step(cfg)
    rng = _rng(60)
    stream = rng.integers(0, TINY["vocab_size"], 400)
    jds, ds = JTokenWindows(stream, 32), TokenWindows(stream, 32)
    r1, r2 = _rng(61), _rng(61)
    for i in range(n_steps):
        jb = jds.random_batches(r1, 2, grad_acc)
        tb = ds.random_batches(r2, 2, grad_acc)
        assert np.array_equal(np.asarray(jb["x"]), tb["x"].numpy())
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        assert abs(float(jm["loss"]) - m["loss"]) <= FP32_TOL, i
        assert abs(float(jm["grad_norm"]) - m["grad_norm"]) <= \
            GRAD_REL * float(jm["grad_norm"]), i
        assert abs(float(jm["learning_rate"]) - m["learning_rate"]) <= 1e-9, i
        np.testing.assert_allclose(m["grad_norm_groups"],
                                   np.asarray(jm["grad_norm_groups"]),
                                   rtol=GRAD_REL)
        assert int(jm["bad"]) == m["bad"] == 0
    assert n_steps < 3 or m["learning_rate"] > 0  # warmup ended by step 2
    ref, got = _flat(_tree_np(jstate["params"])), _flat(state["params"])
    for name in ref:
        # params move by lr * (bounded Adam step); their fp32 values agree
        # to the update's rounding
        assert _err(ref[name], got[name]) <= 2e-5, name
    jmu = _flat(_tree_np(jstate["opt_state"][1][0].mu))
    for name, t in _flat(state["opt_state"]["mu"]).items():
        _grad_ok(jmu[name], t, "mu " + name)
    assert state["step"] == n_steps == state["opt_state"]["count"]
    # the eval step matches the train loss path without grads
    loss = make_eval_step(cfg)(state["params"], tb["x"][0], tb["y"][0])
    assert torch.isfinite(loss) and not loss.requires_grad


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_token_windows_match_jax():
    rng = _rng(70)
    stream = rng.integers(0, 1000, 5000)
    jtr, jva = (JTokenWindows(a, 64) for a in
                __import__("differential_transformer_replication_tpu.data.sampler",
                           fromlist=["split_tokens"]).split_tokens(stream))
    tr, va = (TokenWindows(a, 64) for a in split_tokens(stream))
    assert len(jtr) == len(tr) and len(jva) == len(va)
    r1, r2 = _rng(3), _rng(3)
    for _ in range(3):
        jb, tb = jtr.random_batches(r1, 4, 2), tr.random_batches(r2, 4, 2)
        for k in ("x", "y"):
            assert np.array_equal(np.asarray(jb[k]), tb[k].numpy())
    jb, tb = jtr.random_batch(r1, 5), tr.random_batch(r2, 5)
    assert np.array_equal(np.asarray(jb["y"]), tb["y"].numpy())
    jb, tb = jva.sequential_batch(7, 8), va.sequential_batch(7, 8)
    assert np.array_equal(np.asarray(jb["x"]), tb["x"].numpy())
    assert tb["x"].dtype == torch.int64


# ---------------------------------------------------------------------------
# the kernel wrappers keep an autograd history on the card's branch
# ---------------------------------------------------------------------------


def test_wrappers_on_a_fake_card_keep_autograd_history(monkeypatch):
    """With the dispatch rule made to take the card's branch for CPU
    tensors (a fake card) and each kernel launch replaced by its plain
    version, a call on tensors that require grad returns an output with
    a ``grad_fn``, and its backward goes through the backward kernel's
    wrapper: the branch that launched ctypes/Triton kernels into
    ``torch.empty`` outputs with no history before the training slice."""
    from differential_transformer_replication_tpu_torch.ops import _kernels

    monkeypatch.setattr(_kernels, "on_card", lambda t, what: True)
    for fn in (tfnr.fused_add_norm, tfnr.fused_norm, tffn.fused_swiglu):
        # the fake launches count; the real counters are restored after
        monkeypatch.setattr(fn, "launches", fn.launches)
    calls = []

    def record(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tfnr, "_launch", record(
        "norm_fwd", lambda x, d, w, b, eps: (
            tfnr.add_norm_reference(x, d, w, b, eps) if d is not None
            else (x, tfnr.norm_reference(x, w, b, eps)))))
    monkeypatch.setattr(tfnr, "add_norm_bwd",
                        record("norm_bwd", tfnr.add_norm_bwd_reference))
    monkeypatch.setattr(tffn, "_launch", record("ffn_fwd", tffn.swiglu_reference))
    monkeypatch.setattr(tffn, "swiglu_bwd", record("ffn_bwd", tffn.swiglu_bwd_reference))
    monkeypatch.setattr(tflash, "flash_tm_fwd", record(
        "attn_fwd", lambda qs, ks, v, c, H, save: tflash.tm_attention_fwd_reference(
            qs, ks, v, c, H)))

    def fake_bwd(qs, ks, v, g, lse, delta, c, H, dqs, dks, dv):
        rq, rk, rv = tflash.tm_attention_bwd_reference(qs, ks, v, g, lse, delta, c, H)
        for dst, src in zip([*dqs, *dks, dv], [*rq, *rk, rv]):
            dst.copy_(src)

    monkeypatch.setattr(tflash, "flash_tm_bwd", record("attn_bwd", fake_bwd))
    rng = _rng(80)
    x = _t(_randn(rng, 4, 16), grad=True)
    w = _t(_randn(rng, 16) + 1, grad=True)
    b = _t(_randn(rng, 16), grad=True)
    carry, normed = tfnr.fused_add_norm(x, x * 2, w, b)
    out = tfnr.fused_norm(normed, w, b)
    wg, wx = _t(_randn(rng, 16, 32), grad=True), _t(_randn(rng, 16, 32), grad=True)
    bg, bx = _t(_randn(rng, 32), grad=True), _t(_randn(rng, 32), grad=True)
    h = tffn.fused_swiglu(out, wg, bg, wx, bx)
    proj = _t(_randn(rng, 1, 8, 2 * 2 * 2 * 4 + 2 * 8), grad=True)
    att = tflash.multi_stream_flash_attention_tm_packed(
        proj, torch.ones(2, 2), 1, 2, 2, 4, 8)
    for t in (carry, normed, out, h, att):
        assert t.grad_fn is not None
    (h.sum() + carry.sum() + att.sum()).backward()
    assert all(t.grad is not None for t in (x, w, b, wg, bg, wx, bx, proj))
    assert sorted(set(calls)) == ["attn_bwd", "attn_fwd", "ffn_bwd", "ffn_fwd",
                                  "norm_bwd", "norm_fwd"]


def test_decode_attention_refuses_inputs_that_require_grad():
    """decode_attention has no backward (nor has the JAX kernel): a call
    that autograd would differentiate raises on every device instead of
    returning an output without a gradient path."""
    from differential_transformer_replication_tpu_torch.ops.decode_attention import (
        decode_attention,
    )

    q = torch.zeros(1, 1, 1, 4, requires_grad=True)
    k, v = torch.zeros(1, 1, 1, 8, 4), torch.zeros(1, 1, 8, 4)
    pos, c = torch.zeros(1, dtype=torch.int32), torch.ones(1, 1)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(q, k, v, pos, c)
    with torch.no_grad():
        assert decode_attention(q, k, v, pos, c).shape == (1, 1, 4)


# ---------------------------------------------------------------------------
# config refusals and the trainer's records
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["control", "diff", "ndiff"])
def test_card_envelope_holds_the_recipe_and_refuses_past_each_limit(kind):
    from differential_transformer_replication_tpu_torch.models import (
        check_card_envelope,
    )

    recipe = TrainConfig(model=ModelConfig(model=kind),
                         sampler="replacement").resolved_model()
    for use in ("train", "serve"):
        check_card_envelope(recipe, use)
    # one head, width n_embd: d = n_embd (control) or n_embd / 2 with
    # dv = 2 d (diff, ndiff); at each limit it passes, one past it fails
    per_d = 1 if kind == "control" else 2
    for use, d_max, dv_max in (("train", 128, 256), ("serve", 256, 512)):
        check_card_envelope(ModelConfig(model=kind, n_embd=d_max * per_d,
                                        n_head=1), use)
        past = ModelConfig(model=kind, n_embd=(d_max + 1) * per_d, n_head=1)
        names = [rf"d = {d_max + 1} > {d_max}"]
        if kind != "control":  # dv = 2 d passes its own limit with d
            names.append(rf"dv = {2 * d_max + 2} > {dv_max}")
        with pytest.raises(ValueError, match=", ".join(names)
                           + r".*\(ROADMAP Queue C: head widths\)"):
            check_card_envelope(past, use)
    if kind == "ndiff":
        check_card_envelope(ModelConfig(model=kind, n_terms=8), "serve")
        with pytest.raises(ValueError, match=r"S = 9 > 8.*head widths"):
            check_card_envelope(ModelConfig(model=kind, n_terms=9), "serve")
        # training takes any stream count (head-major passes of four)
        check_card_envelope(ModelConfig(model=kind, n_terms=9), "train")


def test_metrics_records_match_the_jax_trainer(tmp_path):
    """Both trainers on one tiny config: the same step-record keys (less
    XLA's compile events: eager PyTorch has no compile cache), no
    tokens/sec on the first log, step_time_ms the mean of
    the steps since the last log and data_wait_frac a share of it."""
    import json

    from differential_transformer_replication_tpu.train.trainer import (
        train as j_train,
    )
    from differential_transformer_replication_tpu_torch.train import trainer

    tiny = dict(model="diff", vocab_size=256, n_embd=32, n_head=2, n_layer=2,
                block_size=16, dropout=0.0, compute_dtype="float32")
    common = dict(vocab_size=256, micro_batch_size=4, max_iters=6,
                  eval_interval=6, eval_iters=1, log_interval=2,
                  learning_rate=3e-3, min_lr=3e-4, warmup_iters=2, seed=7)
    jcfg = JTrainConfig(
        model=JModelConfig(**tiny), dataset="synthetic", num_train_samples=200,
        tokenizer_dir=str(tmp_path / "tok"),
        checkpoint_path=str(tmp_path / "ckpt"),
        last_checkpoint_path=str(tmp_path / "last"),
        metrics_path=str(tmp_path / "jax.jsonl"), **common)
    j_train(jcfg)
    np.save(tmp_path / "t.npy",
            np.random.default_rng(0).integers(0, 256, 4000).astype(np.int32))
    tcfg = TrainConfig(model=ModelConfig(**tiny), sampler="replacement",
                       metrics_path=str(tmp_path / "port.jsonl"), **common)
    _, history = trainer.train(tcfg, str(tmp_path / "t.npy"), device="cpu")

    def steps(path):
        return [r for r in map(json.loads, open(path)) if "loss" in r]

    jrec, trec = steps(tmp_path / "jax.jsonl"), steps(tmp_path / "port.jsonl")
    assert [r["iter"] for r in jrec] == [r["iter"] for r in trec] == [2, 4, 6]
    not_ported = {"compile_events"}
    for j, t in zip(jrec, trec):
        assert set(t) == set(j) - not_ported
    for recs in (jrec, trec):
        assert "tokens_per_sec" not in recs[0]
        assert all(r["tokens_per_sec"] > 0 for r in recs[1:])
        assert all(r["step_time_ms"] > 0 and 0.0 <= r["data_wait_frac"] <= 1.0
                   for r in recs)
    for r in trec:  # the mean of the log_interval steps up to this log
        window = history[r["iter"] - 2:r["iter"]]
        mean = sum(m["step_time_ms"] for m in window) / len(window)
        assert r["step_time_ms"] == round(mean, 3)
