"""The port's head-major attention route against the JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own
``tests/test_flash.py`` and ``tests/test_flash_dropout.py`` do; inputs
come from numpy with a seed and go to both sides. Held here:

- (a) the attention-dropout keep masks: the port's ``dropout_keep_ids`` /
  ``dropout_keep_reference`` equal JAX's bit for bit;
- (b) the plain head-major forward and its autograd backward (the CPU
  route of ``_FlashBhFn``) against JAX ``_flash`` called with the same
  seed words, on each of the JAX routes (fused, split, tiled backward;
  resident and tiled forward), switched with ``monkeypatch`` on the JAX
  module's thresholds as ``tests/test_flash.py`` does;
- (c) control, diff and ndiff losses and every gradient through the
  head-major route at dropout 0 (the token-major envelope patched down
  on both sides so a small T leaves it);
- (d) model-level dropout determinism;
- (e) a tiny CPU trainer run with attention dropout past the envelope;
- (f) the row-by-row bounds the kernels are held to on the card
  (``testing.py``): faults planted in the plain results fail them, a
  change of fp32 summation order passes.

Tolerances: fp32 outputs 1e-5 max-abs, gradients 1e-4 of each tensor's
max |value| (the same math, sums in another order). bf16: a p~ whose
bf16 rounding flips moves an output row by 2^-8 * p~ * sum|c| * max|V|
(JAX's tiles are 16 keys, the port's 32, so p is rounded against
running maxima of other tiles), plus one bf16 step; gradients one bf16
step plus 2^-8 * max|ref| * sqrt(T).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu.config import ModelConfig as JModelConfig
from differential_transformer_replication_tpu.models import (
    init_model as j_init_model,
    model_forward as j_model_forward,
)
from differential_transformer_replication_tpu.ops import flash as jflash
from differential_transformer_replication_tpu_torch import testing
from differential_transformer_replication_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
)
from differential_transformer_replication_tpu_torch.models import model_forward
from differential_transformer_replication_tpu_torch.ops import flash as tflash
from differential_transformer_replication_tpu_torch.params import params_from_jax
from differential_transformer_replication_tpu_torch.train.optim import leaves

FP32_TOL = 1e-5
GRAD_REL = 1e-4


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


# ---------------------------------------------------------------------------
# (a) the keep masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.1, 0.5, 1e-6])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_keep_masks_equal_jax_bit_for_bit(S, rate):
    rng = np.random.default_rng(int(S * 100 + rate * 1000))
    for BH, T in ((1, 64), (2, 24), (3, 9)):
        seed = _seed_pair(rng)
        ref = np.asarray(jflash.dropout_keep_reference(jnp.asarray(seed), BH, S, T, rate))
        got = tflash.dropout_keep_reference(torch.from_numpy(seed), BH, S, T, rate)
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), ref)
    # large coordinates and b*H + h: the products wrap mod 2^32
    seed = _seed_pair(rng)
    w0, w1 = (int(x) for x in seed[0])
    rows = np.array([[0], [63], [8191], [16383], [40000]], np.int32)
    cols = np.array([[0, 1, 4095, 8190, 39999]], np.int32)
    for bh in (0, 127, 4095, 1 << 20):
        ref = np.asarray(jflash.dropout_keep_ids(
            jnp.uint32(w0), jnp.uint32(w1), jnp.asarray(bh, jnp.int32), S - 1,
            jnp.asarray(rows), jnp.asarray(cols), rate))
        got = tflash.dropout_keep_ids(w0, w1, bh, S - 1, torch.from_numpy(rows),
                                      torch.from_numpy(cols), rate)
        assert np.array_equal(got.numpy(), ref)


def test_seed_words_come_from_an_explicit_generator():
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(3)
    g2.manual_seed(3)
    a, b = (tflash.dropout_seed_from_generator(g) for g in (g1, g2))
    assert a.shape == (1, 2) and a.dtype == torch.float32 and torch.equal(a, b)
    words = tflash.seed_words(a)
    assert all(0 <= w < 1 << 24 and float(w) == x for w, x in zip(words, a[0].tolist()))
    assert not torch.equal(a, tflash.dropout_seed_from_generator(g1))
    assert tflash.keep_threshold(1e-6) == 4295 and tflash.keep_threshold(1.0) == 2 ** 32 - 1


# ---------------------------------------------------------------------------
# (b) the plain head-major forward and backward against JAX _flash
# ---------------------------------------------------------------------------

ROUTES = {
    # route: the thresholds to patch on both sides (JAX module, port module)
    "fused": {},
    "split": {"_FUSED_BWD_BUDGET": 0},
    "tiled": {"_FUSED_BWD_BUDGET": 0, "_KV_TILE_THRESHOLD": 16,
              "_BWD_KV_TILE_THRESHOLD": 16},
}
B, H, T, D, DV = 2, 2, 48, 8, 16
BLOCKS = (16, 16, 16, 16)


def _bh_inputs(rng, S):
    BH = B * H
    q = rng.standard_normal((BH, S, T, D)).astype(np.float32)
    k = rng.standard_normal((BH, S, T, D)).astype(np.float32)
    v = rng.standard_normal((BH, T, DV)).astype(np.float32)
    c = (0.5 * rng.standard_normal((S, H))).astype(np.float32)
    c[0] = 1.0
    g = rng.standard_normal((BH, T, DV)).astype(np.float32)
    return q, k, v, c, g


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p01"])
@pytest.mark.parametrize("route,S,dtype", [
    ("fused", 2, "float32"), ("split", 2, "float32"), ("tiled", 2, "float32"),
    ("fused", 1, "float32"), ("split", 4, "float32"), ("split", 5, "float32"),
    ("split", 2, "bfloat16"), ("tiled", 2, "bfloat16"),
])
def test_flash_bh_matches_jax_flash(monkeypatch, route, S, dtype, rate):
    for name, value in ROUTES[route].items():
        monkeypatch.setattr(jflash, name, value)
        monkeypatch.setattr(tflash, name, value)
    assert tflash.bwd_route(S, T) == route
    assert tflash.fwd_route(T) == ("tiled" if route == "tiled" else "resident")
    rng = np.random.default_rng([S, int(rate * 10), len(route), len(dtype)])
    q, k, v, c, g = _bh_inputs(rng, S)
    seed = _seed_pair(rng)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    c_r = np.broadcast_to(c.T[None], (B, H, S)).reshape(B * H, S)

    def jfn(q, k, v, c_r):
        return jflash._flash(q, k, v, c_r, jnp.asarray(seed), BLOCKS, True, rate)

    jout, vjp = jax.vjp(jfn, *(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                        jnp.asarray(c_r))
    jdq, jdk, jdv, jdc = vjp(jnp.asarray(g).astype(jdt))
    jdc = np.asarray(jdc).reshape(B, H, S).sum(0).T

    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v))
    tc = torch.from_numpy(c).requires_grad_(True)
    out = tflash.flash_bh(tq, tk, tv, tc, torch.from_numpy(seed), H, rate)
    out.backward(torch.from_numpy(g).to(tdt))
    assert out.dtype == tdt and out.shape == (B * H, T, DV)
    pairs = [(jdq, tq.grad), (jdk, tk.grad), (jdv, tv.grad), (jdc, tc.grad)]
    if dtype == "float32":
        assert _err(jout, out) <= FP32_TOL
        for ref, got in pairs:
            assert _err(ref, got) <= GRAD_REL * _top(ref)
    else:
        inv = 1.0 / (1.0 - rate)
        tol = 2.0 ** -8 * inv * float(np.abs(c).sum(0).max()) * _top(v) \
            + 2.0 ** -7 * _top(jout)
        assert _err(jout, out) <= tol
        for ref, got in pairs:
            top = _top(ref)
            assert _err(ref, got) <= 2.0 ** -7 * top + 2.0 ** -8 * top * T ** 0.5


def test_stacked_entry_matches_jax():
    """``multi_stream_flash_attention`` ((S, B, T, H, d) layout) against
    JAX's, dropout on, forward only."""
    rng = np.random.default_rng(7)
    S = 2
    qs, ks = (rng.standard_normal((S, B, T, H, D)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((B, T, H, DV)).astype(np.float32)
    c = np.array([[1.0, 1.0], [-0.3, -0.6]], np.float32)
    ref = jflash.multi_stream_flash_attention(
        jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(v), jnp.asarray(c),
        block_q=16, block_k=16)
    got = tflash.multi_stream_flash_attention(
        torch.from_numpy(qs), torch.from_numpy(ks), torch.from_numpy(v),
        torch.from_numpy(c))
    assert got.shape == (B, T, H, DV) and _err(ref, got) <= FP32_TOL
    # with a generator the rate is live and the output moves; without, inert
    gen = torch.Generator()
    gen.manual_seed(1)
    dropped = tflash.multi_stream_flash_attention(
        torch.from_numpy(qs), torch.from_numpy(ks), torch.from_numpy(v),
        torch.from_numpy(c), dropout_rate=0.5, dropout_gen=gen)
    inert = tflash.multi_stream_flash_attention(
        torch.from_numpy(qs), torch.from_numpy(ks), torch.from_numpy(v),
        torch.from_numpy(c), dropout_rate=0.5)
    assert _err(got, dropped) > 0.1 and _err(got, inert) == 0.0


# ---------------------------------------------------------------------------
# (c) the three families through the head-major route, dropout 0
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=64, n_embd=32, n_head=2, n_layer=2, block_size=32,
            n_terms=3, compute_dtype="float32")


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


@pytest.fixture
def past_the_envelope(monkeypatch):
    """Both sides' token-major envelope cut to T <= 16, so T = 32 runs the
    head-major route."""
    monkeypatch.setattr(jflash, "_TM_BWD_MAX_T", 16)
    monkeypatch.setattr(tflash, "TM_MAX_T", 16)
    tflash.reset_bh_counters()


@pytest.mark.parametrize("kind", ["control", "diff", "ndiff"])
def test_model_head_major_route_matches_jax(past_the_envelope, kind):
    jcfg = JModelConfig(model=kind, attention_impl="pallas", ffn_impl="pallas",
                        dropout=0.0, **TINY)
    cfg = ModelConfig(model=kind, dropout=0.0, **TINY)
    jparams = j_init_model(jax.random.PRNGKey(8), jcfg)
    rng = np.random.default_rng(60)
    jparams = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
        jparams)
    Bm, Tm = 2, TINY["block_size"]
    idx = rng.integers(0, TINY["vocab_size"], (Bm, Tm))
    tgt = rng.integers(0, TINY["vocab_size"], (Bm, Tm))

    def jloss(p):
        return j_model_forward(p, jnp.asarray(idx), jcfg, targets=jnp.asarray(tgt))[1]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    params = params_from_jax(_tree_np(jparams), cfg)
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    _, loss = model_forward(params, torch.as_tensor(idx), cfg,
                            targets=torch.as_tensor(tgt))
    loss.backward()
    assert abs(float(jl) - float(loss.detach())) <= FP32_TOL
    ref, got = _flat(_tree_np(jg)), _flat(params)
    assert ref.keys() == got.keys()
    for name in ref:
        assert _err(ref[name], got[name].grad) <= GRAD_REL * _top(ref[name]), name


# ---------------------------------------------------------------------------
# (d) dropout determinism, (e) a trainer run with dropout past the envelope
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["control", "diff", "ndiff"])
def test_model_dropout_is_a_function_of_the_seed(past_the_envelope, kind):
    from differential_transformer_replication_tpu_torch.models import init_model

    cfg = ModelConfig(model=kind, dropout=0.1, **TINY)
    gen = torch.Generator()
    gen.manual_seed(2)
    params = init_model(gen, cfg)
    idx = torch.randint(0, TINY["vocab_size"], (2, 32), generator=gen)
    tgt = torch.randint(0, TINY["vocab_size"], (2, 32), generator=gen)
    with torch.no_grad():
        loss = [float(model_forward(params, idx, cfg, targets=tgt, seed=s)[1])
                for s in (11, 11, 12)]
        evals = float(model_forward(params, idx, cfg, targets=tgt)[1])
        no_drop = float(model_forward(params, idx, cfg.replace(dropout=0.0),
                                      targets=tgt, seed=11)[1])
    assert loss[0] == loss[1] and loss[0] != loss[2]
    assert evals == no_drop and loss[0] != evals
    # the seeded forwards and the eval one all ran head-major
    assert tflash.flash_bh_fwd.launches == 0  # plain versions on the CPU


def test_trainer_with_attention_dropout_past_the_envelope(past_the_envelope,
                                                          tmp_path, capsys):
    from differential_transformer_replication_tpu_torch.train import trainer

    rng = np.random.default_rng(0)
    tokens = np.tile(rng.integers(0, 48, 97), 60).astype(np.int32)
    np.save(tmp_path / "t.npy", tokens)
    cfg = TrainConfig(
        model=ModelConfig(model="diff", vocab_size=64, n_embd=32, n_head=2,
                          n_layer=2, block_size=24, dropout=0.1,
                          compute_dtype="float32"),
        vocab_size=64, micro_batch_size=8, max_iters=30, eval_interval=30,
        eval_iters=1, warmup_iters=3, learning_rate=3e-3, sampler="replacement",
        seed=4)
    state, history = trainer.train(cfg, str(tmp_path / "t.npy"), device="cpu")
    losses = [m["loss"] for m in history]
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3
    assert "val loss" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# (f) the row-by-row bounds of the kernel checks
# ---------------------------------------------------------------------------

PLANT_WORDS = (0x51F00D, 0x2A7E11)


def _plain_bh(dtype, rate, S=2, T=520, H=2):
    """Plain head-major forward and backward at recipe widths (d 96, dv
    192), delta from the forward's o_all as the autograd backward makes
    it. Returns (inputs, forward, backward)."""
    gen = torch.Generator()
    gen.manual_seed(3)
    BH = H
    q, k = (torch.randn(BH, S, T, 96, generator=gen).to(dtype) for _ in range(2))
    v, g = (torch.randn(BH, T, 192, generator=gen).to(dtype) for _ in range(2))
    c = 0.5 * torch.randn(S, H, generator=gen)
    c[0] = 1.0
    fwd = tflash.bh_attention_fwd_reference(q, k, v, c, rate, PLANT_WORDS)
    c_bh = tflash._coeffs_bh(c, BH)
    base = torch.einsum("btd,bstd->bst", g.float(), fwd[1].float())
    delta = (base * c_bh[:, :, None]).contiguous()
    bwd = tflash.bh_attention_bwd_reference(q, k, v, g, fwd[2], delta, c, rate,
                                            PLANT_WORDS)
    return (q, k, v, g, c, c_bh, delta), fwd, bwd


@pytest.mark.parametrize("fault", ["dq_late_rows", "dk_late_keys", "bwd_no_mask",
                                   "fwd_no_mask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_row_bounds_reject_planted_faults(dtype, fault):
    """A kernel that got the rows past T/2 wrong (their gradients are far
    smaller than the first rows') or left the keep mask out must fail."""
    rate, T = 0.1, 520
    (q, k, v, g, c, c_bh, delta), (out, o_all, lse), (rq, rk, rv) = _plain_bh(dtype, rate)
    if fault in ("dq_late_rows", "dk_late_keys"):
        ref = rq if fault == "dq_late_rows" else rk
        bad = ref.clone()
        bad[:, :, T // 2:] = 0
        assert testing.grad_ratio(bad, ref) > 1.0
        # a single late row is enough
        bad = ref.clone()
        bad[:, 1, T - 40] *= 1.1
        assert testing.grad_ratio(bad, ref) > 1.0
    elif fault == "bwd_no_mask":
        got = tflash.bh_attention_bwd_reference(q, k, v, g, lse, delta, c, 0.0,
                                                PLANT_WORDS)
        assert all(testing.grad_ratio(a, b) > 1.0 for a, b in zip(got, (rq, rk, rv)))
    else:
        n_out, n_oall, _ = tflash.bh_attention_fwd_reference(q, k, v, c, 0.0,
                                                             PLANT_WORDS)
        assert min(testing.attention_fwd_ratios(n_out, n_oall, out, o_all, c_bh)) > 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_row_bounds_hold_a_sum_order_change(monkeypatch, dtype):
    """The plain backward with its query rows taken 32 at a time instead of
    all at once sums dk and dv in another fp32 order (and so flips some
    bf16 roundings): the same shift a kernel's tiling makes, well inside
    the bounds."""
    (q, k, v, g, c, _, delta), (_, _, lse), ref = _plain_bh(dtype, 0.5)
    monkeypatch.setattr(tflash, "_QUERY_CHUNK", 32)
    got = tflash.bh_attention_bwd_reference(q, k, v, g, lse, delta, c, 0.5, PLANT_WORDS)
    assert any(not torch.equal(a, b) for a, b in zip(got, ref))
    assert max(testing.grad_ratio(a, b) for a, b in zip(got, ref)) <= 0.5
