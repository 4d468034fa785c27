"""The PyTorch port's ops against the JAX package's, on the CPU.

Inputs come from numpy with a seed and go to both sides. The plain ops
(norms, RoPE, lambdas/coefficients, SwiGLU) are held against their JAX
functions; the three kernel-holding modules' CPU paths (their plain
versions) against the JAX Pallas kernels, which run in interpret mode
off-TPU. fp32 agreement is <= 1e-5 max-abs. Each kernel module also has
one bf16 case with the looser bound stated beside it.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu.models.decode import (
    _rope_rows as j_rope_rows,
)
from differential_transformer_replication_tpu.ops import lambdas as jlam
from differential_transformer_replication_tpu.ops import norms as jnorms
from differential_transformer_replication_tpu.ops import rope as jrope
from differential_transformer_replication_tpu.ops import streams as jstreams
from differential_transformer_replication_tpu.ops.swiglu import swiglu as j_swiglu
from differential_transformer_replication_tpu.ops.decode_attention import (
    decode_attention as j_decode_attention,
    quantize_kv as j_quantize_kv,
)
from differential_transformer_replication_tpu.ops.fused_ffn import (
    fused_swiglu as j_fused_swiglu,
)
from differential_transformer_replication_tpu.ops.fused_norm_residual import (
    fused_add_norm as j_fused_add_norm,
    fused_norm as j_fused_norm,
)
from differential_transformer_replication_tpu_torch.ops import lambdas as tlam
from differential_transformer_replication_tpu_torch.ops import norms as tnorms
from differential_transformer_replication_tpu_torch.ops import rope as trope
from differential_transformer_replication_tpu_torch.ops import streams as tstreams
from differential_transformer_replication_tpu_torch.ops.swiglu import swiglu as t_swiglu
from differential_transformer_replication_tpu_torch.ops.decode_attention import (
    decode_attention as t_decode_attention,
    quantize_kv as t_quantize_kv,
)
from differential_transformer_replication_tpu_torch.ops.fused_ffn import (
    fused_swiglu as t_fused_swiglu,
    swiglu_instance,
)
from differential_transformer_replication_tpu_torch.ops.fused_norm_residual import (
    WARP_MAX_E,
    add_norm_bwd_instance,
    fused_add_norm as t_fused_add_norm,
    fused_norm as t_fused_norm,
)

FP32_TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(dtype)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _err(j_out, t_out) -> float:
    return float(np.max(np.abs(
        np.asarray(j_out, dtype=np.float32)
        - t_out.to(torch.float32).numpy()
    )))


def _bf16_ulp(ref) -> float:
    """One bf16 rounding step at the largest |value|: two computations
    that agree in fp32 differ after their final bf16 cast by at most
    this."""
    return 2.0 ** -7 * float(np.max(np.abs(np.asarray(ref, np.float32))))


# ---------------------------------------------------------------------------
# plain ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 7, 32), (5, 48)])
def test_layer_norm_matches_jax(shape):
    rng = _rng(1)
    x = _randn(rng, *shape, scale=3.0) + 0.5
    w = _randn(rng, shape[-1]) + 1.0
    b = _randn(rng, shape[-1])
    ref = jnorms.layer_norm(_j(x), _j(w), _j(b))
    got = tnorms.layer_norm(_t(x), _t(w), _t(b))
    assert _err(ref, got) <= FP32_TOL
    ref_g = jnorms.group_layer_norm(_j(x), _j(w), _j(b))
    got_g = tnorms.group_layer_norm(_t(x), _t(w), _t(b))
    assert _err(ref_g, got_g) <= FP32_TOL


def test_rope_headed_unheaded_and_rows_match_jax():
    rng = _rng(2)
    d, T = 16, 40
    jcos, jsin = jrope.rope_cos_sin(d, T)
    tcos, tsin = trope.rope_cos_sin(d, T)
    assert _err(jcos, tcos) <= FP32_TOL and _err(jsin, tsin) <= FP32_TOL
    # headed (B, T, H, d), rotated with tables truncated to T=11
    x = _randn(rng, 2, 11, 3, d)
    assert _err(jrope.apply_rope(_j(x), jcos, jsin),
                trope.apply_rope(_t(x), tcos, tsin)) <= FP32_TOL
    # unheaded (T, d)
    x2 = _randn(rng, 9, d)
    assert _err(jrope.apply_rope(_j(x2), jcos, jsin),
                trope.apply_rope(_t(x2), tcos, tsin)) <= FP32_TOL
    # per-row positions (S, B, H, d), incl. positions past a 32-slot ring
    xs = _randn(rng, 2, 4, 3, d)
    pos = np.array([0, 5, 33, 39])
    assert _err(j_rope_rows(_j(xs), jcos[pos], jsin[pos]),
                trope.rope_rows(_t(xs), tcos[pos], tsin[pos])) <= FP32_TOL
    # the pairing is even/odd lanes: lane 0 and lane 1 rotate together
    one = np.zeros((1, d), np.float32)
    one[0, 0] = 1.0
    out = trope.apply_rope(_t(one), tcos[3:], tsin[3:]).numpy()
    assert abs(out[0, 0] - math.cos(3.0)) < 1e-6
    assert abs(out[0, 1] - math.sin(3.0)) < 1e-6


@pytest.mark.parametrize("kind", ["control", "diff", "ndiff"])
def test_lambdas_and_coeffs_match_jax(kind):
    rng = _rng(3)
    H, d, n = 3, 8, 4
    for layer in (1, 2, 8):
        assert tlam.lambda_init_schedule(layer) == jlam.lambda_init_schedule(layer)
    assert tlam.OUTPUT_SCALE == jlam.OUTPUT_SCALE == pytest.approx(0.2)
    if kind == "control":
        ref = jstreams.vanilla_coeffs(H)
        got = tstreams.vanilla_coeffs(H)
    elif kind == "diff":
        lq = _randn(rng, 2, H, d, scale=0.1)
        lk = _randn(rng, 2, H, d, scale=0.1)
        init = jlam.lambda_init_schedule(3)
        jl = jlam.diff_lambda(_j(lq[0]), _j(lk[0]), _j(lq[1]), _j(lk[1]), init)
        tl = tlam.diff_lambda(_t(lq[0]), _t(lk[0]), _t(lq[1]), _t(lk[1]), init)
        assert _err(jl, tl) <= FP32_TOL
        ref, got = jstreams.diff_coeffs(jl), tstreams.diff_coeffs(tl)
    else:
        lq = _randn(rng, n, H, d, scale=0.1)
        lk = _randn(rng, n, H, d, scale=0.1)
        init = jlam.lambda_init_schedule(5)
        jl = jlam.ndiff_lambdas(_j(lq), _j(lk), init)
        tl = tlam.ndiff_lambdas(_t(lq), _t(lk), init)
        assert _err(jl, tl) <= FP32_TOL
        js, ts = jlam.ndiff_signs(n), tlam.ndiff_signs(n)
        assert np.array_equal(np.asarray(js), ts.numpy())
        assert ts.tolist() == [1.0, -1.0, 1.0, -1.0]  # first map +lambda_0
        ref, got = jstreams.ndiff_coeffs(jl, js), tstreams.ndiff_coeffs(tl, ts)
    assert tuple(got.shape) == tuple(ref.shape)
    assert got.dtype == torch.float32
    assert _err(ref, got) <= FP32_TOL


def test_swiglu_matches_jax():
    rng = _rng(4)
    x = _randn(rng, 6, 32)
    wg, wx = _randn(rng, 32, 128, scale=0.1), _randn(rng, 32, 128, scale=0.1)
    bg, bx = _randn(rng, 128, scale=0.1), _randn(rng, 128, scale=0.1)
    ref = j_swiglu(_j(x), _j(wg), _j(bg), _j(wx), _j(bx))
    got = t_swiglu(_t(x), _t(wg), _t(bg), _t(wx), _t(bx))
    assert _err(ref, got) <= FP32_TOL


# ---------------------------------------------------------------------------
# the kernel-holding modules' CPU paths against the JAX Pallas kernels
# ---------------------------------------------------------------------------

DTYPES = [("float32", torch.float32), ("bfloat16", torch.bfloat16)]


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["fp32", "bf16"])
def test_fused_add_norm_cpu_path_matches_pallas(jdt, tdt):
    rng = _rng(5)
    x, d = _randn(rng, 2, 5, 48), _randn(rng, 2, 5, 48)
    w, b = _randn(rng, 48) + 1.0, _randn(rng, 48)
    j_carry, j_norm = j_fused_add_norm(_j(x, jdt), _j(d, jdt), _j(w), _j(b))
    t_carry, t_norm = t_fused_add_norm(_t(x, tdt), _t(d, tdt), _t(w), _t(b))
    assert t_carry.dtype == t_norm.dtype == tdt
    # the add is in the stored dtype on both sides: the carry is exact
    assert _err(j_carry, t_carry) == 0.0
    tol = FP32_TOL if tdt == torch.float32 else _bf16_ulp(j_norm)
    assert _err(j_norm, t_norm) <= tol
    assert t_fused_add_norm.launches == 0  # the CPU path launches nothing


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["fp32", "bf16"])
def test_fused_norm_cpu_path_matches_pallas(jdt, tdt):
    rng = _rng(6)
    x = _randn(rng, 7, 64, scale=2.0) - 0.3
    w, b = _randn(rng, 64) + 1.0, _randn(rng, 64)
    ref = j_fused_norm(_j(x, jdt), _j(w), _j(b))
    got = t_fused_norm(_t(x, tdt), _t(w), _t(b))
    assert got.dtype == tdt
    tol = FP32_TOL if tdt == torch.float32 else _bf16_ulp(ref)
    assert _err(ref, got) <= tol
    assert t_fused_norm.launches == 0


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["fp32", "bf16"])
def test_fused_swiglu_cpu_path_matches_pallas(jdt, tdt):
    rng = _rng(7)
    x = _randn(rng, 3, 5, 32)
    wg, wx = _randn(rng, 32, 128, scale=0.2), _randn(rng, 32, 128, scale=0.2)
    bg, bx = _randn(rng, 128, scale=0.1), _randn(rng, 128, scale=0.1)
    # weights stay fp32 and are cast to x.dtype inside, on both sides
    ref = j_fused_swiglu(_j(x, jdt), _j(wg), _j(bg), _j(wx), _j(bx))
    got = t_fused_swiglu(_t(x, tdt), _t(wg), _t(bg), _t(wx), _t(bx))
    assert got.dtype == tdt and tuple(got.shape) == (3, 5, 128)
    # bf16: fp32 accumulation on both sides, one final bf16 cast each
    tol = FP32_TOL if tdt == torch.float32 else _bf16_ulp(ref)
    assert _err(ref, got) <= tol
    assert t_fused_swiglu.launches == 0


def test_swiglu_instance_rule():
    """Which SwiGLU kernel runs on the card: fp32 the SIMT kernels; bf16
    the tensor cores at widths in multiples of 8 (skinny forward up to
    64 rows, mma above and for every backward); other bf16 widths SIMT."""
    for M in (1, 8, 128, 16384):
        assert swiglu_instance(torch.float32, M, 768, 3072) == "simt"
        assert swiglu_instance(torch.float32, M, 768, 3072, backward=True) == "simt"
        assert swiglu_instance(torch.bfloat16, M, 768, 3072, backward=True) == "mma"
    for M in (1, 8, 40, 64):
        assert swiglu_instance(torch.bfloat16, M, 768, 3072) == "skinny"
        assert swiglu_instance(torch.bfloat16, M, 72, 200) == "skinny"
    for M in (65, 100, 128, 1000, 16384):
        assert swiglu_instance(torch.bfloat16, M, 768, 3072) == "mma"
        assert swiglu_instance(torch.bfloat16, M, 64, 256) == "mma"
    for E, F in ((70, 99), (768, 100), (36, 3072)):
        for M in (8, 16384):
            assert swiglu_instance(torch.bfloat16, M, E, F) == "simt"
            assert swiglu_instance(torch.bfloat16, M, E, F, backward=True) == "simt"
    with pytest.raises(TypeError):
        swiglu_instance(torch.float16, 8, 768, 3072)


@pytest.mark.parametrize("dtype,name", [(torch.float32, "fp32"),
                                        (torch.bfloat16, "bf16")], ids=["fp32", "bf16"])
def test_add_norm_bwd_instance_rule(dtype, name):
    """Which add+norm backward kernel runs on the card: one warp a row
    with 8 * ceil(E / 256) elements a lane for widths in multiples of 8
    up to WARP_MAX_E (the recipe's 768: 24), one block a row otherwise.
    The dtype names the instance; the rows never decide."""
    assert WARP_MAX_E == 1024
    assert add_norm_bwd_instance(dtype, 768) == f"{name}-warp24"
    assert add_norm_bwd_instance(dtype, 64) == f"{name}-warp8"
    assert add_norm_bwd_instance(dtype, 256) == f"{name}-warp8"
    assert add_norm_bwd_instance(dtype, 264) == f"{name}-warp16"
    assert add_norm_bwd_instance(dtype, WARP_MAX_E) == f"{name}-warp32"
    for E in (100, 36, 770, WARP_MAX_E + 8, 1536):
        assert add_norm_bwd_instance(dtype, E) == f"{name}-block"
    with pytest.raises(TypeError):
        add_norm_bwd_instance(torch.float16, 768)


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("S", [1, 2, 3])
def test_decode_attention_cpu_path_matches_pallas(S, jdt, tdt):
    rng = _rng(8 + S)
    B, H, M, d, dv = 5, 2, 32, 8, 16
    q = _randn(rng, S, B, H, d)
    k = _randn(rng, S, B, H, M, d)
    v = _randn(rng, B, H, M, dv)
    # in-window rows (pos < M, tiles past pos skipped) and rolled rows
    # (pos >= M: every ring slot holds a live key)
    pos = np.array([0, 7, 31, 32, 75], np.int32)
    coeffs = _randn(rng, S, H, scale=0.5)
    coeffs[0] = 1.0
    ref = j_decode_attention(_j(q, jdt), _j(k, jdt), _j(v, jdt),
                             jnp.asarray(pos), _j(coeffs))
    got = t_decode_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                             torch.from_numpy(pos), _t(coeffs))
    assert got.dtype == tdt and tuple(got.shape) == (B, H, dv)
    if tdt == torch.float32:
        tol = FP32_TOL
    else:
        # the Pallas kernel rounds each stream's probabilities to bf16
        # before its PV product and combines afterwards; the plain
        # version combines the fp32 probabilities and rounds once:
        # 2^-8 of sum|c| * max|V|, plus one bf16 step of the output
        tol = (2.0 ** -8 * float(np.abs(coeffs).sum(0).max())
               * float(np.abs(v).max()) + _bf16_ulp(ref))
    assert _err(ref, got) <= tol
    assert t_decode_attention.launches == 0


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("S", [1, 2, 3])
def test_decode_attention_int8_cpu_path_matches_pallas(S, jdt, tdt):
    """The int8 branch: K/V quantized by each side's quantize_kv (the
    int8 values and fp32 scales must be identical), then the port's
    plain version against the Pallas kernel's fused dequantization."""
    rng = _rng(20 + S)
    B, H, M, d, dv = 5, 2, 32, 8, 16
    q = _randn(rng, S, B, H, d)
    k = _randn(rng, S, B, H, M, d)
    v = _randn(rng, B, H, M, dv)
    k[0, 0, 0, 3] = 0.0  # an all-zero vector takes the floor scale
    pos = np.array([0, 7, 31, 32, 75], np.int32)
    coeffs = _randn(rng, S, H, scale=0.5)
    coeffs[0] = 1.0
    jk, jks = j_quantize_kv(_j(k, jdt))
    jv, jvs = j_quantize_kv(_j(v, jdt))
    tk, tks = t_quantize_kv(_t(k, tdt))
    tv, tvs = t_quantize_kv(_t(v, tdt))
    for a, b in ((jk, tk), (jks, tks), (jv, tv), (jvs, tvs)):
        assert np.array_equal(np.asarray(a), b.numpy())
    ref = j_decode_attention(_j(q, jdt), jk, jv, jnp.asarray(pos), _j(coeffs),
                             k_scale=jks, v_scale=jvs)
    got = t_decode_attention(_t(q, tdt), tk, tv, torch.from_numpy(pos),
                             _t(coeffs), k_scale=tks, v_scale=tvs)
    assert got.dtype == tdt and tuple(got.shape) == (B, H, dv)
    if tdt == torch.float32:
        tol = FP32_TOL
    else:
        # as the float bf16 case, over the dequantized V (|V| <= its
        # per-vector amax, which the scales carry)
        vmax = float(np.abs(np.asarray(tvs)).max()) * 127.0
        tol = (2.0 ** -8 * float(np.abs(coeffs).sum(0).max()) * vmax
               + _bf16_ulp(ref))
    assert _err(ref, got) <= tol
    assert t_decode_attention.launches == 0
