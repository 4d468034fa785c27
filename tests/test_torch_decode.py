"""The port's cached forward against the JAX package's, on the CPU.

Both sides start from the same JAX-initialized params (lambda vectors
perturbed away from their zero init so the lambda math is exercised),
handed to the port through ``params.py``. The JAX side runs with
``ffn_impl="pallas"`` and ``decode_attention_impl="pallas"`` (its Pallas
kernels interpreted off-TPU); the port's wrappers run their plain
versions because the tensors lie on the CPU. Each case prefills slot
rows with chunks from the power-of-two ladder (``forward_chunk``), then
advances the pool with ``forward_decode_pool`` steps with every row at
its own position. fp32 logits agree to <= 1e-4 and cache contents to
<= 1e-5. With the int8 cache (``kv_cache_dtype="int8"``) both sides
quantize K/V they computed to fp32 rounding, so an int8 value may sit
one step apart where x / scale lands on a rounding boundary: dequantized
caches agree to one quantization step (the largest scale) plus 1e-5,
and logits to 1e-3 (int8 steps of ~1% of a vector's range moving the
scores).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu.config import ModelConfig as JModelConfig
from differential_transformer_replication_tpu.models import init_model as j_init_model
from differential_transformer_replication_tpu.models import decode as jdec
from differential_transformer_replication_tpu_torch.config import ModelConfig
from differential_transformer_replication_tpu_torch.models import decode as tdec
from differential_transformer_replication_tpu_torch.params import (
    params_from_jax,
    params_to_numpy,
)

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
LOGIT_TOL_INT8 = 1e-3
SMALL = dict(vocab_size=61, n_embd=32, n_head=2, n_layer=2, block_size=32,
             dropout=0.0, n_terms=3, compute_dtype="float32")


# jitted JAX entry points: cfg / rope_len / window are static, positions
# traced, so each chunk length compiles once per file run
_J_CHUNK = jax.jit(jdec.forward_chunk, static_argnums=(4, 5, 6))
_J_POOL = jax.jit(jdec.forward_decode_pool, static_argnums=(4, 5))


def _setup(kind: str, seed: int = 0, kv: str = "auto"):
    jcfg = JModelConfig(model=kind, ffn_impl="pallas",
                        decode_attention_impl="pallas", kv_cache_dtype=kv,
                        **SMALL)
    tcfg = ModelConfig(model=kind, kv_cache_dtype=kv, **SMALL)
    tree = jax.tree_util.tree_map(np.asarray, j_init_model(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 100)
    for blk in tree["blocks"]:
        attn = blk["attn"]
        for key in ("lambda_q", "lambda_k"):
            if key in attn:
                attn[key] = (rng.standard_normal(attn[key].shape) * 0.1).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, params_from_jax(tree, tcfg, device="cpu")


def _ladder(n: int, cap: int):
    """(start, size) prefill chunks: descending powers of two <= cap."""
    out, start = [], 0
    while start < n:
        size = 1 << (min(n - start, cap).bit_length() - 1)
        out.append((start, size))
        start += size
    return out


def _max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - b.to(torch.float32).numpy())))


def _row_of(cache, i):
    """One pool row of a cache (JAX or port) as the batch-1 cache
    forward_chunk takes (views on the port's side)."""
    return [{key: (t[:, i:i + 1] if tdec.KV_CACHE_BATCH_AXIS[key] else t[i:i + 1])
             for key, t in c.items()} for c in cache]


def _set_row(jcache, i, row):
    return [{key: (t.at[:, i].set(row_c[key][:, 0])
                   if tdec.KV_CACHE_BATCH_AXIS[key] else t.at[i].set(row_c[key][0]))
             for key, t in c.items()} for c, row_c in zip(jcache, row)]


def assert_caches_match(jcache, tcache, tol=CACHE_TOL):
    """Float caches leaf by leaf; int8 caches dequantized, within one
    quantization step (see the module docstring)."""
    for jc, tc in zip(jcache, tcache):
        assert set(jc) == set(tc)
        if "k_scale" not in tc:
            for key in jc:
                assert _max_err(jc[key], tc[key]) <= tol, key
            continue
        for key in ("k", "v"):
            jd = np.asarray(jc[key], np.float32) * np.asarray(jc[key + "_scale"])[..., None]
            td = tdec.dequantize_kv(tc[key], tc[key + "_scale"], torch.float32)
            step = float(tc[key + "_scale"].max())
            assert _max_err(jd, td) <= step + tol, key


def _run_case(kind, prompt_lens, n_steps, rope_len=0, seed=0, kv="auto"):
    jcfg, tcfg, jparams, tparams = _setup(kind, seed, kv)
    logit_tol = LOGIT_TOL_INT8 if kv == "int8" else LOGIT_TOL
    B = len(prompt_lens)
    rng = np.random.default_rng(seed + 7)
    jcache = jdec.init_cache(jcfg, B)
    tcache = tdec.init_cache(tcfg, B)
    last = []
    for i, n in enumerate(prompt_lens):
        prompt = rng.integers(0, SMALL["vocab_size"], size=n)
        for start, size in _ladder(n, 8):
            toks = prompt[start:start + size][None]
            jl, jrow = _J_CHUNK(jparams, jnp.asarray(toks), start,
                                _row_of(jcache, i), jcfg, rope_len, 0)
            jcache = _set_row(jcache, i, jrow)
            tl, _ = tdec.forward_chunk(tparams, torch.from_numpy(toks), start,
                                       _row_of(tcache, i), tcfg, rope_len=rope_len)
            assert _max_err(jl, tl) <= logit_tol, (kind, i, start, size)
        last.append(int(prompt[-1]))
    pos = np.array(prompt_lens, np.int32) - 1
    tokens = np.array(last, np.int64)
    for step in range(n_steps):
        pos = pos + 1
        tokens = rng.integers(0, SMALL["vocab_size"], size=B)
        jl, jcache = _J_POOL(
            jparams, jnp.asarray(tokens, jnp.int32), jnp.asarray(pos),
            jcache, jcfg, rope_len)
        tl, _ = tdec.forward_decode_pool(
            tparams, torch.from_numpy(tokens), torch.from_numpy(pos), tcache,
            tcfg, rope_len=rope_len)
        assert tuple(tl.shape) == (B, SMALL["vocab_size"])
        assert _max_err(jl, tl) <= logit_tol, (kind, step)
    assert_caches_match(jcache, tcache)
    return jparams, tparams


@pytest.mark.parametrize("kind", ["control", "diff", "ndiff"])
def test_prefill_chunks_then_pool_decode_match_jax(kind):
    """Three rows at different prompt lengths (ladder chunks 8/4/2/1),
    then pool decode steps with per-row positions."""
    _run_case(kind, prompt_lens=[13, 6, 20], n_steps=4)


@pytest.mark.parametrize("kind", ["control", "diff", "ndiff"])
def test_int8_cache_prefill_then_pool_decode_match_jax(kind):
    """The int8 KV cache: quantize-on-write in prefill chunks and pool
    steps, dequantized reads in prefill attention, the fused
    dequantization of the decode-attention kernel (plain version here,
    Pallas interpreted on the JAX side)."""
    _run_case(kind, prompt_lens=[13, 6, 20], n_steps=4, kv="int8")


def test_control_decode_rolls_past_block_size():
    """The RoPE families roll the ring past block_size: decode steps
    from position 28 to 37 of a 32-slot ring."""
    _run_case("control", prompt_lens=[28, 9], n_steps=10, rope_len=64, seed=1)


def test_params_round_trip_through_numpy():
    _, tcfg, _, tparams = _setup("ndiff")
    back = params_from_jax(params_to_numpy(tparams), tcfg)
    flat = jax.tree_util.tree_leaves(params_to_numpy(back))
    orig = jax.tree_util.tree_leaves(params_to_numpy(tparams))
    assert len(flat) == len(orig) and all(np.array_equal(a, b)
                                          for a, b in zip(flat, orig))
    with pytest.raises(ValueError):
        params_from_jax(params_to_numpy(tparams), tcfg.replace(n_layer=3))


def test_forward_chunk_guards_are_loud():
    _, tcfg, _, tparams = _setup("diff")
    cache = tdec.init_cache(tcfg, 1)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="cannot roll"):
        tdec.forward_chunk(tparams, toks, 30, cache, tcfg)
    ccfg = tcfg.replace(model="control")
    _, _, _, cparams = _setup("control")
    ccache = tdec.init_cache(ccfg, 1)
    with pytest.raises(ValueError, match="RoPE table"):
        tdec.forward_chunk(cparams, toks, 30, ccache, ccfg)
    with pytest.raises(ValueError, match="rolled position"):
        tdec.forward_chunk(cparams, toks, 40, ccache, ccfg, rope_len=64)
    with pytest.raises(ValueError, match="wraps the ring"):
        tdec.forward_chunk(cparams, toks, 30, ccache, ccfg, rope_len=64)
