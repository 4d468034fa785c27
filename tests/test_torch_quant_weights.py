"""int8 weights on load: the port's ``quantize_params_int8`` and the
checkpoint loaders' ``quantize="int8"`` against the JAX package's, on the
CPU.

Per-output-channel int8 quantize-then-dequantize of every matmul weight
(``wq``/``wk``/``wv`` on their embedding axis, every 2-D Linear ``w`` on
axis 0) must equal the JAX function's BIT FOR BIT on fp32 and bf16 trees
(the same fp32 amax, scale, round-half-to-even and cast back);
embeddings, norms, lambdas and biases stay untouched. A JAX-written
checkpoint loaded with ``quantize="int8"`` equals the JAX load, leaf by
leaf, bit for bit. Greedy decoding of the quantized model agrees with
the unquantized one on >= 0.9 of its tokens, the JAX package's gate.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu.config import ModelConfig as JModelConfig
from differential_transformer_replication_tpu.config import TrainConfig as JTrainConfig
from differential_transformer_replication_tpu.models import init_model as j_init_model
from differential_transformer_replication_tpu.ops.decode_attention import (
    quantize_params_int8 as j_quantize_params_int8,
)
from differential_transformer_replication_tpu.train import checkpoint as jckpt
from differential_transformer_replication_tpu.train.step import (
    create_train_state as j_create_train_state,
)
from differential_transformer_replication_tpu_torch.config import ModelConfig
from differential_transformer_replication_tpu_torch.models import generate_cached
from differential_transformer_replication_tpu_torch.ops.decode_attention import (
    quantize_params_int8,
    quantize_weight_int8,
)
from differential_transformer_replication_tpu_torch.params import (
    params_from_jax,
    params_to_numpy,
)
from differential_transformer_replication_tpu_torch.train import checkpoint as ckpt

TINY = dict(vocab_size=61, n_embd=64, n_head=2, n_layer=2, block_size=32,
            dropout=0.0, n_terms=3, compute_dtype="float32")
KINDS = ["control", "diff", "ndiff"]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_trees_equal(jtree, ttree):
    jl, tl = dict(_leaves(jtree)), dict(_leaves(ttree))
    assert jl.keys() == tl.keys()
    for path in jl:
        np.testing.assert_array_equal(_np32(jl[path]), _np32(tl[path]),
                                      err_msg=str(path))


def _trees(kind):
    jcfg = JModelConfig(model=kind, **TINY)
    jparams = j_init_model(jax.random.PRNGKey(0), jcfg)
    cfg = ModelConfig(model=kind, **TINY)
    return jparams, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg), cfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_quantize_params_int8_equals_jax_bit_for_bit(kind, dtype):
    """Tolerance: none — every leaf equal bit for bit (bf16 leaves
    compared through their exact fp32 values)."""
    jparams, tparams, _ = _trees(kind)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jtree = jax.tree_util.tree_map(lambda a: a.astype(jdt), jparams)
    ttree = jax.tree_util.tree_map(lambda a: a.to(tdt), tparams)
    jq, tq = j_quantize_params_int8(jtree), quantize_params_int8(ttree)
    _assert_trees_equal(jq, tq)
    # the input tree is not written, and the untouched leaves are the
    # very same values
    _assert_trees_equal(jtree, ttree)
    for path, leaf in _leaves(tq):
        name = path[-1] if isinstance(path[-1], str) else path[-2]
        assert leaf.dtype == tdt
        quantized = name in ("wq", "wk", "wv") or (name == "w" and leaf.dim() == 2)
        orig = dict(_leaves(ttree))[path]
        if not quantized:
            assert torch.equal(leaf, orig), path


def test_each_channel_lies_within_half_a_step():
    """The dequantized weight differs from the original, by at most half
    a quantization step in every output channel (scale / 2, up to the
    fp32 rounding of w / scale and q * scale: 1e-4 of a half step); the
    per-channel scale is amax / 127 over the contraction axis."""
    w = torch.randn(96, 40, generator=torch.Generator().manual_seed(3))
    w[:, 7] *= 50.0  # one loud channel keeps its own range
    q = quantize_weight_int8(w, axis=0)
    scale = w.abs().amax(dim=0, keepdim=True) / 127.0
    err = (q - w).abs()
    assert not torch.equal(q, w)
    assert bool((err <= scale / 2 * (1 + 1e-4)).all())
    # a quiet channel is not flattened by the loud one
    assert float(err[:, 0].max()) < float(scale[0, 7]) / 10


def _jax_checkpoint(tmp_path: Path, kind: str) -> str:
    jcfg = JTrainConfig(model=JModelConfig(model=kind, **TINY), vocab_size=61)
    state = j_create_train_state(jax.random.PRNGKey(0), jcfg)
    path = str(tmp_path / f"{kind}.ckpt")
    jckpt.save_checkpoint(path, state, 1.0, jcfg)
    return path


@pytest.mark.parametrize("kind", ["diff", "control"])
def test_int8_load_of_a_jax_checkpoint_equals_jax_load(kind, tmp_path):
    """``load_params_for_inference(quantize="int8")`` of a JAX-written
    checkpoint equals JAX's load with the same option, bit for bit; the
    unquantized loads differ from it. ``from_pretrained`` quantizes the
    same way."""
    path = _jax_checkpoint(tmp_path, kind)
    jp, _, _ = jckpt.load_params_for_inference(path, quantize="int8")
    tp, cfg, _ = ckpt.load_params_for_inference(path, quantize="int8")
    _assert_trees_equal(jp, tp)
    plain, _, _ = ckpt.load_params_for_inference(path)
    assert not torch.equal(plain["lm_head"]["w"], tp["lm_head"]["w"])
    assert torch.equal(plain["tok_emb"], tp["tok_emb"])
    pre = str(tmp_path / "pre")
    ckpt.save_pretrained(pre, plain, cfg)
    fq, _ = ckpt.from_pretrained(pre, quantize="int8")
    _assert_trees_equal(params_to_numpy(tp), params_to_numpy(fq))
    with pytest.raises(ValueError, match="int4"):
        ckpt.load_params_for_inference(path, quantize="int4")


def test_int8_greedy_agreement_with_the_unquantized_model():
    """The JAX package's accuracy gate, on its own set-up (control, width
    128, JAX-initialized params, its 9-token prompt, 32 greedy tokens):
    the quantized model agrees with the unquantized one on >= 0.9 of its
    tokens."""
    jcfg = JModelConfig(model="control", **{**TINY, "n_embd": 128})
    jparams = j_init_model(jax.random.PRNGKey(0), jcfg)
    cfg = ModelConfig(model="control", **{**TINY, "n_embd": 128})
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    prompt = np.random.default_rng(1).integers(0, 61, size=9).tolist()
    idx = torch.tensor([prompt])
    a = generate_cached(params, idx, cfg, 32, 0, temperature=0.0)[0, 9:]
    b = generate_cached(quantize_params_int8(params), idx, cfg, 32, 0,
                        temperature=0.0)[0, 9:]
    agree = float((a == b).float().mean())
    assert agree >= 0.9, f"int8 weights drifted too far: {agree}"
