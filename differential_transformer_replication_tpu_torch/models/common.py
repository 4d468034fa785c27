"""Shared model plumbing of the port: parameter init, linear, and the
block-boundary norm/FFN application (forward only, eval mode).

The param tree has the JAX package's layout exactly: Linear ``w`` is
``(in, out)`` so application is ``x @ W + b``; LayerNorm params are
``{"w", "b"}`` in fp32. Init follows the reference: every Linear weight
and embedding ~ N(0, 0.02), Linear biases zero, LayerNorm ones/zeros,
lambda vectors zero. Draws come from an explicit ``torch.Generator``
(they cannot reproduce ``jax.random``'s; parity tests hand both sides
the JAX-initialized params through ``params.py``).

The block-boundary norms and the SwiGLU chain always go through the
kernel wrappers (ops/fused_norm_residual.py, ops/fused_ffn.py), which
dispatch by device: GPU kernel for a CUDA tensor, plain version for a
CPU tensor. There is no config switch between the two.
"""

from __future__ import annotations

import torch

from differential_transformer_replication_tpu_torch.ops.fused_ffn import fused_swiglu
from differential_transformer_replication_tpu_torch.ops.fused_norm_residual import (
    fused_add_norm,
    fused_group_norm,
    fused_norm,
)

INIT_STD = 0.02

# the param-tree keys whose leaves stay fp32 at inference: LayerNorm
# params feed the fused norm's fp32 affine, lambda vectors the fp32
# combine coefficients
_FP32_SUBTREES = ("ln1", "ln2", "ln_f", "gn", "lambda_q", "lambda_k")


def normal_init(gen: torch.Generator, shape, std: float = INIT_STD) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * std


def linear_params(gen: torch.Generator, in_dim: int, out_dim: int,
                  bias: bool = True) -> dict:
    p = {"w": normal_init(gen, (in_dim, out_dim))}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=torch.float32, device=gen.device)
    return p


def layer_norm_params(dim: int, device=None) -> dict:
    return {"w": torch.ones((dim,), dtype=torch.float32, device=device),
            "b": torch.zeros((dim,), dtype=torch.float32, device=device)}


def ffn_params(gen: torch.Generator, n_embd: int) -> dict:
    """SwiGLU(n_embd -> 4*n_embd) then Linear(4*n_embd -> n_embd), all
    with biases."""
    return {
        "gate": linear_params(gen, n_embd, 4 * n_embd),
        "xform": linear_params(gen, n_embd, 4 * n_embd),
        "out": linear_params(gen, 4 * n_embd, n_embd),
    }


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def apply_pre_norm(x: torch.Tensor, p: dict) -> torch.Tensor:
    """A LayerNorm with no residual input: the block's ln1 and ln_f."""
    return fused_norm(x.contiguous(), p["w"], p["b"])


def apply_group_norm(x: torch.Tensor, p: dict) -> torch.Tensor:
    """The full-width GroupLayerNorm over the head concat (diff/ndiff)."""
    return fused_group_norm(x.contiguous(), p["w"], p["b"])


def apply_block_ffn(x: torch.Tensor, attn_out: torch.Tensor,
                    blk: dict) -> torch.Tensor:
    """The block's FFN half: attention residual add + ln2 (one fused
    pass producing the carried residual and the normalized FFN input),
    the fused SwiGLU chain, the down projection and the FFN residual."""
    p = blk["ffn"]
    x, normed = fused_add_norm(x.contiguous(), attn_out.contiguous(),
                               blk["ln2"]["w"], blk["ln2"]["b"])
    h = fused_swiglu(normed, p["gate"]["w"], p["gate"]["b"],
                     p["xform"]["w"], p["xform"]["b"])
    return x + linear(h, p["out"])


def inference_params(params: dict, compute_dtype: torch.dtype,
                     device) -> dict:
    """The param tree on ``device`` with every matmul weight, bias and
    embedding cast to ``compute_dtype`` ONCE, and the LayerNorm and
    lambda leaves kept fp32. Every consumer casts those leaves to the
    activation dtype anyway (``linear``, the SwiGLU wrapper, the
    embedding gathers), so casting ahead is bit-identical and spares the
    per-step casts."""

    def walk(node, keep_fp32):
        if isinstance(node, dict):
            return {k: walk(v, keep_fp32 or k in _FP32_SUBTREES)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, keep_fp32) for v in node]
        dt = torch.float32 if keep_fp32 else compute_dtype
        return node.to(device=device, dtype=dt).contiguous()

    return walk(params, False)
