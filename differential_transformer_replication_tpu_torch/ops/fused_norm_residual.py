"""Fused residual-add + LayerNorm (forward), a Triton kernel for Hopper.

Replaces the TPU kernel ``differential_transformer_replication_tpu/ops/
fused_norm_residual.py:_addnorm_fwd_kernel`` (via ``_fwd_call``). It runs
at every ln1, every GroupLayerNorm, ln_f, and as the add+ln2 in front of
each block's FFN, in prefill and in decode.

What bounds it on the H100: memory traffic and, at decode sizes, launch
latency. One (M, E) row block is read once, the residual sum is written
once (the carry), and the normalized row is written once; the work is
one fp32 row reduction plus an elementwise pass, no tensor cores. The
kernel is one Triton program per row with ``BLOCK = next_pow2(E)``
lanes (1024 for E = 768), masked, so a row is loaded once and both
outputs come from registers. At (8, 768) the whole call moves ~50 KB
and is bound by the launch itself.

Numerics are exactly :func:`ops.norms.layer_norm`'s: the add happens in
the STORED dtype before the fp32 statistics (like the XLA ``x + delta``),
the statistics use biased variance over the E live lanes only, ``eps``
sits inside the square root and the normalization is a division (not
rsqrt); the affine runs in fp32 against fp32 scale/bias and only the
result is cast back.

Dispatch is by device: a CPU tensor runs the plain version
(:func:`add_norm_reference` / :func:`norm_reference`), a CUDA tensor
always launches the kernel (or raises), and any other device raises.
``fused_add_norm.launches`` / ``fused_norm.launches`` count the kernel
launches.
"""

from __future__ import annotations

import functools

import torch

from differential_transformer_replication_tpu_torch.ops import _kernels
from differential_transformer_replication_tpu_torch.ops.norms import layer_norm

# triton.language, bound by _compiled() at the first launch: the module
# must import where triton is absent (the CPU tests import it)
tl = None


def _addnorm_fwd_kernel(x_ptr, d_ptr, w_ptr, b_ptr, outx_ptr, outn_ptr, E,
                        eps, HAS_DELTA: tl.constexpr, BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    live = cols < E
    x = tl.load(x_ptr + row * E + cols, mask=live, other=0.0)
    if HAS_DELTA:
        x = x + tl.load(d_ptr + row * E + cols, mask=live, other=0.0)
        tl.store(outx_ptr + row * E + cols, x, mask=live)
    xf = x.to(tl.float32)
    mean = tl.sum(xf, axis=0) / E
    c = tl.where(live, xf - mean, 0.0)
    var = tl.sum(c * c, axis=0) / E
    xhat = c / tl.sqrt(var + eps)
    w = tl.load(w_ptr + cols, mask=live, other=0.0)
    b = tl.load(b_ptr + cols, mask=live, other=0.0)
    y = xhat * w + b
    tl.store(outn_ptr + row * E + cols, y.to(outn_ptr.dtype.element_ty),
             mask=live)


@functools.lru_cache(maxsize=None)
def _compiled():
    global tl
    import triton
    import triton.language as tl

    return triton.jit(_addnorm_fwd_kernel)


def add_norm_reference(x, delta, weight, bias, eps: float = 1e-5):
    """Plain version of :func:`fused_add_norm`."""
    s = x + delta
    return s, layer_norm(s, weight, bias, eps)


def norm_reference(x, weight, bias, eps: float = 1e-5):
    """Plain version of :func:`fused_norm`."""
    return layer_norm(x, weight, bias, eps)


def _launch(x: torch.Tensor, delta, weight, bias, eps: float):
    what = "fused_add_norm" if delta is not None else "fused_norm"
    _kernels.require_cuda(x, what)
    E = x.shape[-1]
    if x.dtype not in _kernels.DTYPE_CODES:
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    if delta is not None and (delta.shape != x.shape or delta.dtype != x.dtype
                              or delta.device != x.device
                              or not delta.is_contiguous()):
        raise ValueError(f"{what}: delta must match x in shape, dtype, "
                         "device and be contiguous")
    w = weight.to(torch.float32).contiguous()
    b = bias.to(torch.float32).contiguous()
    if w.shape != (E,) or b.shape != (E,) or w.device != x.device \
            or b.device != x.device:
        raise ValueError(f"{what}: weight/bias must be ({E},) on {x.device}")
    M = x.numel() // E
    normed = torch.empty_like(x)
    carry = torch.empty_like(x) if delta is not None else normed
    kernel = _compiled()
    block = 1 << (E - 1).bit_length()
    kernel[(M,)](x, delta if delta is not None else x, w, b, carry, normed,
                 E, float(eps), HAS_DELTA=delta is not None, BLOCK=block,
                 num_warps=4 if block <= 2048 else 8)
    return carry, normed


def fused_add_norm(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float = 1e-5):
    """``(x + delta, layer_norm(x + delta, weight, bias))`` in one pass.
    ``x``/``delta``: (..., E) in the compute dtype; ``weight``/``bias``:
    (E,) float32."""
    if x.device.type == "cpu":
        return add_norm_reference(x, delta, weight, bias, eps)
    out = _launch(x, delta, weight, bias, eps)
    fused_add_norm.launches += 1
    return out


def fused_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Single-pass :func:`ops.norms.layer_norm` (no residual input)."""
    if x.device.type == "cpu":
        return norm_reference(x, weight, bias, eps)
    out = _launch(x, None, weight, bias, eps)[1]
    fused_norm.launches += 1
    return out


fused_add_norm.launches = 0
fused_norm.launches = 0

# The reference's GroupLayerNorm IS a full-width LayerNorm: same kernels.
fused_add_group_norm = fused_add_norm
fused_group_norm = fused_norm
