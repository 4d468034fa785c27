"""Fused SwiGLU FFN forward, a CUDA C++ kernel for Hopper.

Replaces the TPU kernel ``differential_transformer_replication_tpu/ops/
fused_ffn.py:_ffn_fwd_kernel`` (via ``_fwd_call``): the block's
``silu(x @ Wg + bg) * (x @ Wx + bx)`` chain, computed tile by tile
without writing the two (M, 4E) pre-activations. The kernel, its bound
on the H100 and its design are described in ``csrc/fused_swiglu.cu``:
the weight read bounds it at decode and prefill-chunk sizes, and each
staged x tile feeds both products into two fp32 accumulators with the
bias + SiLU + product epilogue in registers.

Dispatch is by device: a CPU tensor runs :func:`swiglu_reference`, a
CUDA tensor always launches the kernel (or raises), any other device
raises. ``fused_swiglu.launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from differential_transformer_replication_tpu_torch.ops import _kernels


def swiglu_reference(x, w_gate, b_gate, w_xform, b_xform) -> torch.Tensor:
    """Plain version: the products accumulate in fp32 (the TPU kernel's
    ``preferred_element_type=float32``), the biases are cast to x.dtype
    and then widened, the SiLU product runs in fp32, and the result is
    cast to x.dtype once."""
    dt = x.dtype
    xf = x.to(torch.float32)
    g = xf @ w_gate.to(dt).to(torch.float32) + b_gate.to(dt).to(torch.float32)
    t = xf @ w_xform.to(dt).to(torch.float32) + b_xform.to(dt).to(torch.float32)
    return (g * torch.sigmoid(g) * t).to(dt)


def fused_swiglu(x: torch.Tensor, w_gate: torch.Tensor, b_gate: torch.Tensor,
                 w_xform: torch.Tensor, b_xform: torch.Tensor) -> torch.Tensor:
    """Fused ``silu(x @ Wg + bg) * (x @ Wx + bx)``. ``x``: (..., E);
    weights (E, F) and biases (F,), cast to ``x.dtype`` here exactly as
    the JAX wrapper casts them (a no-op when they already are)."""
    if x.device.type == "cpu":
        return swiglu_reference(x, w_gate, b_gate, w_xform, b_xform)
    _kernels.require_cuda(x, "fused_swiglu")
    dt = x.dtype
    if dt not in _kernels.DTYPE_CODES:
        raise TypeError(f"fused_swiglu: unsupported dtype {dt}")
    E = x.shape[-1]
    F = w_gate.shape[1]
    if w_gate.shape != (E, F) or w_xform.shape != (E, F) \
            or b_gate.shape != (F,) or b_xform.shape != (F,):
        raise ValueError(
            f"fused_swiglu: weights must be ({E}, F) with (F,) biases, got "
            f"{tuple(w_gate.shape)}, {tuple(w_xform.shape)}, "
            f"{tuple(b_gate.shape)}, {tuple(b_xform.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("fused_swiglu: x must be contiguous")
    ops = [t.to(dt).contiguous() for t in (w_gate, b_gate, w_xform, b_xform)]
    if any(t.device != x.device for t in ops):
        raise ValueError(f"fused_swiglu: weights must live on {x.device}")
    M = x.numel() // E
    out = torch.empty(x.shape[:-1] + (F,), dtype=dt, device=x.device)
    lib = _kernels.load("fused_swiglu")
    rc = lib.fused_swiglu_fwd(
        x.data_ptr(), ops[0].data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(),
        ops[3].data_ptr(), out.data_ptr(), M, E, F, _kernels.DTYPE_CODES[dt],
        _kernels.stream_handle(x.device),
    )
    _kernels.check(rc, "fused_swiglu")
    fused_swiglu.launches += 1
    return out


fused_swiglu.launches = 0
