"""Fused SwiGLU FFN, forward and backward, CUDA C++ kernels for Hopper.

Replaces the TPU kernels ``differential_transformer_replication_tpu/ops/
fused_ffn.py:_ffn_fwd_kernel`` (via ``_fwd_call``) and ``_ffn_bwd_kernel``
(via ``_bwd_call``): the block's ``silu(x @ Wg + bg) * (x @ Wx + bx)``
chain, computed tile by tile without writing the two (M, 4E)
pre-activations, and its backward, which recomputes them tile by tile.
The kernels, their bounds on the H100 and their designs are described in
``csrc/fused_swiglu.cu``: the forward is bound by the weight read at
decode and prefill-chunk sizes, the backward by arithmetic at the
training shape (M = 16384 rows). :func:`swiglu_instance` names the
kernel that runs for a dtype and shape (tensor cores for bf16 at widths
in multiples of 8, SIMT otherwise); the wrapper passes it to the C
launcher, which does not decide again.

The backward kernel returns the pre-activation cotangents ``[dg | dt]``
in the storage dtype, fp32 ``dWg = x^T dg`` and ``dWx = x^T dt`` from
those rounded values, and fp32 bias grads from the unrounded ones; the
wrapper finishes ``dx = dg Wg^T + dt Wx^T`` as ONE matmul of the (M, 2F)
``[dg | dt]`` against ``[Wg | Wx]`` (fp32 accumulation, one rounding),
outside the kernel, as the JAX code leaves it to XLA.

Dispatch is by device: a CPU tensor runs :func:`swiglu_reference` /
:func:`swiglu_bwd_reference`, a CUDA tensor always launches the kernel
(or raises), any other device raises. :func:`fused_swiglu` is
differentiable (a ``torch.autograd.Function`` whose backward is
:func:`swiglu_bwd`). ``fused_swiglu.launches`` counts the forward
kernel's calls (one device launch each), ``swiglu_bwd.launches`` the
backward's (three device launches each); ``.instances`` counts them by
instance.
"""

from __future__ import annotations

from collections import Counter

import torch

from differential_transformer_replication_tpu_torch.ops import _kernels

# the instance codes shared with csrc/fused_swiglu.cu
INSTANCES = {"simt": 0, "mma": 1, "skinny": 2}
# forward rows up to which the skinny instance beats the mma tiles on the
# H100 (past them every 16-column block's re-read of x costs more than the
# mma tiles' idle SMs)
SKINNY_MAX_M = 64


def swiglu_instance(dtype: torch.dtype, M: int, E: int, F: int, *,
                    backward: bool = False) -> str:
    """Which kernel runs on the card for M rows of x (M, E) against
    (E, F) weights. ``skinny``: the bf16 forward at M <= SKINNY_MAX_M
    (the decode step's rows), weight-read bound, the weights as the
    tensor cores' m16 operand; ``mma``: bf16 at larger M and every
    bf16 backward, warpgroup-MMA (wgmma) tiles of both products;
    ``simt``: fp32 (bf16 or tf32 products would not hold the plain
    version's 5e-5) and bf16 widths that are not multiples of 8 (the
    kernels stage 16-byte vectors). Ragged M, E and F edges are masked
    inside the tensor-core kernels."""
    if dtype not in _kernels.DTYPE_CODES:
        raise TypeError(f"fused SwiGLU: unsupported dtype {dtype}")
    if dtype != torch.bfloat16 or E % 8 or F % 8:
        return "simt"
    if not backward and M <= SKINNY_MAX_M:
        return "skinny"
    return "mma"


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


def swiglu_bwd_reference(x, w_gate, b_gate, w_xform, b_xform, gh):
    """Plain version of :func:`swiglu_bwd`. ``x`` (M, E), weights (E, F)
    and biases (F,) in the storage dtype, ``gh`` (M, F). Returns
    ``[dg | dt]`` (M, 2F) in the storage dtype, fp32 ``dW`` (2, E, F) =
    [dWg, dWx] from the rounded dg/dt, and fp32 ``db`` (2F,) = [dbg | dbx]
    from the unrounded ones."""
    dt_ = x.dtype
    xf = x.to(torch.float32)
    g = xf @ w_gate.to(torch.float32) + b_gate.to(torch.float32)
    t = xf @ w_xform.to(torch.float32) + b_xform.to(torch.float32)
    sg = 1.0 / (1.0 + torch.exp(-g))
    h = gh.to(torch.float32)
    dg = h * t * (sg * (1.0 + g * (1.0 - sg)))
    dt = h * (g * sg)
    dgt = torch.cat([dg.to(dt_), dt.to(dt_)], dim=1)
    dw = torch.stack([xf.t() @ dgt[:, :g.shape[1]].to(torch.float32),
                      xf.t() @ dgt[:, g.shape[1]:].to(torch.float32)])
    db = torch.cat([dg.sum(0), dt.sum(0)])
    return dgt, dw, db


def _check(what: str, x, ws, gh=None):
    dt = x.dtype
    if dt not in _kernels.DTYPE_CODES:
        raise TypeError(f"{what}: unsupported dtype {dt}")
    E = x.shape[-1]
    F = ws[0].shape[1]
    if ws[0].shape != (E, F) or ws[2].shape != (E, F) \
            or ws[1].shape != (F,) or ws[3].shape != (F,):
        raise ValueError(
            f"{what}: weights must be ({E}, F) with (F,) biases, got "
            f"{[tuple(w.shape) for w in ws]}"
        )
    for t in (x, *ws) + (() if gh is None else (gh,)):
        if t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous {dt} on "
                             f"{x.device}")
    return E, F


def _forward(x, wg, bg, wx, bx) -> torch.Tensor:
    if not _kernels.on_card(x, "fused_swiglu"):
        return swiglu_reference(x, wg, bg, wx, bx)
    out = _launch(x, wg, bg, wx, bx)
    fused_swiglu.launches += 1
    return out


def _launch(x, wg, bg, wx, bx) -> torch.Tensor:
    E, F = _check("fused_swiglu", x, (wg, bg, wx, bx))
    M = x.numel() // E
    inst = swiglu_instance(x.dtype, M, E, F)
    if inst != "simt":
        x, wg, bg, wx, bx = _kernels.aligned16((x, wg, bg, wx, bx))
    out = torch.empty(x.shape[:-1] + (F,), dtype=x.dtype, device=x.device)
    lib = _kernels.load("fused_swiglu")
    rc = lib.fused_swiglu_fwd(
        x.data_ptr(), wg.data_ptr(), bg.data_ptr(), wx.data_ptr(),
        bx.data_ptr(), out.data_ptr(), M, E, F, _kernels.DTYPE_CODES[x.dtype],
        INSTANCES[inst], _kernels.stream_handle(x.device),
    )
    _kernels.check(rc, "fused_swiglu")
    fused_swiglu.instances[inst] += 1
    return out


def swiglu_bwd(x, w_gate, b_gate, w_xform, b_xform, gh):
    """The SwiGLU backward kernel (see :func:`swiglu_bwd_reference` for
    the operands and results)."""
    if not _kernels.on_card(x, "swiglu_bwd"):
        return swiglu_bwd_reference(x, w_gate, b_gate, w_xform, b_xform, gh)
    ws = (w_gate, b_gate, w_xform, b_xform)
    E, F = _check("swiglu_bwd", x, ws, gh)
    M = x.shape[0]
    if gh.shape != (M, F):
        raise ValueError(f"swiglu_bwd: gh must be ({M}, {F})")
    inst = swiglu_instance(x.dtype, M, E, F, backward=True)
    if inst != "simt":
        x, w_gate, b_gate, w_xform, b_xform, gh = _kernels.aligned16(
            (x, w_gate, b_gate, w_xform, b_xform, gh))
    lib = _kernels.load("fused_swiglu")
    n_work = lib.fused_swiglu_bwd_workspace(M, E, F, INSTANCES[inst])
    if n_work < 0:
        raise ValueError("swiglu_bwd: shapes refused by the kernel")
    dev = x.device
    dgt = torch.empty((M, 2 * F), dtype=x.dtype, device=dev)
    dw = torch.empty((2, E, F), dtype=torch.float32, device=dev)
    db = torch.empty((2 * F,), dtype=torch.float32, device=dev)
    work = torch.empty((n_work,), dtype=torch.float32, device=dev)
    rc = lib.fused_swiglu_bwd(
        x.data_ptr(), w_gate.data_ptr(), b_gate.data_ptr(), w_xform.data_ptr(),
        b_xform.data_ptr(), gh.data_ptr(), dgt.data_ptr(), dw.data_ptr(),
        db.data_ptr(), work.data_ptr(), M, E, F, _kernels.DTYPE_CODES[x.dtype],
        INSTANCES[inst], _kernels.stream_handle(dev),
    )
    _kernels.check(rc, "swiglu_bwd")
    swiglu_bwd.launches += 1
    swiglu_bwd.instances[inst] += 1
    return dgt, dw, db


class _SwigluFn(torch.autograd.Function):
    """The fused SwiGLU with its recomputing backward. Inputs are already
    in the storage dtype (the wrapper casts the weights, as the JAX
    wrapper does), and so are the returned weight and bias grads."""

    @staticmethod
    def forward(ctx, x, wg, bg, wx, bx):
        ctx.save_for_backward(x, wg, bg, wx, bx)
        return _forward(x, wg, bg, wx, bx)

    @staticmethod
    def backward(ctx, gh):
        x, wg, bg, wx, bx = ctx.saved_tensors
        E, F = x.shape[-1], wg.shape[1]
        x2 = x.reshape(-1, E)
        dgt, dw, db = swiglu_bwd(x2, wg, bg, wx, bx,
                                 gh.reshape(-1, F).contiguous())
        dx = dgt @ torch.cat([wg, wx], dim=1).t()
        return (dx.reshape(x.shape), dw[0].to(wg.dtype), db[:F].to(bg.dtype),
                dw[1].to(wx.dtype), db[F:].to(bx.dtype))


def fused_swiglu(x: torch.Tensor, w_gate: torch.Tensor, b_gate: torch.Tensor,
                 w_xform: torch.Tensor, b_xform: torch.Tensor) -> torch.Tensor:
    """Fused ``silu(x @ Wg + bg) * (x @ Wx + bx)``. ``x``: (..., E);
    weights (E, F) and biases (F,), cast to ``x.dtype`` here exactly as
    the JAX wrapper casts them (a no-op when they already are).
    Differentiable: whenever an input requires grad the call goes
    through :class:`_SwigluFn` (on every device); with none, the forward
    runs on its own (the serving path)."""
    ws = [t.to(x.dtype) for t in (w_gate, b_gate, w_xform, b_xform)]
    if _kernels.needs_grad(x, *ws):
        return _SwigluFn.apply(x, *ws)
    return _forward(x, *ws)


fused_swiglu.launches = 0
swiglu_bwd.launches = 0
fused_swiglu.instances = Counter()
swiglu_bwd.instances = Counter()
