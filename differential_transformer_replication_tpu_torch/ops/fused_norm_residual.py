"""Fused residual-add + LayerNorm, forward and backward, kernels for
Hopper: the forward in Triton, the backward in CUDA C++.

Replaces the TPU kernels ``differential_transformer_replication_tpu/ops/
fused_norm_residual.py:_addnorm_fwd_kernel`` (via ``_fwd_call``) and
``_addnorm_bwd_kernel`` (via ``_bwd_call``). The forward runs at every
ln1, every GroupLayerNorm, ln_f, and as the add+ln2 in front of each
block's FFN, in prefill, decode and training; the backward at each of
those in training.

What bounds both on the H100: memory traffic and, at decode sizes,
launch latency. The forward reads one (M, E) row block once, writes the
residual sum once (the carry) and the normalized row once: one fp32 row
reduction plus an elementwise pass, no tensor cores. It is one Triton
program per row with ``BLOCK = next_pow2(E)`` lanes (1024 for E = 768),
masked, so a row is loaded once and both outputs come from registers.
At (8, 768) the whole call moves ~50 KB and is bound by the launch.
The backward (``csrc/fused_norm_residual.cu``) reads the post-add x, gn
(and the carry cotangent gx) once and writes dx once: one warp per row
with 16-byte loads and warp-shuffle statistics on a persistent grid, the
lanes' dw/db partials in registers, then a second launch that adds the
blocks' partial rows in a fixed order. No float atomics: the parameter
grads do not depend on the order the blocks ran in, and two calls agree
bit for bit. :func:`add_norm_bwd_instance` names the kernel that runs
for a dtype and width.

Numerics are exactly :func:`ops.norms.layer_norm`'s: the add happens in
the STORED dtype before the fp32 statistics (like the XLA ``x + delta``),
the statistics use biased variance over the E live lanes only, ``eps``
sits inside the square root and the normalization is a division (not
rsqrt); the affine runs in fp32 against fp32 scale/bias and only the
result is cast back. The backward recomputes the statistics from the
post-add x (the forward's carry, the residual the JAX VJP saves) and
computes, in fp32, ``dx = (dxh - mean(dxh) - xhat * mean(dxh * xhat)) /
denom (+ gx)`` with ``dxh = gn * w``, cast to the storage dtype once;
``x`` and ``delta`` get the same ``dx``.

Dispatch is by device: a CPU tensor runs the plain versions
(:func:`add_norm_reference` / :func:`norm_reference` /
:func:`add_norm_bwd_reference`), a CUDA tensor always launches the
kernel (or raises), and any other device raises. ``fused_add_norm``,
``fused_norm`` and the group aliases are differentiable
(``torch.autograd.Function``s whose backward is :func:`add_norm_bwd`).
``fused_add_norm.launches`` / ``fused_norm.launches`` count the forward
kernel's launches; ``add_norm_bwd.launches`` counts the backward's calls
(two device launches each), ``add_norm_bwd.carry_launches`` those with
the carry cotangent, and ``add_norm_bwd.instances`` the calls by
instance.
"""

from __future__ import annotations

import functools
from collections import Counter

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


# the instance codes shared with csrc/fused_norm_residual.cu
INSTANCES = {"block": 0, "warp": 1}
# a warp instance's lane holds chunks of CHUNK columns (one 16-byte bf16
# load), at most WARP_MAX_E / 256 of them
CHUNK = 8
WARP_MAX_E = 1024


def add_norm_bwd_instance(dtype: torch.dtype, E: int) -> str:
    """Which backward kernel runs on the card for rows of width E:
    ``<dtype>-warp<n>`` (one warp per row, n = 8 * ceil(E / 256) elements
    a lane; E a multiple of CHUNK up to WARP_MAX_E) or ``<dtype>-block``
    (one block per row, scalar loads: other widths); dtype ``bf16`` or
    ``fp32``."""
    if dtype not in _kernels.DTYPE_CODES:
        raise TypeError(f"add_norm_bwd: unsupported dtype {dtype}")
    dt = "bf16" if dtype == torch.bfloat16 else "fp32"
    if E % CHUNK or E > WARP_MAX_E:
        return f"{dt}-block"
    return f"{dt}-warp{CHUNK * -(-E // (32 * CHUNK))}"


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


def add_norm_bwd_reference(x, weight, gn, gx=None, eps: float = 1e-5):
    """Plain version of :func:`add_norm_bwd`: ``x`` is the post-add
    activation (..., E), ``gn`` the normalized output's cotangent, ``gx``
    the carry's (or None). Returns (dx in x's dtype, fp32 dw, fp32 db)."""
    E = x.shape[-1]
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    c = xf - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    denom = torch.sqrt(var + eps)
    xhat = c / denom
    gnf = gn.to(torch.float32)
    dxh = gnf * weight.to(torch.float32)
    m1 = dxh.mean(dim=-1, keepdim=True)
    m2 = (dxh * xhat).mean(dim=-1, keepdim=True)
    dx = (dxh - m1 - xhat * m2) / denom
    if gx is not None:
        dx = dx + gx.to(torch.float32)
    dw = (gnf * xhat).reshape(-1, E).sum(0)
    db = gnf.reshape(-1, E).sum(0)
    return dx.to(x.dtype), dw, db


def _check_rows(what: str, x: torch.Tensor, *others) -> None:
    if x.dtype not in _kernels.DTYPE_CODES:
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    for t in others:
        if t is not None and (t.shape != x.shape or t.dtype != x.dtype
                              or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"{what}: every row input must match x in "
                             "shape, dtype, device and be contiguous")


def _check_params(what: str, x: torch.Tensor, *params) -> None:
    E = x.shape[-1]
    for p in params:
        if p.shape != (E,) or p.dtype != torch.float32 or p.device != x.device \
                or not p.is_contiguous():
            raise ValueError(f"{what}: weight/bias must be contiguous fp32 "
                             f"({E},) on {x.device}")


def _launch(x: torch.Tensor, delta, w, b, eps: float):
    what = "fused_add_norm" if delta is not None else "fused_norm"
    _check_rows(what, x, delta)
    _check_params(what, x, w, b)
    E = x.shape[-1]
    M = x.numel() // E
    normed = torch.empty_like(x)
    carry = torch.empty_like(x) if delta is not None else normed
    kernel = _compiled()
    block = 1 << (E - 1).bit_length()
    kernel[(M,)](x, delta if delta is not None else x, w, b, carry, normed,
                 E, float(eps), HAS_DELTA=delta is not None, BLOCK=block,
                 num_warps=4 if block <= 2048 else 8)
    return carry, normed


def _forward(x, delta, w, b, eps):
    """(carry, normed) through the kernel or the plain version."""
    what = "fused_add_norm" if delta is not None else "fused_norm"
    if not _kernels.on_card(x, what):
        if delta is None:
            return x, norm_reference(x, w, b, eps)
        return add_norm_reference(x, delta, w, b, eps)
    out = _launch(x, delta, w, b, eps)
    if delta is None:
        fused_norm.launches += 1
    else:
        fused_add_norm.launches += 1
    return out


def add_norm_bwd(x: torch.Tensor, weight: torch.Tensor, gn: torch.Tensor,
                 gx=None, eps: float = 1e-5):
    """LayerNorm backward from the post-add ``x`` (..., E): (dx, dw, db),
    dx in x's dtype with ``gx`` added when given, dw/db fp32 (E,)."""
    if not _kernels.on_card(x, "add_norm_bwd"):
        return add_norm_bwd_reference(x, weight, gn, gx, eps)
    _check_rows("add_norm_bwd", x, gn, gx)
    _check_params("add_norm_bwd", x, weight)
    E = x.shape[-1]
    M = x.numel() // E
    inst = add_norm_bwd_instance(x.dtype, E)
    kind = "block" if inst.endswith("block") else "warp"
    if kind == "warp":
        x, gn, gx = _kernels.aligned16((x, gn, gx))
    lib = _kernels.load("fused_norm_residual")
    code = _kernels.DTYPE_CODES[x.dtype]
    n_work = lib.fused_norm_residual_bwd_workspace(M, E, code, INSTANCES[kind])
    if n_work < 0:
        raise ValueError(f"add_norm_bwd: shapes ({M}, {E}) refused by the kernel")
    dev = x.device
    dx = torch.empty_like(x)
    dwb = torch.empty((2 * E,), dtype=torch.float32, device=dev)
    work = torch.empty((n_work,), dtype=torch.float32, device=dev)
    rc = lib.fused_norm_residual_bwd(
        x.data_ptr(), weight.data_ptr(), gn.data_ptr(),
        None if gx is None else gx.data_ptr(), dx.data_ptr(), dwb.data_ptr(),
        work.data_ptr(), M, E, float(eps), code, INSTANCES[kind],
        _kernels.stream_handle(dev))
    _kernels.check(rc, "add_norm_bwd")
    add_norm_bwd.launches += 1
    add_norm_bwd.carry_launches += gx is not None
    add_norm_bwd.instances[inst] += 1
    return dx, dwb[:E], dwb[E:]


class _AddNormFn(torch.autograd.Function):
    """``(x + delta, LN(x + delta))`` with the fused backward: the
    post-add carry is the saved residual, one ``dx`` serves ``x`` and
    ``delta``, and the carry's cotangent is added in the same pass."""

    @staticmethod
    def forward(ctx, x, delta, w, b, eps):
        carry, normed = _forward(x, delta, w, b, eps)
        ctx.save_for_backward(carry, w)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return carry, normed

    @staticmethod
    def backward(ctx, gx, gn):
        carry, w = ctx.saved_tensors
        if gn is None:
            gn = torch.zeros_like(carry)
        dx, dw, db = add_norm_bwd(carry, w, gn.contiguous(),
                                  None if gx is None else gx.contiguous(),
                                  ctx.eps)
        return dx, dx, dw, db, None


class _NormFn(torch.autograd.Function):
    """``LN(x)`` with the fused backward (no carry cotangent)."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        normed = _forward(x, None, w, b, eps)[1]
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return normed

    @staticmethod
    def backward(ctx, gn):
        x, w = ctx.saved_tensors
        dx, dw, db = add_norm_bwd(x, w, gn.contiguous(), None, ctx.eps)
        return dx, dw, db, None


def fused_add_norm(x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float = 1e-5):
    """``(x + delta, layer_norm(x + delta, weight, bias))`` in one pass.
    ``x``/``delta``: (..., E) in the compute dtype; ``weight``/``bias``:
    (E,), used in fp32. Differentiable: whenever an input requires grad
    the call goes through :class:`_AddNormFn` (on every device); with
    none, the forward runs on its own (the serving path)."""
    w, b = weight.to(torch.float32), bias.to(torch.float32)
    if _kernels.needs_grad(x, delta, w, b):
        return _AddNormFn.apply(x, delta, w, b, float(eps))
    return _forward(x, delta, w, b, float(eps))


def fused_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Single-pass :func:`ops.norms.layer_norm` (no residual input).
    Differentiable like :func:`fused_add_norm`."""
    w, b = weight.to(torch.float32), bias.to(torch.float32)
    if _kernels.needs_grad(x, w, b):
        return _NormFn.apply(x, w, b, float(eps))
    return _forward(x, None, w, b, float(eps))[1]


fused_add_norm.launches = 0
fused_norm.launches = 0
add_norm_bwd.launches = 0
add_norm_bwd.carry_launches = 0
add_norm_bwd.instances = Counter()

# The reference's GroupLayerNorm IS a full-width LayerNorm: same kernels.
fused_add_group_norm = fused_add_norm
fused_group_norm = fused_norm
