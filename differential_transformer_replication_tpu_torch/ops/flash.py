"""Token-major multi-stream flash attention (forward + backward), the
training attention of the port, with its CUDA kernels for Hopper.

Replaces the TPU kernels ``differential_transformer_replication_tpu/ops/
flash.py:_tm_fwd_call`` / ``_tm_fwd_call_packed`` (one forward body) and
``_tm_bwd_call`` / ``_tm_bwd_call_packed`` (one backward body). Each
computes, per batch row, head and causal query row,

    out = sum_s c[s, h] * softmax(q_s k_s^T / sqrt(d)) v

with S <= 4 streams over full T <= 512 (the JAX ``use_tm`` envelope). On
Hopper the per-array and packed routes are one kernel each: the packed
route (the no-RoPE diff family) passes column windows of one
``(B, T, 2*S*H*d + H*dv)`` projection ``x @ [Wq_0..|Wk_0..|Wv]`` and the
backward writes one packed ``dproj``; the per-array route (the RoPE
families, control and ndiff) passes S + S + 1 separate arrays. Kernel
design and bound: ``csrc/flash_tm.cu``.

:class:`_FlashTmFn` wraps both routes: its forward saves the per-stream
outputs ``o_all`` (B, H, S, T, dv) and the fp32 ``lse`` (B, T, H*S); its
backward does the residual algebra of the JAX ``_flash_tm_bwd`` in plain
torch (``base = <g, o_s>``, ``dcoeffs = sum_t base``, ``delta = base *
c``) and then launches the backward kernel. Under ``torch.no_grad`` (or
with no input requiring grad) the forward runs without residuals, the
eval variant.

A training call outside ``use_tm`` (dropout > 0, T > 512, S > 4) raises:
those shapes run through the head-major and KV-tiled kernels, which are
not ported yet. Dispatch is by device: CPU tensors run
:func:`tm_attention_fwd_reference` / :func:`tm_attention_bwd_reference`
(forward AND backward, so CPU gradients are the backward kernel's own
math), CUDA tensors launch the kernels or raise.
``flash_tm_fwd.launches`` / ``flash_tm_bwd.launches`` count launches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from differential_transformer_replication_tpu_torch.ops import _kernels

# the token-major envelope of the JAX package (ops/flash.py use_tm)
TM_MAX_T = 512
TM_MAX_S = 4


def use_tm(S: int, T: int, rate: float) -> bool:
    """True when the token-major kernels cover this config: no attention
    dropout, T <= 512 and S <= 4."""
    return rate == 0.0 and T <= TM_MAX_T and S <= TM_MAX_S


def require_tm(S: int, T: int, rate: float) -> None:
    if not use_tm(S, T, rate):
        raise NotImplementedError(
            f"attention with S={S} streams, T={T}, dropout={rate} is outside "
            f"the token-major kernels (dropout 0, T <= {TM_MAX_T}, S <= "
            f"{TM_MAX_S}); it needs the head-major / KV-tiled flash kernels, "
            "not ported yet (ROADMAP Queue B, rows 9-13)"
        )


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    B, T, W = t.shape
    return t.reshape(B, T, H, W // H).to(torch.float32)


def tm_attention_fwd_reference(qs, ks, v, coeffs, H: int):
    """Plain version of :func:`flash_tm_fwd`: ``qs``/``ks`` S arrays
    (B, T, H*d) (views are fine), ``v`` (B, T, H*dv), ``coeffs`` (S, H)
    fp32. Returns (out (B, T, H*dv), o_all (B, H, S, T, dv) in the
    storage dtype, lse (B, T, H*S) fp32), with the kernel's rounding
    points: p rounded to the storage dtype before PV, fp32 combine."""
    dt = qs[0].dtype
    B, T, _ = qs[0].shape
    d = qs[0].shape[-1] // H
    scale = 1.0 / math.sqrt(d)
    causal = torch.ones(T, T, dtype=torch.bool, device=v.device).tril()
    vf = _heads(v, H)
    comb = None
    o_all, lse = [], []
    for s in range(len(qs)):
        sm = torch.einsum("bqhd,bkhd->bhqk", _heads(qs[s], H),
                          _heads(ks[s], H)) * scale
        sm = sm.masked_fill(~causal, float("-inf"))
        m = sm.amax(dim=-1, keepdim=True)
        p = torch.exp(sm - m)
        l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        pv = torch.einsum("bhqk,bkhe->bhqe", p.to(dt).to(torch.float32), vf)
        o = pv / l_safe
        c = coeffs[s].to(torch.float32)[None, :, None, None]
        comb = o * c if comb is None else comb + o * c
        o_all.append(o.to(dt))
        lse.append((m + torch.log(l_safe))[..., 0])  # (B, H, T)
    out = comb.to(dt).permute(0, 2, 1, 3).reshape(B, T, -1)
    lse = torch.stack(lse, dim=-1).permute(0, 2, 1, 3).reshape(B, T, -1)
    lse = lse.contiguous()
    return out, torch.stack(o_all, dim=2), lse


def tm_attention_bwd_reference(qs, ks, v, g, lse, delta, coeffs, H: int):
    """Plain version of :func:`flash_tm_bwd`: the JAX ``_tm_bwd_columns``
    math. ``g`` (B, T, H*dv) in the storage dtype, ``lse``/``delta``
    (B, T, H*S) fp32. Returns (dqs, dks, dv) as (B, T, H*width) arrays in
    the storage dtype."""
    dt = qs[0].dtype
    S = len(qs)
    B, T, _ = qs[0].shape
    d = qs[0].shape[-1] // H
    scale = 1.0 / math.sqrt(d)
    causal = torch.ones(T, T, dtype=torch.bool, device=v.device).tril()
    gf, vf = _heads(g, H), _heads(v, H)
    gv = torch.einsum("bqhe,bkhe->bhqk", gf, vf)
    lse4 = lse.reshape(B, T, H, S).permute(0, 2, 1, 3)  # (B, H, T, S)
    delta4 = delta.reshape(B, T, H, S).permute(0, 2, 1, 3)
    dqs, dks, pc_sum = [], [], None
    for s in range(S):
        q, k = _heads(qs[s], H), _heads(ks[s], H)
        sm = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        sm = sm.masked_fill(~causal, float("-inf"))
        p = torch.exp(sm - lse4[..., s:s + 1])
        c = coeffs[s].to(torch.float32)[None, :, None, None]
        ds = (p * (gv * c - delta4[..., s:s + 1])).to(dt).to(torch.float32)
        dqs.append((torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale)
                   .to(dt).reshape(B, T, -1))
        dks.append((torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale)
                   .to(dt).reshape(B, T, -1))
        pc = p * c
        pc_sum = pc if pc_sum is None else pc_sum + pc
    dv = torch.einsum("bhqk,bqhe->bkhe", pc_sum.to(dt).to(torch.float32), gf)
    return dqs, dks, dv.to(dt).reshape(B, T, -1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _row_stride(what: str, ts, B: int, T: int, width: int) -> int:
    """The common row stride of token-major operands (B, T, width) whose
    columns are contiguous (column windows of a wider array allowed)."""
    ld = ts[0].stride(1)
    for t in ts:
        if (tuple(t.shape) != (B, T, width) or t.stride(2) != 1
                or t.stride(1) != ld or t.stride(0) != T * ld):
            raise ValueError(f"{what}: operands must be (B, T, {width}) rows "
                             f"of one stride with contiguous columns")
    return ld


def _check_common(what, qs, ks, v, coeffs, H):
    S = len(qs)
    if not 1 <= S <= TM_MAX_S or len(ks) != S:
        raise ValueError(f"{what}: 1..{TM_MAX_S} streams, got {S}")
    dt = qs[0].dtype
    if dt not in _kernels.DTYPE_CODES:
        raise TypeError(f"{what}: unsupported dtype {dt}")
    for t in (*qs, *ks, v):
        if t.dtype != dt or t.device != qs[0].device:
            raise ValueError(f"{what}: q, k and v must share dtype and device")
    if coeffs.dtype != torch.float32 or not coeffs.is_contiguous() \
            or tuple(coeffs.shape) != (S, H):
        raise ValueError(f"{what}: coeffs must be contiguous fp32 ({S}, {H})")
    B, T, Hd = qs[0].shape
    d, dv = Hd // H, v.shape[-1] // H
    ld_qk = _row_stride(what, [*qs, *ks], B, T, H * d)
    ld_v = _row_stride(what, [v], B, T, H * dv)
    return S, B, T, d, dv, ld_qk, ld_v


def flash_tm_fwd(qs, ks, v, coeffs, H: int, save_residuals: bool):
    """Kernel D: (out, o_all, lse); o_all and lse are None when
    ``save_residuals`` is False (the eval variant)."""
    if not _kernels.on_card(v, "flash_tm_fwd"):
        out, o_all, lse = tm_attention_fwd_reference(qs, ks, v, coeffs, H)
        return (out, o_all, lse) if save_residuals else (out, None, None)
    S, B, T, d, dv, ld_qk, ld_v = _check_common("flash_tm_fwd", qs, ks, v,
                                                coeffs, H)
    dt, dev = v.dtype, v.device
    out = torch.empty((B, T, H * dv), dtype=dt, device=dev)
    o_all = lse = None
    if save_residuals:
        o_all = torch.empty((B, H, S, T, dv), dtype=dt, device=dev)
        lse = torch.empty((B, T, H * S), dtype=torch.float32, device=dev)
    lib = _kernels.load("flash_tm")
    rc = lib.flash_tm_fwd(
        _kernels.pointers(qs), _kernels.pointers(ks), v.data_ptr(),
        coeffs.data_ptr(), out.data_ptr(),
        o_all.data_ptr() if save_residuals else None,
        lse.data_ptr() if save_residuals else None,
        S, B, T, H, d, dv, ld_qk, ld_v, 1.0 / math.sqrt(d),
        _kernels.DTYPE_CODES[dt], _kernels.stream_handle(dev),
    )
    _kernels.check(rc, "flash_tm_fwd")
    flash_tm_fwd.launches += 1
    return out, o_all, lse


def flash_tm_bwd(qs, ks, v, g, lse, delta, coeffs, H: int, dqs, dks, dv):
    """Kernel E: writes dq_s, dk_s and dv into the given output arrays
    (B, T, H*width) (column windows of one packed dproj allowed)."""
    if not _kernels.on_card(v, "flash_tm_bwd"):
        rq, rk, rv = tm_attention_bwd_reference(qs, ks, v, g, lse, delta,
                                                coeffs, H)
        for dst, src in zip([*dqs, *dks, dv], [*rq, *rk, rv]):
            dst.copy_(src)
        return
    S, B, T, d, dv_w, ld_qk, ld_v = _check_common("flash_tm_bwd", qs, ks, v,
                                                  coeffs, H)
    for t, w in ((g, H * dv_w), (lse, H * S), (delta, H * S)):
        if tuple(t.shape) != (B, T, w) or not t.is_contiguous():
            raise ValueError("flash_tm_bwd: g, lse and delta must be "
                             "contiguous (B, T, H*width)")
    if g.dtype != v.dtype or lse.dtype != torch.float32 \
            or delta.dtype != torch.float32:
        raise TypeError("flash_tm_bwd: g in the storage dtype, lse and "
                        "delta fp32")
    ld_dqk = _row_stride("flash_tm_bwd", [*dqs, *dks], B, T, H * d)
    ld_dv = _row_stride("flash_tm_bwd", [dv], B, T, H * dv_w)
    lib = _kernels.load("flash_tm")
    rc = lib.flash_tm_bwd(
        _kernels.pointers(qs), _kernels.pointers(ks), v.data_ptr(),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(), coeffs.data_ptr(),
        _kernels.pointers(dqs), _kernels.pointers(dks), dv.data_ptr(),
        S, B, T, H, d, dv_w, ld_qk, ld_v, ld_dqk, ld_dv, 1.0 / math.sqrt(d),
        _kernels.DTYPE_CODES[v.dtype], _kernels.stream_handle(v.device),
    )
    _kernels.check(rc, "flash_tm_bwd")
    flash_tm_bwd.launches += 1


flash_tm_fwd.launches = 0
flash_tm_bwd.launches = 0


# ---------------------------------------------------------------------------
# the differentiable entry points
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Layout:
    """How the tensors handed to :class:`_FlashTmFn` map to operands:
    packed = one (B, T, 2*S*H*d + H*dv) projection, else S q arrays, S k
    arrays and v, each (B, T, H*width)."""

    S: int
    H: int
    d: int
    dv: int
    packed: bool
    save: bool

    def operands(self, arrays):
        S, Hd = self.S, self.H * self.d
        if self.packed:
            (proj,) = arrays
            qs = [proj[..., s * Hd:(s + 1) * Hd] for s in range(S)]
            ks = [proj[..., (S + s) * Hd:(S + s + 1) * Hd] for s in range(S)]
            return qs, ks, proj[..., 2 * S * Hd:]
        return list(arrays[:S]), list(arrays[S:2 * S]), arrays[2 * S]


class _FlashTmFn(torch.autograd.Function):
    """Both token-major routes (see :class:`_Layout`)."""

    @staticmethod
    def forward(ctx, layout, coeffs, *arrays):
        qs, ks, v = layout.operands(arrays)
        out, o_all, lse = flash_tm_fwd(qs, ks, v, coeffs, layout.H,
                                       layout.save)
        if layout.save:
            ctx.layout = layout
            ctx.save_for_backward(coeffs, o_all, lse, *arrays)
        return out

    @staticmethod
    def backward(ctx, g):
        layout = ctx.layout
        coeffs, o_all, lse, *arrays = ctx.saved_tensors
        qs, ks, v = layout.operands(arrays)
        B, H, S, T, dv = o_all.shape
        base = torch.einsum("bthd,bhstd->bths",
                            g.to(torch.float32).reshape(B, T, H, dv),
                            o_all.to(torch.float32))
        dcoeffs = base.sum(dim=(0, 1)).t()
        delta = (base * coeffs.t()[None, None]).reshape(B, T, H * S)
        g = g.to(v.dtype).contiguous()
        if layout.packed:
            dproj = torch.empty_like(arrays[0])
            dqs, dks, dv_ = layout.operands([dproj])
            flash_tm_bwd(qs, ks, v, g, lse, delta, coeffs, H, dqs, dks, dv_)
            return None, dcoeffs, dproj
        grads = [torch.empty_like(t) for t in arrays]
        flash_tm_bwd(qs, ks, v, g, lse, delta, coeffs, H, grads[:S],
                     grads[S:2 * S], grads[2 * S])
        return (None, dcoeffs, *grads)


def multi_stream_flash_attention_tm(qs, ks, v: torch.Tensor,
                                    coeffs: torch.Tensor, B: int,
                                    H: int) -> torch.Tensor:
    """Token-major entry: ``qs``/``ks`` are S ``(B, T, H, d)`` arrays
    (each the reshaped output of its own projection), ``v`` is ``(B, T,
    H, dv)``, ``coeffs`` (S, H) fp32; returns ``(B, T, H, dv)``."""
    S = len(qs)
    _, T, _, d = qs[0].shape
    dv = v.shape[-1]
    require_tm(S, T, 0.0)
    arrays = ([q.reshape(B, T, H * d) for q in qs]
              + [k.reshape(B, T, H * d) for k in ks]
              + [v.reshape(B, T, H * dv)])
    coeffs = coeffs.to(torch.float32).contiguous()
    layout = _Layout(S, H, d, dv, False, _kernels.needs_grad(coeffs, *arrays))
    out = _FlashTmFn.apply(layout, coeffs, *arrays)
    return out.reshape(B, T, H, dv)


def multi_stream_flash_attention_tm_packed(proj: torch.Tensor,
                                           coeffs: torch.Tensor, B: int,
                                           H: int, S: int, d: int,
                                           dv: int) -> torch.Tensor:
    """Packed-projection entry: ``proj`` is the raw (B, T, 2*S*H*d +
    H*dv) output of ONE fused projection matmul ``x @ [Wq_0..|Wk_0..|Wv]``;
    returns (B, T, H, dv). The backward emits one packed ``dproj``."""
    T = proj.shape[1]
    require_tm(S, T, 0.0)
    if proj.shape[-1] != 2 * S * H * d + H * dv or not proj.is_contiguous():
        raise ValueError("multi_stream_flash_attention_tm_packed: proj must "
                         f"be contiguous (B, T, {2 * S * H * d + H * dv})")
    coeffs = coeffs.to(torch.float32).contiguous()
    layout = _Layout(S, H, d, dv, True, _kernels.needs_grad(coeffs, proj))
    out = _FlashTmFn.apply(layout, coeffs, proj)
    return out.reshape(B, T, H, dv)
