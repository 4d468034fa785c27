"""Multi-stream causal flash attention (forward + backward), the training
attention of the port, with its CUDA kernels for Hopper. Two routes, as
in the JAX package (``ops/flash.py``: ``use_tm`` picks):

- token-major (dropout 0, T <= 512, S <= 4): replaces the TPU kernels
  ``_tm_fwd_call`` / ``_tm_fwd_call_packed`` (one forward body) and
  ``_tm_bwd_call`` / ``_tm_bwd_call_packed`` (one backward body), kernels
  D and E of ``csrc/flash_tm.cu``. The packed route (the no-RoPE diff
  family) passes column windows of one ``(B, T, 2*S*H*d + H*dv)``
  projection and its backward writes one packed ``dproj``; the per-array
  route passes S + S + 1 arrays.
- head-major (everything else: attention dropout, T > 512, S > 4): the
  counterpart of ``multi_stream_flash_attention_bh`` / ``_flash``, over
  the ``(B*H, S, T, d)`` layout, with in-kernel attention dropout from the
  JAX package's counter hash. Replaces ``_fwd_call`` and
  ``_tiled_fwd_call`` (kernel K1, ``csrc/flash_bh_fwd.cu``), ``_bwd_call``
  and ``_tiled_bwd_call`` (K2 dq, K3 dk/dv: ``csrc/flash_bh_bwd_dq.cu``,
  ``csrc/flash_bh_bwd_dkv.cu``; fp32 ``csrc/flash_bh.cu``) and
  ``_fused_bwd_call`` (K4: ``csrc/flash_bh_bwd_fused.cu``; fp32 and the
  shapes past its instances ``csrc/flash_bh.cu``).
  The TPU's splits by VMEM (resident/tiled at ``_KV_TILE_THRESHOLD``,
  fused/split at ``_FUSED_BWD_BUDGET``) are kept as the route names of
  each launch (:func:`fwd_route`, :func:`bwd_route`).
- the ring chunk (sequence parallelism, ``parallel/ring.py``): the
  counterpart of JAX ``flash_chunk_attention``, per-stream ``(o_all,
  lse)`` under a causal offset, with no stream combine. Replaces
  ``_chunk_fwd_call`` (K1 without coefficients; ``_tiled_fwd_call`` in
  that mode past T = 4096) and the per-stream form of ``_bwd_call`` /
  ``_tiled_bwd_call`` (``coeffs=None``: K2/K3 with one cotangent per
  stream). Routes ``chunk-resident``/``chunk-tiled`` (forward) and
  ``chunk-split``/``chunk-tiled`` (backward).

Each computes, per batch row, head and causal query row,

    out = sum_s c[s, h] * dropout(softmax(q_s k_s^T / sqrt(d))) v

:class:`_FlashTmFn` and :class:`_FlashBhFn` save the per-stream outputs
``o_all`` and the fp32 ``lse`` in their forward; their backward does the
residual algebra of the JAX ``_flash_bwd`` in plain torch (``base = <g,
o_s>``, ``dcoeffs = sum_t base``, ``delta = base * c``) and then launches
the backward kernels. Under ``torch.no_grad`` (or with no input requiring
grad) the forward runs without residuals, the eval variant.

Dispatch is by device: CPU tensors run the plain versions (forward AND
backward, so CPU gradients are the backward kernels' own math), CUDA
tensors launch the kernels or raise. Every wrapper counts its launches
(``.launches``) and, for the head-major kernels, the route of each
(``.routes``).
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass

import torch

from differential_transformer_replication_tpu_torch.ops import _kernels
from differential_transformer_replication_tpu_torch.ops.streams import NEG_INF

# the token-major envelope of the JAX package (ops/flash.py use_tm)
TM_MAX_T = 512
TM_MAX_S = 4
# head widths every training attention kernel takes (MAX_D, MAX_DV of
# csrc/flash_tm.cu and csrc/flash_bh_common.cuh)
MAX_D, MAX_DV = 128, 256


def use_tm(S: int, T: int, rate: float) -> bool:
    """True when the token-major kernels cover this config: no attention
    dropout, T <= 512 and S <= 4."""
    return rate == 0.0 and T <= TM_MAX_T and S <= TM_MAX_S


def _refuse_outside_tm(S: int, T: int) -> None:
    if not use_tm(S, T, 0.0):
        raise ValueError(
            f"token-major attention takes S <= {TM_MAX_S} streams and T <= "
            f"{TM_MAX_T} (got S={S}, T={T}); longer context, more streams "
            "and attention dropout take the head-major entry "
            "multi_stream_flash_attention_bh"
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
    _refuse_outside_tm(S, T)
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
    _refuse_outside_tm(S, T)
    if proj.shape[-1] != 2 * S * H * d + H * dv or not proj.is_contiguous():
        raise ValueError("multi_stream_flash_attention_tm_packed: proj must "
                         f"be contiguous (B, T, {2 * S * H * d + H * dv})")
    coeffs = coeffs.to(torch.float32).contiguous()
    layout = _Layout(S, H, d, dv, True, _kernels.needs_grad(coeffs, proj))
    out = _FlashTmFn.apply(layout, coeffs, proj)
    return out.reshape(B, T, H, dv)


# ---------------------------------------------------------------------------
# head-major route: route predicates (the JAX package's constants)
# ---------------------------------------------------------------------------

# T past which the JAX forward streams K/V through a third grid axis
_KV_TILE_THRESHOLD = 4096
# T past which its backward takes the KV-tiled kernels
_BWD_KV_TILE_THRESHOLD = _KV_TILE_THRESHOLD
# the largest S * T * T of its whole-T fused backward
_FUSED_BWD_BUDGET = 2 * 512 * 512
# the kernels' key tile (csrc/flash_bh_common.cuh BK; K1's bf16 KC); the
# plain forward runs its online softmax over key tiles of the same width,
# so p is rounded against the same running max as in the kernel
BLOCK = 32


def _use_fused_bwd(S: int, T: int) -> bool:
    return S * T * T <= _FUSED_BWD_BUDGET


def fwd_route(T: int) -> str:
    """The JAX forward this call stands for: ``resident`` (Queue B row 9,
    ``_fwd_call``) or ``tiled`` (row 10, ``_tiled_fwd_call``)."""
    return "tiled" if T > _KV_TILE_THRESHOLD else "resident"


def bwd_route(S: int, T: int) -> str:
    """The JAX backward this call stands for: ``fused`` (row 12, kernel
    K4), ``tiled`` (row 11) or ``split`` (row 13), both on K2 + K3."""
    if _use_fused_bwd(S, T):
        return "fused"
    return "tiled" if T > _BWD_KV_TILE_THRESHOLD else "split"


# ---------------------------------------------------------------------------
# in-kernel attention dropout: copies of the JAX package's counter hash
# (ops/flash.py:_fmix32, dropout_keep_ids, dropout_keep_reference). Values
# are uint32 held in int64 tensors; every product is cut into 16-bit
# halves so nothing passes 2^63, and masked to 32 bits.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for uint32 values x (int64 tensor) and constant c."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(x):
    """32-bit finalizer (triple32-style avalanche), mod 2^32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> int:
    return min(int(round(rate * (2.0 ** 32))), 2 ** 32 - 1)


def dropout_keep_ids(seed_w0: int, seed_w1: int, bh, s_idx: int, row_ids,
                     col_ids, rate: float) -> torch.Tensor:
    """Bernoulli(1 - rate) keep mask for global attention positions, bit
    for bit the JAX ``dropout_keep_ids``: ``bh`` (b*H + h) an int or an
    int64 tensor, ``row_ids``/``col_ids`` int64 tensors broadcasting
    against it."""
    bh = torch.as_tensor(bh, dtype=torch.int64)
    key = _fmix32(seed_w0 ^ _mul32(bh, 0x9E3779B1)
                  ^ ((s_idx * 0x27D4EB2F) & _M32))
    x = (_mul32(torch.as_tensor(row_ids, dtype=torch.int64), 0x85EBCA77)
         ^ _mul32(torch.as_tensor(col_ids, dtype=torch.int64), 0xC2B2AE3D))
    w1 = (seed_w1 * 0x9E3779B1) & _M32
    return _fmix32(_fmix32((x + key) & _M32) ^ w1) >= keep_threshold(rate)


def seed_words(seed: torch.Tensor) -> tuple:
    """The two 24-bit words of a (1, 2) float32 seed as Python ints (the
    seed lies on the CPU: no device sync)."""
    w0, w1 = seed.reshape(-1).tolist()
    return int(w0), int(w1)


def dropout_seed_from_generator(gen: torch.Generator) -> torch.Tensor:
    """(1, 2) float32 CPU tensor carrying two 24-bit seed words drawn from
    a CPU ``torch.Generator`` (the counterpart of JAX
    ``dropout_seed_from_rng``; the words are exact in float32)."""
    return torch.randint(0, 1 << 24, (1, 2), generator=gen,
                         dtype=torch.int64).to(torch.float32)


def dropout_keep_reference(seed: torch.Tensor, BH: int, S: int, T: int,
                           rate: float) -> torch.Tensor:
    """(BH, S, T, T) keep booleans the kernels use for ``seed`` (test use:
    it materializes full T x T masks)."""
    w0, w1 = seed_words(seed)
    rows = torch.arange(T, dtype=torch.int64)[:, None]
    cols = torch.arange(T, dtype=torch.int64)[None, :]
    return torch.stack([
        torch.stack([dropout_keep_ids(w0, w1, bh, s, rows, cols, rate)
                     for s in range(S)]) for bh in range(BH)])


def _keep_block(words, rate, BH, S, rows, cols, device):
    """(BH, S, len(rows), len(cols)) keep mask of a block of global
    positions, on ``device``."""
    bh = torch.arange(BH, dtype=torch.int64, device=device)[:, None, None]
    return torch.stack([
        dropout_keep_ids(words[0], words[1], bh, s, rows[:, None].to(device),
                         cols[None, :].to(device), rate)
        for s in range(S)], dim=1)


def _coeffs_bh(coeffs: torch.Tensor, BH: int) -> torch.Tensor:
    """(S, H) combine coefficients -> (BH, S), row b*H + h = coeffs[:, h]."""
    H = coeffs.shape[1]
    return coeffs.to(torch.float32).t().repeat(BH // H, 1)


# ---------------------------------------------------------------------------
# head-major plain versions
# ---------------------------------------------------------------------------


def bh_attention_fwd_reference(q, k, v, coeffs, rate: float = 0.0,
                               words=(0, 0), off: int = 0):
    """Plain version of :func:`flash_bh_fwd` and :func:`flash_chunk_fwd`:
    q, k (BH, S, T, d), v (BH, T, dv), coeffs (S, H) fp32, or None for
    the no-combine mode. Returns (out (BH, T, dv), None without coeffs;
    o_all (BH, S, T, dv) in the storage dtype; lse (BH, S, T) fp32).
    Column c is visible to row r iff c <= r + off. The kernel's online
    softmax over key tiles of :data:`BLOCK`: the normalizer sums the
    undropped p; p (dropped, scaled by 1/(1-rate); the hash takes column
    c - off) is rounded to the storage dtype before PV; the streams
    combine in fp32. A row with no visible key ends with o = 0 and lse =
    NEG_INF + log(1e-30) (= -1e30 in fp32), as the JAX kernel's."""
    dt, dev = q.dtype, q.device
    BH, S, T, d = q.shape
    dv = v.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = q.to(torch.float32), k.to(torch.float32), v.to(torch.float32)
    m = torch.full((BH, S, T), float("-inf"), device=dev)
    l = torch.zeros((BH, S, T), device=dev)
    acc = torch.zeros((BH, S, T, dv), device=dev)
    # a fill, not a host copy: the plain versions are graph-capturable
    inv_keep = torch.full((), 1.0 / (1.0 - rate), dtype=torch.float32, device=dev)
    pos = torch.arange(T, device=dev)
    for k0 in range(0, T, BLOCK):
        k1 = min(T, k0 + BLOCK)
        # rows before k0 - off see no key of this tile (the kernel leaves
        # them as they are); each row from r0 on sees key k0
        r0 = max(0, k0 - off)
        if r0 >= T:
            break
        s = torch.einsum("bsqd,bskd->bsqk", qf[:, :, r0:], kf[:, :, k0:k1]) * scale
        vis = pos[k0:k1][None, :] <= pos[r0:][:, None] + off
        s = s.masked_fill(~vis, float("-inf"))
        m_old = m[:, :, r0:]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        alpha = torch.exp(m_old - m_new)
        p = torch.exp(s - m_new[..., None])
        l[:, :, r0:] = l[:, :, r0:] * alpha + p.sum(dim=-1)
        if rate > 0.0:
            keep = _keep_block(words, rate, BH, S, pos[r0:], pos[k0:k1] - off, dev)
            p = torch.where(keep, p * inv_keep, 0.0)
        pv = torch.einsum("bsqk,bkc->bsqc", p.to(dt).to(torch.float32),
                          vf[:, k0:k1])
        acc[:, :, r0:] = acc[:, :, r0:] * alpha[..., None] + pv
        m[:, :, r0:] = m_new
    l_safe = torch.clamp(l, min=1e-30)
    o = acc / l_safe[..., None]
    lse = torch.where(m == float("-inf"), NEG_INF, m) + torch.log(l_safe)
    if coeffs is None:
        return None, o.to(dt), lse
    c = _coeffs_bh(coeffs, BH)
    comb = o[:, 0] * c[:, 0, None, None]
    for si in range(1, S):
        comb = comb + o[:, si] * c[:, si, None, None]
    return comb.to(dt), o.to(dt), lse


_QUERY_CHUNK = 1024  # plain backward: query rows per pass (bounds memory)


def bh_attention_bwd_reference(q, k, v, g, lse, delta, coeffs,
                               rate: float = 0.0, words=(0, 0), off: int = 0):
    """Plain version of the head-major backward kernels. With coeffs (S,
    H), the JAX factored ``_bwd_call`` math: g (BH, T, dv) in the storage
    dtype, dP_s = c_s (g V^T), dv = (sum_s c_s P~_s, rounded)^T g. With
    ``coeffs=None``, the per-stream form (the ring chunk's): g (BH, S, T,
    dv), dP_s = g_s V^T, dv = sum_s (P~_s, rounded)^T g_s. Both: lse/delta
    (BH, S, T) fp32; p = exp(s*scale - lse) where column c <= row + off;
    dP masked and scaled by the same keep mask (hash column c - off); ds =
    p (dP - delta) rounded to the storage dtype before the dq/dk products.
    Returns (dq, dk (BH, S, T, d), dv (BH, T, dv))."""
    dt, dev = q.dtype, q.device
    BH, S, T, d = q.shape
    scale = 1.0 / math.sqrt(d)
    per_stream = coeffs is None
    qf, kf = q.to(torch.float32), k.to(torch.float32)
    vf, gf = v.to(torch.float32), g.to(torch.float32)
    c = None if per_stream else _coeffs_bh(coeffs, BH)
    # a fill, not a host copy: the plain versions are graph-capturable
    inv_keep = torch.full((), 1.0 / (1.0 - rate), dtype=torch.float32, device=dev)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    pos = torch.arange(T, device=dev)
    for q0 in range(0, T, _QUERY_CHUNK):
        q1 = min(T, q0 + _QUERY_CHUNK)
        kn = min(T, q1 + off)  # keys past kn lie in every row's future
        if kn <= 0:
            continue
        vis = pos[:kn][None, :] <= pos[q0:q1][:, None] + off
        keep = (_keep_block(words, rate, BH, S, pos[q0:q1], pos[:kn] - off, dev)
                if rate > 0.0 else None)
        gv = None if per_stream else torch.einsum("bqc,bkc->bqk", gf[:, q0:q1], vf[:, :kn])
        pc = None
        for si in range(S):
            sc = torch.einsum("bqd,bkd->bqk", qf[:, si, q0:q1], kf[:, si, :kn]) * scale
            p = torch.where(vis, torch.exp(sc - lse[:, si, q0:q1, None]), 0.0)
            if per_stream:
                dp = torch.einsum("bqc,bkc->bqk", gf[:, si, q0:q1], vf[:, :kn])
            else:
                cs = c[:, si, None, None]
                dp = gv * cs
            pv = p
            if keep is not None:
                dp = torch.where(keep[:, si], dp * inv_keep, 0.0)
                pv = torch.where(keep[:, si], p * inv_keep, 0.0)
            ds = (p * (dp - delta[:, si, q0:q1, None])).to(dt).to(torch.float32)
            dq[:, si, q0:q1] = torch.einsum("bqk,bkd->bqd", ds, kf[:, si, :kn]) * scale
            dk[:, si, :kn] += torch.einsum("bqk,bqd->bkd", ds, qf[:, si, q0:q1])
            if per_stream:
                dv[:, :kn] += torch.einsum("bqk,bqc->bkc", pv.to(dt).to(torch.float32),
                                           gf[:, si, q0:q1])
            else:
                pc = pv * cs if pc is None else pc + pv * cs
        if not per_stream:
            dv[:, :kn] += torch.einsum("bqk,bqc->bkc", pc.to(dt).to(torch.float32),
                                       gf[:, q0:q1])
    return dq.to(dt), (dk * scale).to(dt), dv.to(dt)


# ---------------------------------------------------------------------------
# head-major kernel wrappers
# ---------------------------------------------------------------------------


def _drop_args(rate: float, words) -> tuple:
    """(w0, w1, threshold, inv_keep, on) for the C entry points."""
    if rate <= 0.0:
        return 0, 0, 0, 1.0, 0
    return (int(words[0]), int(words[1]), keep_threshold(rate),
            1.0 / (1.0 - rate), 1)


def _check_bh(what, q, k, v, coeffs, H):
    if q.dtype not in _kernels.DTYPE_CODES:
        raise TypeError(f"{what}: unsupported dtype {q.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 3:
        raise ValueError(f"{what}: q, k (BH, S, T, d) and v (BH, T, dv)")
    BH, S, T, d = q.shape
    if tuple(v.shape[:2]) != (BH, T) or BH % H or S < 1:
        raise ValueError(f"{what}: v must be ({BH}, {T}, dv), B*H rows and "
                         "at least one stream")
    for t in (q, k, v):
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{what}: q, k and v must be contiguous, 16-byte "
                             "aligned and share dtype and device")
    if coeffs is not None and (coeffs.dtype != torch.float32
                               or not coeffs.is_contiguous()
                               or tuple(coeffs.shape) != (S, H)):
        raise ValueError(f"{what}: coeffs must be contiguous fp32 ({S}, {H})")
    return BH, S, T, d, v.shape[-1]


def _check_bwd_inputs(what, q, g, lse, delta, BH, S, T, dv,
                      per_stream: bool = False):
    g_shape = (BH, S, T, dv) if per_stream else (BH, T, dv)
    if tuple(g.shape) != g_shape or g.dtype != q.dtype \
            or not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError(f"{what}: g must be contiguous, 16-byte aligned "
                         f"{g_shape} in the storage dtype")
    for t in (lse, delta):
        if tuple(t.shape) != (BH, S, T) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: lse and delta must be contiguous fp32 "
                             f"({BH}, {S}, {T})")


def flash_bh_fwd(q, k, v, coeffs, H: int, rate: float, words,
                 save_residuals: bool):
    """Kernel K1: (out (BH, T, dv), o_all, lse); o_all and lse are None
    when ``save_residuals`` is False (the eval variant)."""
    if not _kernels.on_card(v, "flash_bh_fwd"):
        out, o_all, lse = bh_attention_fwd_reference(q, k, v, coeffs, rate, words)
        return (out, o_all, lse) if save_residuals else (out, None, None)
    BH, S, T, d, dv = _check_bh("flash_bh_fwd", q, k, v, coeffs, H)
    out, o_all, lse = _launch_fwd("flash_bh_fwd", q, k, v, coeffs, H, 0, rate,
                                  words, save_residuals)
    flash_bh_fwd.launches += 1
    flash_bh_fwd.routes[fwd_route(T)] += 1
    return out, o_all, lse


def _launch_fwd(what, q, k, v, coeffs, H: int, off: int, rate: float, words,
                save_residuals: bool):
    """K1 on checked operands: with ``coeffs`` the combined output (and
    the residuals when asked), without them the no-combine mode (the
    residuals only)."""
    BH, S, T, d = q.shape
    dv = v.shape[-1]
    dt, dev = q.dtype, q.device
    out = o_all = lse = None
    if coeffs is not None:
        out = torch.empty((BH, T, dv), dtype=dt, device=dev)
    if save_residuals:
        o_all = torch.empty((BH, S, T, dv), dtype=dt, device=dev)
        lse = torch.empty((BH, S, T), dtype=torch.float32, device=dev)
    rc = _kernels.load("flash_bh_fwd").flash_bh_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if coeffs is None else coeffs.data_ptr(),
        None if out is None else out.data_ptr(),
        None if o_all is None else o_all.data_ptr(),
        None if lse is None else lse.data_ptr(), S, BH, T, H, d, dv, int(off),
        1.0 / math.sqrt(d), *_drop_args(rate, words), _kernels.DTYPE_CODES[dt],
        _kernels.stream_handle(dev))
    _kernels.check(rc, what)
    return out, o_all, lse


def flash_bh_bwd_dq(q, k, v, g, lse, delta, coeffs, H: int, rate: float,
                    words) -> torch.Tensor:
    """Kernel K2 (the split and tiled routes): dq (BH, S, T, d). The CPU
    route is the plain backward's dq."""
    if not _kernels.on_card(v, "flash_bh_bwd_dq"):
        return bh_attention_bwd_reference(q, k, v, g, lse, delta, coeffs,
                                          rate, words)[0]
    BH, S, T, d, dv = _check_bh("flash_bh_bwd_dq", q, k, v, coeffs, H)
    _check_bwd_inputs("flash_bh_bwd_dq", q, g, lse, delta, BH, S, T, dv)
    dq = _launch_dq("flash_bh_bwd_dq", q, k, v, g, lse, delta, coeffs, H, 0,
                    rate, words)
    flash_bh_bwd_dq.launches += 1
    flash_bh_bwd_dq.routes[bwd_route(S, T)] += 1
    return dq


# the library of K2 and K3 by storage dtype: fp32 is flash_bh.cu's SIMT
# loop, bf16 the tensor-core kernels of flash_bh_bwd_dq.cu and
# flash_bh_bwd_dkv.cu (one C signature each)
_BWD_LIBS = {"dq": {torch.float32: "flash_bh", torch.bfloat16: "flash_bh_bwd_dq"},
             "dkv": {torch.float32: "flash_bh", torch.bfloat16: "flash_bh_bwd_dkv"}}


def _launch_dq(what, q, k, v, g, lse, delta, coeffs, H: int, off: int,
               rate: float, words) -> torch.Tensor:
    """K2 on checked operands (``coeffs=None``: per-stream g)."""
    BH, S, T, d = q.shape
    dq = torch.empty_like(q)
    rc = _kernels.load(_BWD_LIBS["dq"][q.dtype]).flash_bh_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), None if coeffs is None else coeffs.data_ptr(),
        dq.data_ptr(), S, BH, T, H, d, v.shape[-1], int(off), 1.0 / math.sqrt(d),
        *_drop_args(rate, words), _kernels.DTYPE_CODES[q.dtype],
        _kernels.stream_handle(q.device))
    _kernels.check(rc, what)
    return dq


def flash_bh_bwd_dkv(q, k, v, g, lse, delta, coeffs, H: int, rate: float,
                     words) -> tuple:
    """Kernel K3 (the split and tiled routes): (dk (BH, S, T, d), dv (BH,
    T, dv))."""
    if not _kernels.on_card(v, "flash_bh_bwd_dkv"):
        return bh_attention_bwd_reference(q, k, v, g, lse, delta, coeffs,
                                          rate, words)[1:]
    BH, S, T, d, dv = _check_bh("flash_bh_bwd_dkv", q, k, v, coeffs, H)
    _check_bwd_inputs("flash_bh_bwd_dkv", q, g, lse, delta, BH, S, T, dv)
    dk, dv_ = _launch_dkv("flash_bh_bwd_dkv", q, k, v, g, lse, delta, coeffs,
                          H, 0, rate, words)
    flash_bh_bwd_dkv.launches += 1
    flash_bh_bwd_dkv.routes[bwd_route(S, T)] += 1
    return dk, dv_


def _launch_dkv(what, q, k, v, g, lse, delta, coeffs, H: int, off: int,
                rate: float, words) -> tuple:
    """K3 on checked operands (``coeffs=None``: per-stream g)."""
    BH, S, T, d = q.shape
    dk, dv_ = torch.empty_like(k), torch.empty_like(v)
    rc = _kernels.load(_BWD_LIBS["dkv"][q.dtype]).flash_bh_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), None if coeffs is None else coeffs.data_ptr(),
        dk.data_ptr(), dv_.data_ptr(), S, BH, T, H, d, v.shape[-1], int(off),
        1.0 / math.sqrt(d), *_drop_args(rate, words),
        _kernels.DTYPE_CODES[q.dtype], _kernels.stream_handle(q.device))
    _kernels.check(rc, what)
    return dk, dv_


# the tensor-core K4 (csrc/flash_bh_bwd_fused.cu): bf16, at most this many
# streams, head widths in multiples of 8 (16-byte loads), dv at most this
K4_MMA_MAX_S, K4_MMA_MAX_DV = 2, 192


def fused_bwd_instance(S: int, d: int, dv: int, dtype: torch.dtype) -> str:
    """Which K4 runs on the card for these shapes: ``mma``, the tensor-core
    kernels of ``csrc/flash_bh_bwd_fused.cu`` (bf16, S <= 2, d and dv
    multiples of 8, dv <= 192: every fused shape of the recipes);
    ``wmma``, the bf16 kernel of ``csrc/flash_bh.cu`` (more streams, other
    widths); ``simt``, its fp32 loop."""
    if dtype != torch.bfloat16:
        return "simt"
    if S <= K4_MMA_MAX_S and d % 8 == 0 and dv % 8 == 0 and dv <= K4_MMA_MAX_DV:
        return "mma"
    return "wmma"


def flash_bh_bwd_fused(q, k, v, g, lse, delta, coeffs, H: int, rate: float,
                       words) -> tuple:
    """Kernel K4 (the fused route): (dq, dk, dv) with one softmax
    recompute per visible pair (:func:`fused_bwd_instance` picks the
    kernel). The ``mma`` instance adds each 64-key block's dq partial into
    a zeroed fp32 scratch with atomic adds, then converts the sums in a
    second device launch, so dq may differ in its last bits between two
    calls on the same inputs (dk and dv are bit-equal); the ``wmma`` and
    ``simt`` instances are one launch, one block per (b, h) over a scratch
    only that block touches: deterministic."""
    if not _kernels.on_card(v, "flash_bh_bwd_fused"):
        return bh_attention_bwd_reference(q, k, v, g, lse, delta, coeffs,
                                          rate, words)
    BH, S, T, d, dv = _check_bh("flash_bh_bwd_fused", q, k, v, coeffs, H)
    _check_bwd_inputs("flash_bh_bwd_fused", q, g, lse, delta, BH, S, T, dv)
    dq, dk, dv_ = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    t_pad = -(-T // BLOCK) * BLOCK
    n_acc = BH * S * t_pad * (-(-d // 16) * 16)
    if fused_bwd_instance(S, d, dv, q.dtype) == "mma":  # dq's sums, zero at the launch
        lib = "flash_bh_bwd_fused"
        scratch = torch.zeros(n_acc, dtype=torch.float32, device=q.device)
    else:  # written before it is read
        lib = "flash_bh"
        scratch = torch.empty(n_acc, dtype=torch.float32, device=q.device)
    rc = _kernels.load(lib).flash_bh_bwd_fused(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), coeffs.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv_.data_ptr(), scratch.data_ptr(), S, BH, T, H, d, dv,
        1.0 / math.sqrt(d), *_drop_args(rate, words),
        _kernels.DTYPE_CODES[q.dtype], _kernels.stream_handle(q.device))
    _kernels.check(rc, "flash_bh_bwd_fused")
    flash_bh_bwd_fused.launches += 1
    flash_bh_bwd_fused.routes["fused"] += 1
    return dq, dk, dv_


# ---------------------------------------------------------------------------
# ring-chunk wrappers: K1 without the combine, K2/K3 with per-stream
# cotangents, all under a causal offset (JAX _chunk_fwd_call and the
# coeffs=None form of _bwd_call / _tiled_bwd_call)
# ---------------------------------------------------------------------------


def chunk_fwd_route(T: int) -> str:
    """``chunk-resident`` (Queue B row 14, ``_chunk_fwd_call``) or
    ``chunk-tiled`` (row 10 in the no-combine mode), at the JAX split."""
    return "chunk-tiled" if T > _KV_TILE_THRESHOLD else "chunk-resident"


def chunk_bwd_route(T: int) -> str:
    """``chunk-split`` (row 13's per-stream form) or ``chunk-tiled`` (row
    11's): JAX never takes the fused backward with an offset."""
    return "chunk-tiled" if T > _BWD_KV_TILE_THRESHOLD else "chunk-split"


def flash_chunk_fwd(q, k, v, off: int, rate: float, words) -> tuple:
    """Kernel K1 in the no-combine mode: per-stream (o_all (BH, S, T, dv),
    lse (BH, S, T) fp32) of q, k (BH, S, T, d) against v (BH, T, dv), with
    column c visible to row r iff c <= r + off."""
    if not _kernels.on_card(v, "flash_chunk_fwd"):
        return bh_attention_fwd_reference(q, k, v, None, rate, words, off)[1:]
    _, S, T, _, _ = _check_bh("flash_chunk_fwd", q, k, v, None, 1)
    _, o_all, lse = _launch_fwd("flash_chunk_fwd", q, k, v, None, 1, off, rate,
                                words, True)
    flash_chunk_fwd.launches += 1
    flash_chunk_fwd.routes[chunk_fwd_route(T)] += 1
    return o_all, lse


def flash_chunk_bwd_dq(q, k, v, do, lse, delta, off: int, rate: float,
                       words) -> torch.Tensor:
    """Kernel K2 with per-stream cotangents ``do`` (BH, S, T, dv) and the
    offset: dq (BH, S, T, d)."""
    if not _kernels.on_card(v, "flash_chunk_bwd_dq"):
        return bh_attention_bwd_reference(q, k, v, do, lse, delta, None, rate,
                                          words, off)[0]
    BH, S, T, _, dv = _check_bh("flash_chunk_bwd_dq", q, k, v, None, 1)
    _check_bwd_inputs("flash_chunk_bwd_dq", q, do, lse, delta, BH, S, T, dv, True)
    dq = _launch_dq("flash_chunk_bwd_dq", q, k, v, do, lse, delta, None, 1, off,
                    rate, words)
    flash_chunk_bwd_dq.launches += 1
    flash_chunk_bwd_dq.routes[chunk_bwd_route(T)] += 1
    return dq


def flash_chunk_bwd_dkv(q, k, v, do, lse, delta, off: int, rate: float,
                        words) -> tuple:
    """Kernel K3 with per-stream cotangents and the offset: (dk (BH, S, T,
    d), dv (BH, T, dv) = sum_s P~_s^T do_s)."""
    if not _kernels.on_card(v, "flash_chunk_bwd_dkv"):
        return bh_attention_bwd_reference(q, k, v, do, lse, delta, None, rate,
                                          words, off)[1:]
    BH, S, T, _, dv = _check_bh("flash_chunk_bwd_dkv", q, k, v, None, 1)
    _check_bwd_inputs("flash_chunk_bwd_dkv", q, do, lse, delta, BH, S, T, dv, True)
    dk, dv_ = _launch_dkv("flash_chunk_bwd_dkv", q, k, v, do, lse, delta, None,
                          1, off, rate, words)
    flash_chunk_bwd_dkv.launches += 1
    flash_chunk_bwd_dkv.routes[chunk_bwd_route(T)] += 1
    return dk, dv_


def flash_chunk_bwd(q, k, v, do, lse, delta, off: int, rate: float,
                    words) -> tuple:
    """The chunk backward, K2 then K3: (dq, dk, dv)."""
    if not _kernels.on_card(v, "flash_chunk_bwd"):
        return bh_attention_bwd_reference(q, k, v, do, lse, delta, None, rate,
                                          words, off)
    dq = flash_chunk_bwd_dq(q, k, v, do, lse, delta, off, rate, words)
    dk, dv = flash_chunk_bwd_dkv(q, k, v, do, lse, delta, off, rate, words)
    return dq, dk, dv


BH_WRAPPERS = (flash_bh_fwd, flash_bh_bwd_dq, flash_bh_bwd_dkv,
               flash_bh_bwd_fused)
CHUNK_WRAPPERS = (flash_chunk_fwd, flash_chunk_bwd_dq, flash_chunk_bwd_dkv)
for _fn in BH_WRAPPERS + CHUNK_WRAPPERS:
    _fn.launches = 0
    _fn.routes = Counter()


def reset_bh_counters() -> None:
    """Zero the launch and route counts of the head-major kernels' wrappers
    (K1-K4 and their ring-chunk modes)."""
    for fn in BH_WRAPPERS + CHUNK_WRAPPERS:
        fn.launches = 0
        fn.routes = Counter()


def flash_bh_bwd(q, k, v, g, lse, delta, coeffs, H: int, rate: float,
                 words) -> tuple:
    """The head-major backward by route: K4 on ``fused``, K2 + K3 on
    ``split`` and ``tiled``. Returns (dq, dk, dv)."""
    S, T = q.shape[1], q.shape[2]
    if bwd_route(S, T) == "fused":
        return flash_bh_bwd_fused(q, k, v, g, lse, delta, coeffs, H, rate, words)
    dq = flash_bh_bwd_dq(q, k, v, g, lse, delta, coeffs, H, rate, words)
    dk, dv = flash_bh_bwd_dkv(q, k, v, g, lse, delta, coeffs, H, rate, words)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# head-major differentiable entry points
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _BhCall:
    H: int
    rate: float
    words: tuple
    save: bool


class _FlashBhFn(torch.autograd.Function):
    """The head-major route (the JAX ``_flash`` custom VJP)."""

    @staticmethod
    def forward(ctx, call, coeffs, q, k, v):
        out, o_all, lse = flash_bh_fwd(q, k, v, coeffs, call.H, call.rate,
                                       call.words, call.save)
        if call.save:
            ctx.call = call
            ctx.save_for_backward(coeffs, q, k, v, o_all, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        call = ctx.call
        coeffs, q, k, v, o_all, lse = ctx.saved_tensors
        BH, S = q.shape[:2]
        c = _coeffs_bh(coeffs, BH)
        # base = <g_t, o_s,t>: dcoeffs = sum_t base, delta_s = c_s * base
        # (valid under dropout: rowsum(dP~ . P) = rowsum(dO . O))
        base = torch.einsum("btd,bstd->bst", g.to(torch.float32),
                            o_all.to(torch.float32))
        dcoeffs = base.sum(dim=-1).reshape(BH // call.H, call.H, S).sum(0).t()
        delta = (base * c[:, :, None]).contiguous()
        g = g.to(q.dtype).contiguous()
        dq, dk, dv = flash_bh_bwd(q, k, v, g, lse, delta, coeffs, call.H,
                                  call.rate, call.words)
        return None, dcoeffs, dq, dk, dv


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, copied if its data does not start on 16 bytes
    (the kernels load 16-byte vectors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_bh(q, k, v, coeffs, seed, H: int, rate: float = 0.0) -> torch.Tensor:
    """The counterpart of JAX ``_flash``: q, k (BH, S, T, d), v (BH, T,
    dv), coeffs (S, H), ``seed`` a (1, 2) float32 CPU tensor of seed
    words (or None) and ``rate`` the attention-dropout rate, used as
    given. Returns (BH, T, dv)."""
    if seed is None or rate <= 0.0:
        rate, words = 0.0, (0, 0)
    else:
        rate, words = float(rate), seed_words(seed)
    coeffs = coeffs.to(torch.float32).contiguous()
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    call = _BhCall(H, rate, words, _kernels.needs_grad(coeffs, q, k, v))
    return _FlashBhFn.apply(call, coeffs, q, k, v)


def multi_stream_flash_attention_bh(q_r, k_r, v_r, coeffs, B: int, H: int, *,
                                    dropout_rate: float = 0.0,
                                    dropout_gen=None) -> torch.Tensor:
    """Head-major entry (JAX ``multi_stream_flash_attention_bh``): q_r, k_r
    (B*H, S, T, d), v_r (B*H, T, dv), coeffs (S, H); returns (B*H, T, dv).
    ``dropout_rate`` > 0 with a CPU ``dropout_gen`` applies attention
    dropout in-kernel with seed words drawn from it; without a generator
    the rate is inert (eval)."""
    if q_r.shape[0] != B * H:
        raise ValueError(f"q_r must have B*H = {B * H} rows")
    if dropout_rate > 0.0 and dropout_gen is not None:
        return flash_bh(q_r, k_r, v_r, coeffs,
                        dropout_seed_from_generator(dropout_gen), H,
                        float(dropout_rate))
    return flash_bh(q_r, k_r, v_r, coeffs, None, H, 0.0)


def multi_stream_flash_attention(qs, ks, v, coeffs, *, dropout_rate: float = 0.0,
                                 dropout_gen=None) -> torch.Tensor:
    """JAX ``multi_stream_flash_attention``: qs/ks (S, B, T, H, d), v (B,
    T, H, dv), coeffs (S, H); returns (B, T, H, dv) through the head-major
    kernels."""
    S, B, T, H, d = qs.shape
    dv = v.shape[-1]
    q_r = qs.permute(1, 3, 0, 2, 4).reshape(B * H, S, T, d)
    k_r = ks.permute(1, 3, 0, 2, 4).reshape(B * H, S, T, d)
    v_r = v.permute(0, 2, 1, 3).reshape(B * H, T, dv)
    out = multi_stream_flash_attention_bh(q_r, k_r, v_r, coeffs, B, H,
                                          dropout_rate=dropout_rate,
                                          dropout_gen=dropout_gen)
    return out.reshape(B, H, T, dv).transpose(1, 2)


# ---------------------------------------------------------------------------
# the ring chunk's differentiable entry point
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _ChunkCall:
    off: int
    rate: float
    words: tuple


class _FlashChunkFn(torch.autograd.Function):
    """The JAX ``flash_chunk_attention`` custom VJP: (o_all, lse), both
    differentiable."""

    @staticmethod
    def forward(ctx, call, q, k, v):
        o_all, lse = flash_chunk_fwd(q, k, v, call.off, call.rate, call.words)
        ctx.call = call
        ctx.save_for_backward(q, k, v, o_all, lse)
        return o_all, lse

    @staticmethod
    def backward(ctx, do, dlse):
        call = ctx.call
        q, k, v, o_all, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o_all)
        do = do.to(q.dtype).contiguous()
        # dS = P (dP - delta + dlse): the lse cotangent folds into delta
        # (JAX _flash_chunk_bwd); with dropout only dP is masked
        delta = torch.einsum("bstd,bstd->bst", do.to(torch.float32),
                             o_all.to(torch.float32))
        if dlse is not None:
            delta = delta - dlse.to(torch.float32)
        dq, dk, dv = flash_chunk_bwd(q, k, v, do, lse, delta.contiguous(),
                                     call.off, call.rate, call.words)
        return None, dq, dk, dv


def flash_chunk_attention(q, k, v, off: int, seed=None,
                          rate: float = 0.0) -> tuple:
    """The counterpart of JAX ``flash_chunk_attention``: per-stream
    ``(o_all (BH, S, T, dv), lse (BH, S, T) fp32)`` of q, k (BH, S, T, d)
    against v (BH, T, dv), column c visible to row r iff c <= r + off;
    ``seed`` a (1, 2) float32 CPU tensor of seed words (or None) and
    ``rate`` the attention-dropout rate (masks hash (row, col - off)). The
    lse sums the UNDROPPED probabilities, so chunks merge exactly by the
    running logsumexp (``parallel/ring.py``). Under ``torch.no_grad`` the
    forward keeps no residuals."""
    if seed is None or rate <= 0.0:
        rate, words = 0.0, (0, 0)
    else:
        rate, words = float(rate), seed_words(seed)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    return _FlashChunkFn.apply(_ChunkCall(int(off), rate, words), q, k, v)
