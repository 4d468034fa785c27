"""Fused single-query decode attention over the serving slot pool, a
CUDA C++ kernel for Hopper.

Replaces the TPU kernel ``differential_transformer_replication_tpu/ops/
decode_attention.py:_dattn_fwd_kernel`` (via ``decode_attention``) on
its float-KV branch. Each decode step runs one query per slot and S
streams over the head-major ring cache — K (S, B, H, M, d), V
(B, H, M, dv) — with row b seeing slot m iff ``m <= pos[b]``; the
current token's K/V are already written at ``pos % M``. The kernel, its
bound on the H100 (the K/V read) and its design (one block per (b, h,
tile of keys), tiles past ``pos`` skipped, per-tile fp32 softmax
statistics combined by a second small kernel that also applies the
coefficients, no score map in device memory) are described in
``csrc/decode_attention.cu``. The wrapper allocates the per-tile
partial records the two kernels share. The int8 KV branch of the TPU
kernel belongs to a later slice: passing scales raises.

Dispatch is by device: a CPU tensor runs :func:`decode_attention_reference`,
a CUDA tensor always launches the kernel (or raises), any other device
raises. ``decode_attention.launches`` counts the kernel launches. It has
no backward (nor has the TPU kernel): an input that requires grad, with
grad mode on, raises on every device.

The kernel and the plain version agree in fp32. In bf16 they differ by
rounding: the kernel (like the TPU kernel) casts each stream's
probabilities to the cache dtype before its PV product and combines the
S outputs afterwards, while the plain version combines the fp32
probabilities first and casts the combined map once.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from differential_transformer_replication_tpu_torch.ops import _kernels
from differential_transformer_replication_tpu_torch.ops.streams import NEG_INF


def decode_attention_reference(qs, k_cache, v_cache, pos, coeffs) -> torch.Tensor:
    """Plain version: fp32 scores (the TPU kernel's fp32 accumulation),
    ring visibility ``m <= pos[b]``, fp32 per-stream softmax, the
    coefficient combine on the probabilities, then one PV product with
    the combined map cast to V's dtype. Returns (B, H, dv) in q's dtype."""
    S, B, H, M, d = k_cache.shape
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum(
        "sbhd,sbhmd->sbhm", qs.to(torch.float32), k_cache.to(torch.float32)
    ) * scale
    visible = (torch.arange(M, device=pos.device)[None, :]
               <= pos.to(torch.int64)[:, None])
    scores = torch.where(visible[None, :, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    combined = torch.einsum("sh,sbhm->bhm", coeffs.to(torch.float32), probs)
    out = torch.einsum("bhm,bhme->bhe",
                       combined.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.to(qs.dtype)


def decode_attention(qs: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     coeffs: torch.Tensor, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused single-query multi-stream attention over the slot pool.
    ``qs`` (S, B, H, d) post-RoPE queries, ``k_cache`` (S, B, H, M, d),
    ``v_cache`` (B, H, M, dv), ``pos`` (B,) int32 absolute positions,
    ``coeffs`` (S, H) fp32. Returns (B, H, dv) in the query dtype."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "decode_attention: the int8 KV branch is not ported yet"
        )
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (qs, k_cache, v_cache, coeffs)):
        # the JAX kernel has no backward either; a kernel output would
        # carry no gradient path and train nothing without a word
        raise RuntimeError(
            "decode_attention has no backward: call it under torch.no_grad() "
            "or on tensors that do not require grad"
        )
    if qs.device.type == "cpu":
        return decode_attention_reference(qs, k_cache, v_cache, pos, coeffs)
    _kernels.require_cuda(qs, "decode_attention")
    S, B, H, M, d = k_cache.shape
    dv = v_cache.shape[-1]
    dt = qs.dtype
    if dt not in _kernels.DTYPE_CODES:
        raise TypeError(f"decode_attention: unsupported dtype {dt}")
    if qs.shape != (S, B, H, d) or v_cache.shape != (B, H, M, dv) \
            or pos.shape != (B,) or coeffs.shape != (S, H):
        raise ValueError(
            "decode_attention: shapes disagree: q "
            f"{tuple(qs.shape)}, K {tuple(k_cache.shape)}, V "
            f"{tuple(v_cache.shape)}, pos {tuple(pos.shape)}, coeffs "
            f"{tuple(coeffs.shape)}"
        )
    if k_cache.dtype != dt or v_cache.dtype != dt:
        raise TypeError("decode_attention: q, K and V must share one dtype")
    if pos.dtype != torch.int32 or coeffs.dtype != torch.float32:
        raise TypeError("decode_attention: pos must be int32, coeffs float32")
    for name, t in (("q", qs), ("K", k_cache), ("V", v_cache), ("pos", pos),
                    ("coeffs", coeffs)):
        if t.device != qs.device or not t.is_contiguous():
            raise ValueError(
                f"decode_attention: {name} must be contiguous on {qs.device}"
            )
    if S > 8 or d > 256 or dv > 512:
        raise ValueError(
            f"decode_attention: kernel takes S <= 8, d <= 256, dv <= 512; "
            f"got S={S}, d={d}, dv={dv}"
        )
    code = _kernels.DTYPE_CODES[dt]
    lib = _kernels.load("decode_attention")
    n_work = lib.decode_attention_workspace(S, B, H, M, d, dv, code)
    if n_work < 0:
        raise ValueError("decode_attention: shapes refused by the kernel")
    out = torch.empty((B, H, dv), dtype=dt, device=qs.device)
    work = torch.empty((n_work,), dtype=torch.float32, device=qs.device)
    rc = lib.decode_attention_fwd(
        qs.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        coeffs.data_ptr(), out.data_ptr(), work.data_ptr(), S, B, H, M, d, dv,
        1.0 / math.sqrt(d), code, _kernels.stream_handle(qs.device),
    )
    _kernels.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
