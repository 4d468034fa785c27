"""Fused multi-stream decode attention over the serving KV pool, a CUDA
C++ kernel for Hopper, with the int8 KV quantization it reads.

Replaces the TPU kernels of ``differential_transformer_replication_tpu/
ops/decode_attention.py``, float and int8 branches alike:

- :func:`decode_attention` (``_dattn_fwd_kernel``): one query per slot
  over the contiguous head-major ring — K (S, B, H, M, d), V
  (B, H, M, dv) — row b seeing slot m iff ``m <= pos[b]``;
- :func:`decode_attention_paged` (``_dattn_paged_kernel``): the same
  through a page table — K (S, P, H, ps, d), V (P, H, ps, dv), tables
  (B, M / ps), key m of slot b at page ``tables[b, m // ps]``, offset
  ``m % ps``;
- :func:`decode_attention_multi` (``_dattn_mq_fwd_kernel``): L query
  rows per slot (the speculative verify step), row (b, l) seeing
  ``m <= pos[b, l]``, over a contiguous cache of R >= B rows (rows past
  B, the verify step's trash row, are never read);
- :func:`decode_attention_multi_paged` (``_dattn_mq_paged_kernel``):
  L rows through the page table.

The current tokens' K/V are already written into the cache. With
``k_scale``/``v_scale`` the cache is int8 (:func:`quantize_kv`) and the
kernel dequantizes inside its tile loads. All four run one templated
kernel (``csrc/decode_attention.cu``, where its bound on the H100, the
K/V read, and its design are described): one block per (b, h, tile of
keys), tiles past every row's position skipped, keys visited in logical
order whatever the storage, so a paged call does a contiguous call's
arithmetic bit for bit. :func:`decode_instance` states which split body
runs (tensor cores for bf16 queries, SIMT for fp32) and the keys per
tile, which the wrapper passes to the kernel; the tile length does not
depend on L, so row l of an L-row call equals the single-row call at
that row's position bit for bit. The kernel takes at most MAX_ROWS query
rows a slot; the multi-row wrappers run any L in passes of at most
MAX_ROWS rows (:func:`verify_passes`, two device launches a pass). The
wrapper allocates the per-tile partial records the two kernels share.

Dispatch is by device: a CPU tensor runs the function's plain version
(``*_reference``), a CUDA tensor always launches the kernel (or
raises), any other device raises. Each wrapper counts its calls that
launch the kernel in ``.launches`` (one a call, whatever its passes)
and those of its int8 instance also in ``.int8_launches``. None has a
backward (nor has the TPU kernel): an input that requires grad, with
grad mode on, raises on every device.

The kernel and the plain versions agree in fp32. In bf16 they differ by
rounding: the kernel (like the TPU kernel) casts each stream's
probabilities to the query dtype before its PV product and combines the
S outputs afterwards, while the plain version combines the fp32
probabilities first and casts the combined map once.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from differential_transformer_replication_tpu_torch.ops import _kernels
from differential_transformer_replication_tpu_torch.ops.streams import NEG_INF

MAX_ROWS = 8  # query rows per slot one kernel pass takes (verify_passes)
# streams and head widths the kernel takes (csrc/decode_attention.cu)
MAX_S, MAX_D, MAX_DV = 8, 256, 512
MAX_TK = 64  # keys per tile
SMEM_LIMIT = 232448  # bytes of shared memory a block may take on the H100


# ---------------------------------------------------------------------------
# the instance rule
# ---------------------------------------------------------------------------


def _pad16(w: int) -> int:
    return -(-w // 16) * 16


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def decode_smem_bytes(route: str, S: int, TK: int, d: int, dv: int) -> int:
    """Shared memory of one split-kernel block, the twin of
    ``csrc/decode_attention.cu``'s ``SmemMma`` (``mma``: bf16 tiles, rows
    padded to 16 columns plus 8; the queries and probabilities as 8 rows
    a stream; each key's storage row) and ``SmemSimt`` (``simt``: fp32,
    sized at MAX_ROWS rows)."""
    if route == "mma":
        ldk, ldv, ldp = _pad16(d) + 8, _pad16(dv) + 8, TK + 8
        k = _align16(S * 8 * ldk * 2)
        v = _align16(k + S * TK * ldk * 2)
        p = _align16(v + TK * ldv * 2)
        rows = _align16(p + S * 8 * ldp * 2)
        return rows + TK * 8 + MAX_ROWS * 4
    L = MAX_ROWS
    k = _align16(S * L * d * 4)
    v = _align16(k + S * TK * d * 4)
    p = _align16(v + TK * dv * 4)
    stats = p + S * L * TK * 4
    return stats + 2 * S * L * 4 + L * 4


def decode_instance(dtype: torch.dtype, S: int, L: int, d: int, dv: int) -> tuple:
    """Which split body runs on the card and its keys per tile: ``("mma",
    TK)`` for bf16 queries (bf16 or int8 K/V: tensor cores) or
    ``("simt", TK)`` for fp32 (bf16 or tf32 products would not hold the
    plain version's 1e-5). TK is the largest power of two up to MAX_TK
    (down to 16 for ``mma``, whole 16-key row tiles, 8 for ``simt``) whose
    block fits the shared memory. It does not depend on L, so an L-row
    call cuts the keys into the single-row call's tiles: row l of the one
    equals the other at ``pos[:, l]`` bit for bit. Any L >= 1 is taken:
    the wrapper runs the rows in passes of at most MAX_ROWS
    (:func:`verify_passes`)."""
    if not (1 <= S <= MAX_S and L >= 1 and 1 <= d <= MAX_D
            and 1 <= dv <= MAX_DV):
        raise ValueError(
            f"decode attention takes S <= {MAX_S}, L >= 1, d <= {MAX_D}, "
            f"dv <= {MAX_DV}; got S={S}, L={L}, d={d}, dv={dv}")
    if dtype not in _kernels.DTYPE_CODES:
        raise TypeError(f"decode attention: unsupported query dtype {dtype}")
    route = "mma" if dtype == torch.bfloat16 else "simt"
    TK, least = MAX_TK, 16 if route == "mma" else 8
    while TK > least and decode_smem_bytes(route, S, TK, d, dv) > SMEM_LIMIT:
        TK //= 2
    return route, TK


def verify_passes(L: int) -> list:
    """The row ranges ``[l0, l1)`` of an L-row call's kernel passes, at
    most MAX_ROWS rows each (the kernel's shared memory is sized for
    MAX_ROWS query rows a slot). Each pass is a full kernel call on rows
    ``l0 .. l1 - 1`` with their own positions, so every row is computed
    exactly as in the single-row call."""
    if L < 1:
        raise ValueError(f"decode attention needs L >= 1 rows, got {L}")
    return [(l0, min(l0 + MAX_ROWS, L)) for l0 in range(0, L, MAX_ROWS)]


# ---------------------------------------------------------------------------
# int8 KV quantization (per-vector symmetric scales)
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor):
    """Symmetric int8 quantization over the LAST axis, bit for bit the
    JAX package's: one fp32 scale per leading-index vector,
    ``max(amax, 1e-12) / 127``, values ``round(x / scale)`` (half to
    even). Returns ``(int8 values, fp32 scales)``."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` in ``dtype``: ``float(q) * scale``
    rounded once (the kernel does the same multiply in its tile loads)."""
    return (q.to(torch.float32) * scale[..., None].to(torch.float32)).to(dtype)


def _float_cache(k, v, k_scale, v_scale, dtype):
    """The cache as float tensors of ``dtype`` (dequantized on the int8
    path, as the TPU kernel does: rounded to the query dtype)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if k_scale is None:
        return k, v
    return dequantize_kv(k, k_scale, dtype), dequantize_kv(v, v_scale, dtype)


def gather_pool_view(leaf: torch.Tensor, tables: torch.Tensor,
                     axis: int) -> torch.Tensor:
    """Every slot's contiguous ring view of a paged leaf: (…, P, H, ps, …)
    gathered through the (B, pages_per_slot) table into (…, B, H, M, …)
    (the JAX ``models/decode.py:_gather_pool_view``)."""
    B, pp = tables.shape
    g = torch.index_select(leaf, axis, tables.reshape(-1).to(torch.int64))
    g = g.unflatten(axis, (B, pp)).movedim(axis + 1, axis + 2)
    return g.flatten(axis + 2, axis + 3)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def decode_attention_reference(qs, k_cache, v_cache, pos, coeffs,
                               k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain version of :func:`decode_attention`: dequantize (int8),
    fp32 scores (the TPU kernel's fp32 accumulation), ring visibility
    ``m <= pos[b]``, fp32 per-stream softmax, the coefficient combine on
    the probabilities, then one PV product with the combined map cast
    to V's dtype. Returns (B, H, dv) in q's dtype."""
    k_cache, v_cache = _float_cache(k_cache, v_cache, k_scale, v_scale, qs.dtype)
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


def decode_attention_paged_reference(qs, k_pages, v_pages, tables, pos, coeffs,
                                     k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain version of :func:`decode_attention_paged`: gather every
    slot's ring view through the table, then
    :func:`decode_attention_reference`."""
    view = [gather_pool_view(t, tables, axis) if t is not None else None
            for t, axis in ((k_pages, 1), (v_pages, 0), (k_scale, 1),
                            (v_scale, 0))]
    return decode_attention_reference(qs, view[0], view[1], pos, coeffs,
                                      view[2], view[3])


def decode_attention_multi_reference(qs, k_cache, v_cache, pos, coeffs,
                                     k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain version of :func:`decode_attention_multi`: the first B rows
    of the cache, then an unroll over the L rows, each running
    :func:`decode_attention_reference` at its own position (the JAX
    ``decode_attention_multi_reference``). Returns (B, L, H, dv)."""
    S, B, L, H, d = qs.shape
    k_cache, v_cache = k_cache[:, :B], v_cache[:B]
    if k_scale is not None:
        k_scale, v_scale = k_scale[:, :B], v_scale[:B]
    rows = [decode_attention_reference(qs[:, :, l], k_cache, v_cache,
                                       pos[:, l], coeffs, k_scale, v_scale)
            for l in range(L)]
    return torch.stack(rows, dim=1)


def decode_attention_multi_paged_reference(qs, k_pages, v_pages, tables, pos,
                                           coeffs, k_scale=None,
                                           v_scale=None) -> torch.Tensor:
    """Plain version of :func:`decode_attention_multi_paged`: the pool
    view gathered through the table, then
    :func:`decode_attention_multi_reference`."""
    view = [gather_pool_view(t, tables, axis) if t is not None else None
            for t, axis in ((k_pages, 1), (v_pages, 0), (k_scale, 1),
                            (v_scale, 0))]
    return decode_attention_multi_reference(qs, view[0], view[1], pos, coeffs,
                                            view[2], view[3])


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------


def _refuse_grad(what, *tensors) -> None:
    if _kernels.needs_grad(*tensors):
        # the JAX kernel has no backward either; a kernel output would
        # carry no gradient path and train nothing without a word
        raise RuntimeError(
            f"{what} has no backward: call it under torch.no_grad() "
            "or on tensors that do not require grad"
        )


def _launch(what: str, qs, k, v, k_scale, v_scale, pos, tables, coeffs, *,
            B: int, L: int, M: int, n_pages: int, page_size: int) -> torch.Tensor:
    """Check the operands of one kernel call, allocate its output and
    workspace, and launch it. ``qs`` is (S, B, [L,] H, d); K/V hold
    ``n_pages`` cache rows of M tokens (``tables`` None) or pages of
    ``page_size`` tokens."""
    S, H, d = qs.shape[0], qs.shape[-2], qs.shape[-1]
    dv = v.shape[-1]
    dt = qs.dtype
    int8 = k_scale is not None
    if int8 != (v_scale is not None):
        raise ValueError(f"{what}: k_scale and v_scale must be given together")
    if int8:
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise TypeError(f"{what}: scales need an int8 K/V cache")
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError(f"{what}: K/V scales must be float32")
    elif k.dtype != dt or v.dtype != dt:
        raise TypeError(f"{what}: q, K and V must share one dtype "
                        "(or K/V int8 with scales)")
    if pos.dtype != torch.int32 or coeffs.dtype != torch.float32:
        raise TypeError(f"{what}: pos must be int32, coeffs float32")
    ops = [("q", qs), ("K", k), ("V", v), ("pos", pos), ("coeffs", coeffs)]
    if int8:
        ops += [("k_scale", k_scale), ("v_scale", v_scale)]
    if tables is not None:
        if tables.dtype != torch.int32:
            raise TypeError(f"{what}: page tables must be int32")
        ops.append(("tables", tables))
    for name, t in ops:
        if t.device != qs.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on {qs.device}")
    _, TK = decode_instance(dt, S, L, d, dv)
    code = _kernels.DTYPE_CODES[dt]
    lib = _kernels.load("decode_attention")
    n_work = lib.decode_attention_workspace(S, B, L, H, M, d, dv, TK)
    if n_work < 0:
        raise ValueError(f"{what}: shapes refused by the kernel")
    out_shape = (B, H, dv) if qs.dim() == 4 else (B, L, H, dv)
    out = torch.empty(out_shape, dtype=dt, device=qs.device)
    work = torch.empty((n_work,), dtype=torch.float32, device=qs.device)
    rc = lib.decode_attention_run(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None, pos.data_ptr(),
        tables.data_ptr() if tables is not None else None, coeffs.data_ptr(),
        out.data_ptr(), work.data_ptr(), S, B, L, H, M, d, dv, TK, n_pages,
        page_size, M // page_size, 1.0 / math.sqrt(d), code, int(int8),
        int(tables is not None), _kernels.stream_handle(qs.device),
    )
    _kernels.check(rc, what)
    return out


def _launch_rows(what: str, qs, k, v, k_scale, v_scale, pos, tables, coeffs,
                 **shape) -> torch.Tensor:
    """:func:`_launch` for ``qs`` (S, B, L, H, d) in the passes of
    :func:`verify_passes`. A pass past the first copies its rows of
    ``qs`` and ``pos`` into contiguous tensors (a few KB) and the C
    launcher runs unchanged on them; the passes' (B, l1 - l0, H, dv)
    outputs are joined along the rows."""
    outs = [_launch(what, qs[:, :, l0:l1].contiguous(), k, v, k_scale, v_scale,
                    pos[:, l0:l1].contiguous(), tables, coeffs, L=l1 - l0,
                    **shape)
            for l0, l1 in verify_passes(qs.shape[2])]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _count(fn, k_scale) -> None:
    fn.launches += 1
    if k_scale is not None:
        fn.int8_launches += 1


def _shapes_agree(what, ok: bool, **shapes) -> None:
    if not ok:
        raise ValueError(f"{what}: shapes disagree: " + ", ".join(
            f"{k} {tuple(v.shape) if v is not None else None}"
            for k, v in shapes.items()))


def _scales_agree(k, v, k_scale, v_scale) -> bool:
    return k_scale is None or (k_scale.shape == k.shape[:-1]
                               and v_scale is not None
                               and v_scale.shape == v.shape[:-1])


def decode_attention(qs: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     coeffs: torch.Tensor, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused single-query multi-stream attention over the contiguous
    slot pool. ``qs`` (S, B, H, d) post-RoPE queries, ``k_cache``
    (S, B, H, M, d), ``v_cache`` (B, H, M, dv), float or int8 with
    ``k_scale`` (S, B, H, M) / ``v_scale`` (B, H, M) fp32, ``pos`` (B,)
    int32 absolute positions, ``coeffs`` (S, H) fp32. Returns (B, H, dv)
    in the query dtype."""
    what = "decode_attention"
    _refuse_grad(what, qs, k_cache, v_cache, coeffs)
    if qs.device.type == "cpu":
        return decode_attention_reference(qs, k_cache, v_cache, pos, coeffs,
                                          k_scale, v_scale)
    _kernels.require_cuda(qs, what)
    S, B, H, M, d = k_cache.shape
    _shapes_agree(what, qs.shape == (S, B, H, d)
                  and v_cache.shape[:3] == (B, H, M) and pos.shape == (B,)
                  and coeffs.shape == (S, H)
                  and _scales_agree(k_cache, v_cache, k_scale, v_scale),
                  q=qs, K=k_cache, V=v_cache, pos=pos, coeffs=coeffs,
                  k_scale=k_scale, v_scale=v_scale)
    out = _launch(what, qs, k_cache, v_cache, k_scale, v_scale, pos, None,
                  coeffs, B=B, L=1, M=M, n_pages=B, page_size=M)
    _count(decode_attention, k_scale)
    return out


def decode_attention_paged(qs: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_tables: torch.Tensor,
                           pos: torch.Tensor, coeffs: torch.Tensor, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`decode_attention` through a page table: ``k_pages``
    (S, P, H, ps, d), ``v_pages`` (P, H, ps, dv) (int8 scales
    (S, P, H, ps) / (P, H, ps)), ``page_tables`` (B, M / ps) int32
    physical page of each logical page of each slot."""
    what = "decode_attention_paged"
    _refuse_grad(what, qs, k_pages, v_pages, coeffs)
    if qs.device.type == "cpu":
        return decode_attention_paged_reference(qs, k_pages, v_pages, page_tables,
                                                pos, coeffs, k_scale, v_scale)
    _kernels.require_cuda(qs, what)
    S, P, H, ps, d = k_pages.shape
    B, pp = page_tables.shape
    _shapes_agree(what, qs.shape == (S, B, H, d)
                  and v_pages.shape[:3] == (P, H, ps) and pos.shape == (B,)
                  and coeffs.shape == (S, H)
                  and _scales_agree(k_pages, v_pages, k_scale, v_scale),
                  q=qs, K=k_pages, V=v_pages, tables=page_tables, pos=pos,
                  coeffs=coeffs)
    out = _launch(what, qs, k_pages, v_pages, k_scale, v_scale, pos,
                  page_tables, coeffs, B=B, L=1, M=pp * ps, n_pages=P,
                  page_size=ps)
    _count(decode_attention_paged, k_scale)
    return out


def decode_attention_multi(qs: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: torch.Tensor,
                           coeffs: torch.Tensor, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L query rows per slot (the verify step): ``qs`` (S, B, L, H, d),
    ``k_cache`` (S, R, H, M, d) and ``v_cache`` (R, H, M, dv) with
    R >= B (rows past B are never read), ``pos`` (B, L) int32, row (b, l)
    seeing ``m <= pos[b, l]``. Returns (B, L, H, dv)."""
    what = "decode_attention_multi"
    _refuse_grad(what, qs, k_cache, v_cache, coeffs)
    if qs.device.type == "cpu":
        return decode_attention_multi_reference(qs, k_cache, v_cache, pos, coeffs,
                                                k_scale, v_scale)
    _kernels.require_cuda(qs, what)
    S, B, L, H, d = qs.shape
    R, M = k_cache.shape[1], k_cache.shape[3]
    _shapes_agree(what, k_cache.shape == (S, R, H, M, d) and R >= B
                  and v_cache.shape[:3] == (R, H, M) and pos.shape == (B, L)
                  and coeffs.shape == (S, H)
                  and _scales_agree(k_cache, v_cache, k_scale, v_scale),
                  q=qs, K=k_cache, V=v_cache, pos=pos, coeffs=coeffs)
    out = _launch_rows(what, qs, k_cache, v_cache, k_scale, v_scale, pos, None,
                       coeffs, B=B, M=M, n_pages=R, page_size=M)
    _count(decode_attention_multi, k_scale)
    return out


def decode_attention_multi_paged(qs: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, page_tables: torch.Tensor,
                                 pos: torch.Tensor, coeffs: torch.Tensor, *,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """:func:`decode_attention_multi` through a page table (the paged
    verify step). Returns (B, L, H, dv)."""
    what = "decode_attention_multi_paged"
    _refuse_grad(what, qs, k_pages, v_pages, coeffs)
    if qs.device.type == "cpu":
        return decode_attention_multi_paged_reference(
            qs, k_pages, v_pages, page_tables, pos, coeffs, k_scale, v_scale)
    _kernels.require_cuda(qs, what)
    S, B, L, H, d = qs.shape
    P, ps = k_pages.shape[1], k_pages.shape[3]
    pp = page_tables.shape[1]
    _shapes_agree(what, k_pages.shape == (S, P, H, ps, d)
                  and page_tables.shape == (B, pp)
                  and v_pages.shape[:3] == (P, H, ps) and pos.shape == (B, L)
                  and coeffs.shape == (S, H)
                  and _scales_agree(k_pages, v_pages, k_scale, v_scale),
                  q=qs, K=k_pages, V=v_pages, tables=page_tables, pos=pos,
                  coeffs=coeffs)
    out = _launch_rows(what, qs, k_pages, v_pages, k_scale, v_scale, pos,
                       page_tables, coeffs, B=B, M=pp * ps, n_pages=P,
                       page_size=ps)
    _count(decode_attention_multi_paged, k_scale)
    return out


for _fn in (decode_attention, decode_attention_paged, decode_attention_multi,
            decode_attention_multi_paged):
    _fn.launches = 0
    _fn.int8_launches = 0
del _fn
