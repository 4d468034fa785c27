"""Row-wise bounds that a kernel's result is held to against its plain
version (``chip_smoke.py`` and the kernel tests).

A single bound scaled by a tensor's largest |value| is blind where the
values are small: under causal attention the largest gradients sit in
the first few query rows and keys, so a kernel that got every later row
wrong could pass it. Here each row (a vector along the last axis) is held
to its own scale: ``|got - ref| <= rel * scale_row + floor * max|ref|``,
``scale_row = max|ref_row|`` unless given. The floor covers rows whose
value is itself rounding noise (a first query row's dq, where
``dP - delta`` cancels).

bf16: a kernel and its plain version round p, ds and the stream-combined
map at the same points, from fp32 values summed in another order, so a
rounding can flip; a flip moves a term by 2^-8 of itself, and the flips
of a row add up to at most 2^-8 of the sum of its terms' magnitudes,
which for these sums is about the row's own magnitude; the final cast
adds one bf16 step (2^-7 of the row's largest value). ``BF16_ROW`` =
2^-6 holds both; ``BF16_FLOOR`` = 2^-10 of the tensor's max sits well
below the magnitude of the last rows at T = 8192 (about 1% of the max).

It also counts the work of an attention call (:func:`attention_work`),
from which ``chip_smoke.py`` and ``train/attention_bench.py`` compute a
kernel's bound: the least time the card could take for the same work.
"""

from __future__ import annotations

import torch

BF16_ROW, BF16_FLOOR = 2.0 ** -6, 2.0 ** -10
FP32_ROW, FP32_FLOOR = 1e-4, 1e-5         # gradients
FP32_FWD_ROW, FP32_FWD_FLOOR = 1e-5, 1e-6  # forward outputs


def row_ratio(got: torch.Tensor, ref: torch.Tensor, rel: float, floor: float,
              scale: torch.Tensor | None = None) -> float:
    """The worst row's error over its bound (<= 1 passes): rows are the
    vectors along the last axis; ``scale`` (one value per row, default
    max|ref_row|) times ``rel`` plus ``floor`` times max|ref|."""
    w = ref.shape[-1]
    g = got.detach().float().reshape(-1, w)
    r = ref.detach().float().reshape(-1, w)
    err = (g - r).abs().amax(dim=-1)
    sc = r.abs().amax(dim=-1) if scale is None else scale.detach().float().reshape(-1)
    bound = rel * sc + floor * float(r.abs().max())
    return float((err / bound.clamp_min(1e-30)).max())


def grad_ratio(got: torch.Tensor, ref: torch.Tensor) -> float:
    """:func:`row_ratio` of a backward result at its dtype's bounds."""
    if ref.dtype == torch.float32:
        return row_ratio(got, ref, FP32_ROW, FP32_FLOOR)
    return row_ratio(got, ref, BF16_ROW, BF16_FLOOR)


def attention_fwd_ratios(out, o_all, r_out, r_oall, coeffs_bh) -> tuple:
    """(out ratio, o_all ratio) of a multi-stream attention forward: o_all
    (BH, S, T, dv) rows against their own scale; out (BH, T, dv) rows
    against sum_s |c_s| max|o_s row|, the most the combination can hold,
    so a flip in any stream's map is covered where the streams cancel.
    ``coeffs_bh`` is (BH, S)."""
    if r_out.dtype == torch.float32:
        rel, floor = FP32_FWD_ROW, FP32_FWD_FLOOR
    else:
        rel, floor = BF16_ROW, BF16_FLOOR
    o_rows = r_oall.detach().float().abs().amax(dim=-1)  # (BH, S, T)
    scale = (o_rows * coeffs_bh.detach().float().abs()[:, :, None]).sum(dim=1)
    return (row_ratio(out, r_out, rel, floor, scale),
            row_ratio(o_all, r_oall, rel, floor))


# ---------------------------------------------------------------------------
# the work of an attention call, for its bound
# ---------------------------------------------------------------------------

# kind -> (bytes of each query row's inputs, of each key row's inputs, of
# each row's outputs, operations per visible pair), as functions of (S, d,
# dv, es): the forward with the stream combine (out beside the residuals
# o_all, lse), the factored backward's kernels (dq; dk/dv; all three in
# one, as the fused and token-major backward), and the ring chunk's forms
# (no combine; one cotangent per stream). Query-row inputs: q, g, lse,
# delta; key-row inputs: k, v
_WORK = {
    # q, k, v in; out, o_all, lse out
    "fwd": (lambda S, d, dv, es: S * d * es,
            lambda S, d, dv, es: (S * d + dv) * es,
            lambda S, d, dv, es: dv * es + S * (dv * es + 4),
            lambda S, d, dv: S * (2 * d + 2 * dv)),
    "chunk_fwd": (lambda S, d, dv, es: S * d * es,
                  lambda S, d, dv, es: (S * d + dv) * es,
                  lambda S, d, dv, es: S * (dv * es + 4),
                  lambda S, d, dv: S * (2 * d + 2 * dv)),
    # q, k, v, g, lse, delta in; dq out. g V^T once, then per stream
    # Q K^T and dS K
    "dq": (lambda S, d, dv, es: (S * d + dv) * es + 8 * S,
           lambda S, d, dv, es: (S * d + dv) * es,
           lambda S, d, dv, es: S * d * es,
           lambda S, d, dv: 2 * dv + 4 * S * d),
    # ... dk, dv out: g V^T and P^T g once, Q K^T and dS^T Q per stream
    "dkv": (lambda S, d, dv, es: (S * d + dv) * es + 8 * S,
            lambda S, d, dv, es: (S * d + dv) * es,
            lambda S, d, dv, es: (S * d + dv) * es,
            lambda S, d, dv: 4 * dv + 4 * S * d),
    # ... dq, dk, dv out
    "bwd": (lambda S, d, dv, es: (S * d + dv) * es + 8 * S,
            lambda S, d, dv, es: (S * d + dv) * es,
            lambda S, d, dv, es: (2 * S * d + dv) * es,
            lambda S, d, dv: 4 * dv + 6 * S * d),
    # per-stream cotangents (S of them): g_s V^T per stream
    "chunk_dq": (lambda S, d, dv, es: S * (d * es + dv * es + 8),
                 lambda S, d, dv, es: (S * d + dv) * es,
                 lambda S, d, dv, es: S * d * es,
                 lambda S, d, dv: S * (4 * d + 2 * dv)),
    "chunk_dkv": (lambda S, d, dv, es: S * (d * es + dv * es + 8),
                  lambda S, d, dv, es: (S * d + dv) * es,
                  lambda S, d, dv, es: (S * d + dv) * es,
                  lambda S, d, dv: S * (4 * d + 4 * dv)),
}
ATTENTION_KINDS = tuple(_WORK)


def visible_pairs(T: int, off: int = 0) -> int:
    """The (row, column) pairs of a T x T block with column c visible to
    row r iff c <= r + off: T (T + 1) / 2 at off 0, T^2 from off T - 1 on,
    0 from off -T on. Row r sees clamp(r + off + 1, 0, T) columns."""
    a = off + 1
    lo, hi = min(T, max(0, -a)), min(T, max(0, T - a))  # rows r + a <= 0; r + a < T
    # rows lo .. hi-1 see r + a columns, rows from hi on see all T
    partial = (hi - lo) * a + (lo + hi - 1) * (hi - lo) // 2
    return partial + (T - hi) * T


def attention_work(B: int, H: int, S: int, T: int, d: int, dv: int,
                   off: int = 0, kind: str = "fwd", es: int = 2) -> tuple:
    """(visible pairs, bytes, operations) of one multi-stream attention
    call over B*H heads of T rows, ``es`` bytes an element: the pairs a
    causal offset ``off`` leaves visible, summed over the heads; the bytes
    it must move (lse and delta fp32): each input element that the result
    depends on read once, so the query-row inputs of the rows that see a
    key and the key-row inputs of the keys that a row sees (as many:
    clamp(T + off, 0, T), none from off -T on), and each output written
    once; the operations of its products on the visible pairs (2 per
    multiply-add). ``kind`` is one of :data:`ATTENTION_KINDS`."""
    q_bytes, k_bytes, out_bytes, pair_ops = _WORK[kind]
    pairs = B * H * visible_pairs(T, off)
    seen = min(T, max(0, T + off))
    nbytes = B * H * (seen * (q_bytes(S, d, dv, es) + k_bytes(S, d, dv, es))
                      + T * out_bytes(S, d, dv, es))
    return pairs, nbytes, pairs * pair_ops(S, d, dv)
