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
