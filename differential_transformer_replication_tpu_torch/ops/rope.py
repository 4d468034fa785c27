"""Rotary position embeddings, real arithmetic.

Consecutive feature pairs ``(x[2i], x[2i+1])`` rotate together — the
EVEN/ODD-lane interleave of the reference's complex formulation, not a
half split. Frequencies are ``1 / theta**(2j/d)``; the rotation runs in
float32 and the result is cast back to the input dtype.
"""

from __future__ import annotations

import torch


def rope_cos_sin(head_dim: int, max_seq_len: int, theta: float = 10000.0,
                 device=None):
    """The (cos, sin) tables, each ``(max_seq_len, head_dim // 2)`` fp32."""
    j = torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=device)[: head_dim // 2]
    freqs = 1.0 / (theta ** (j / head_dim))
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)
    return torch.cos(angles), torch.sin(angles)


def _rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    x_even = xf[..., 0::2]
    x_odd = xf[..., 1::2]
    rot_even = x_even * c - x_odd * s
    rot_odd = x_even * s + x_odd * c
    return torch.stack([rot_even, rot_odd], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               headed: bool | None = None) -> torch.Tensor:
    """Rotate ``x``. ndim >= 4 (when ``headed`` is None) is the merged-
    head layout ``(..., T, H, d)``; otherwise ``(..., T, d)``. The tables
    ``(>=T, d//2)`` are truncated to T."""
    if headed is None:
        headed = x.dim() >= 4
    if headed:
        T = x.shape[-3]
        return _rotate(x, cos[:T][:, None, :], sin[:T][:, None, :])
    T = x.shape[-2]
    return _rotate(x, cos[:T], sin[:T])


def rope_rows(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate single-token streams at PER-ROW positions: x (S, B, H, d),
    cos/sin (B, d/2) gathered at each row's own position (the pool
    decode step, where every slot sits at its own position)."""
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :])
