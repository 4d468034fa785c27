"""Merged-head causal attention, plain PyTorch: the dense multi-stream
form every family computes (copy of the JAX package's ops/attention.py,
without dropout).

Shapes ``(B, T, H, d)``; scores in fp32 with scale ``1/sqrt(d)``, the
causal mask filled with -inf before an fp32 softmax, the stream combine
on the fp32 probabilities, and ONE product with V in V's dtype. The
token-major kernels (ops/flash.py) compute the same function with the
combine after each stream's PV product, so in bf16 the two differ by
the rounding of p.
"""

from __future__ import annotations

from typing import Optional

import torch


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """Lower-triangular keep-mask (True = keep)."""
    return torch.ones(seq_len, seq_len, dtype=torch.bool, device=device).tril()


def masked_softmax(scores: torch.Tensor,
                   mask: Optional[torch.Tensor]) -> torch.Tensor:
    scores = scores.to(torch.float32)
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    return torch.softmax(scores, dim=-1)


def _probs(q, k, mask):
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bthd,bshd->bhts", q, k) * scale
    return masked_softmax(scores, mask)


def vanilla_attention(q, k, v, *, mask=None) -> torch.Tensor:
    """Standard causal attention, all heads at once: (B, T, H, d)."""
    probs = _probs(q, k, mask)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)


def diff_attention(q1, k1, q2, k2, v, lam, *, mask=None) -> torch.Tensor:
    """``att1 - lam * att2`` then one product with V (B, T, H, 2d)."""
    att1 = _probs(q1, k1, mask)
    att2 = _probs(q2, k2, mask)
    diff = att1 - lam[None, :, None, None] * att2
    return torch.einsum("bhts,bshd->bthd", diff.to(v.dtype), v)


def ndiff_attention(qs, ks, v, lams, signs, *, mask=None) -> torch.Tensor:
    """``sum_s sign_s * lambda_s * att_s`` then one product with V; qs/ks
    (n, B, T, H, d), lams (n, H), signs (n,)."""
    scale = 1.0 / (qs.shape[-1] ** 0.5)
    scores = torch.einsum("nbthd,nbshd->nbhts", qs, ks) * scale
    probs = masked_softmax(scores, mask)
    coeff = signs[:, None] * lams
    diff = torch.einsum("nh,nbhts->bhts", coeff.to(torch.float32), probs)
    return torch.einsum("bhts,bshd->bthd", diff.to(v.dtype), v)
