"""Learnable-lambda machinery for differential attention.

Lambda is a pure function of the lambda_q/lambda_k vectors and the
static 1-based layer index. Parity quirks kept from the reference:

  - the dynamic schedule ``0.8 - 0.6*exp(-0.3*(layer_idx - 1))`` uses
    1-BASED layer indices,
  - the multi-head OUTPUT scale is a constant ``1 - 0.8 = 0.2`` at every
    layer (the reference never updates the buffer it is computed from),
  - N-term lambdas: term 0 is ``mean(exp(lq0*lk0) + init)`` (no
    subtraction); term i>0 subtracts term i-1's exponential.
"""

from __future__ import annotations

import math

import torch

OUTPUT_SCALE = 1.0 - 0.8


def lambda_init_schedule(layer_idx: int) -> float:
    """Dynamic per-layer lambda_init for a 1-based layer index.
    Layer 1 -> 0.2, 2 -> 0.3555..., 8 -> 0.7265..."""
    return 0.8 - 0.6 * math.exp(-0.3 * (float(layer_idx) - 1.0))


def diff_lambda(lambda_q1: torch.Tensor, lambda_k1: torch.Tensor,
                lambda_q2: torch.Tensor, lambda_k2: torch.Tensor,
                lambda_init: float) -> torch.Tensor:
    """Two-term lambda: the mean over the head_size axis of
    ``exp(lq1*lk1) - exp(lq2*lk2) + init``; inputs (..., d), output (...)."""
    vec = (torch.exp(lambda_q1 * lambda_k1) - torch.exp(lambda_q2 * lambda_k2)
           + lambda_init)
    return vec.mean(dim=-1)


def ndiff_lambdas(lambda_qs: torch.Tensor, lambda_ks: torch.Tensor,
                  lambda_init: float) -> torch.Tensor:
    """N-term lambdas, (n_terms, ..., d) -> (n_terms, ...): term 0 is
    ``mean(exp(lq0*lk0) + init)``; term i>0 is
    ``mean(exp(lqi*lki) - exp(lq(i-1)*lk(i-1)) + init)``."""
    e = torch.exp(lambda_qs * lambda_ks)
    prev = torch.cat([torch.zeros_like(e[:1]), e[:-1]], dim=0)
    return (e - prev + lambda_init).mean(dim=-1)


def ndiff_signs(n_terms: int, device=None) -> torch.Tensor:
    """Combination signs: the first map enters with ``+lambda_0`` (NOT
    coefficient 1), then ``-1 if i odd else +1`` for i >= 1."""
    signs = [1.0] + [(-1.0 if i % 2 else 1.0) for i in range(1, n_terms)]
    return torch.tensor(signs, dtype=torch.float32, device=device)
