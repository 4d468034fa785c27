"""The multi-stream attention decomposition shared by every backend.

All three model families compute a linear combination of causal softmax
streams over one V:

    out = sum_s coeff[s, h] * softmax(Q_s K_s^T / sqrt(d)) @ V

  - control: S=1, coeff [1]
  - diff:    S=2, coeff [1, -lambda]
  - ndiff:   S=n, coeff sign_s * lambda_{s,h} (the first map is scaled
    by lambda_0, NOT 1 — the documented difference from the 2-term model)
"""

from __future__ import annotations

import torch

# finite stand-in for -inf in masked-softmax accumulators: keeps
# exp(m - m_new) NaN-free when a row has seen only masked keys
NEG_INF = -1e30


def vanilla_coeffs(n_head: int, device=None) -> torch.Tensor:
    """(1, H) of ones: a single plain softmax stream."""
    return torch.ones((1, n_head), dtype=torch.float32, device=device)


def diff_coeffs(lam: torch.Tensor) -> torch.Tensor:
    """(2, H): att1 - lambda * att2."""
    return torch.stack([torch.ones_like(lam), -lam]).to(torch.float32)


def ndiff_coeffs(lams: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """(n, H): sign_s * lambda_{s,h}."""
    return signs[:, None].to(torch.float32) * lams.to(torch.float32)
