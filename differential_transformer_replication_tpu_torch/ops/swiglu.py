"""SwiGLU activation: ``silu(x @ Wg + bg) * (x @ Wx + bx)``, weights
stored ``(in, out)`` as in the JAX package."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, b_gate: torch.Tensor,
           w_xform: torch.Tensor, b_xform: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ w_gate + b_gate)
    xform = x @ w_xform + b_xform
    return gate * xform
