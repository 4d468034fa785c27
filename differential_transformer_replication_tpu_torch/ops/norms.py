"""Normalization layers: LayerNorm over the last axis with BIASED
variance, ``eps`` inside the square root and a division (not rsqrt).
The reference's GroupLayerNorm is a full-width LayerNorm over the head
concat (not a per-head group norm), so it is the same function."""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    c = xf - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    normed = c / torch.sqrt(var + eps)
    return (normed * weight.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def group_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The reference's GroupLayerNorm: a full-width LayerNorm over the
    concatenated head outputs."""
    return layer_norm(x, weight, bias, eps=eps)
