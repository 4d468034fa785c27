"""Inverted dropout and the port's seed derivation.

Counterpart of ``differential_transformer_replication_tpu/ops/dropout.py``
(residual/FFN dropout, control.py:77,103): identity at rate 0 or
without a generator (eval). The masks come from an explicit
``torch.Generator``, so they cannot equal ``jax.random.bernoulli``'s;
the attention-probability masks do match JAX, given the same seed words
(ops/flash.py's counter hash).

JAX derives its keys with ``split``/``fold_in``; the port carries plain
integer seeds instead and derives them with :func:`fold_seed`, a 64-bit
mix on the host (no device work, no sync), and makes a generator from a
seed only where a mask is drawn.
"""

from __future__ import annotations

from typing import Optional

import torch

_M64 = (1 << 64) - 1


def fold_seed(seed: int, i: int) -> int:
    """A seed derived from ``seed`` and the index ``i`` (the counterpart of
    ``jax.random.fold_in``): splitmix64 of the pair, below 2^63."""
    x = (seed * 0x9E3779B97F4A7C15 + (i + 1) * 0xD1B54A32D192ED03) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) >> 1


def generator(seed: Optional[int], device) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed`` (None for None)."""
    if seed is None:
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate). ``gen`` lies on x's device."""
    if rate <= 0.0 or gen is None:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
