"""Stride-1 window sampling over the token stream, device-resident.

Counterpart of ``differential_transformer_replication_tpu/data/sampler.py``
with the same semantics: a 90/10 contiguous train/val split of the flat
token stream; window i is ``tokens[i : i + block_size]`` with target
``tokens[i + 1 : i + block_size + 1]``; train batches draw offsets
uniformly WITH replacement from a numpy ``Generator`` (the same
``rng.integers(0, len, size=..., dtype=np.int64)`` calls as the JAX
package, so one seed gives both packages the same batches); val batches
are sequential. The token array lives on the device once and one
gather materializes a whole (B, T) batch from a batch of offsets.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def split_tokens(tokens: np.ndarray,
                 val_fraction: float = 0.1) -> Tuple[np.ndarray, np.ndarray]:
    """Contiguous 90/10 split."""
    n = int((1.0 - val_fraction) * len(tokens))
    return tokens[:n], tokens[n:]


class TokenWindows:
    """Device-resident stride-1 window dataset. Batches are int64."""

    def __init__(self, tokens: np.ndarray, block_size: int, device="cpu"):
        if len(tokens) <= block_size:
            raise ValueError(
                f"need more than block_size={block_size} tokens, got {len(tokens)}"
            )
        self.block_size = block_size
        self.tokens = torch.as_tensor(np.asarray(tokens, dtype=np.int64),
                                      device=device)
        self._span = torch.arange(block_size + 1, device=device)

    def __len__(self) -> int:
        """Number of valid windows: len(tokens) - block_size."""
        return int(self.tokens.shape[0]) - self.block_size

    def batch(self, offsets) -> dict:
        """Gather x/y windows for explicit offsets in [0, len(self))."""
        off = torch.as_tensor(np.asarray(offsets, dtype=np.int64),
                              device=self.tokens.device)
        grab = self.tokens[off[..., None] + self._span]  # (..., T + 1)
        return {"x": grab[..., :-1], "y": grab[..., 1:]}

    def random_batch(self, rng: np.random.Generator, batch_size: int) -> dict:
        offsets = rng.integers(0, len(self), size=batch_size, dtype=np.int64)
        return self.batch(offsets)

    def sequential_offsets(self, batch_index: int, batch_size: int) -> np.ndarray:
        """Offsets of the unshuffled batch k: windows [k*B, (k+1)*B),
        wrapping at the end so every batch is full."""
        if batch_size > len(self):
            raise ValueError(
                f"batch_size {batch_size} exceeds the {len(self)} available "
                f"windows (need more tokens in this split)"
            )
        start = (batch_index * batch_size) % (len(self) - batch_size + 1)
        return np.arange(start, start + batch_size)

    def sequential_batch(self, batch_index: int, batch_size: int) -> dict:
        return self.batch(self.sequential_offsets(batch_index, batch_size))

    def batches(self, offsets: np.ndarray) -> dict:
        """A stacked (n_batches, B, T) batch from (n_batches, B) offsets:
        the microbatch axis of the train step."""
        return self.batch(offsets)

    def random_batches(self, rng: np.random.Generator, batch_size: int,
                       n_batches: int) -> dict:
        offsets = rng.integers(0, len(self), size=(n_batches, batch_size),
                               dtype=np.int64)
        return self.batches(offsets)
