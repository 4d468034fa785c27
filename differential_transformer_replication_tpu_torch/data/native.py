"""The epoch sampler's permutation: a seeded O(1)-memory Feistel shuffle.

A copy of the numpy half of ``differential_transformer_replication_tpu/
data/native.py``: ``permute_indices(n, seed, start, count)`` gives a
window of the seeded permutation of [0, n), and ``EpochPermutation``
streams window indices epoch after epoch, every index once per epoch and
a fresh permutation each epoch. The JAX package also builds
``native/src/data_native.cpp`` with g++ and calls it through ctypes; its
numpy path is bit-identical to that library by design (its tests assert
it), so the port keeps only the numpy path and builds no C++ library.
The same ``seed`` gives both packages the same window order.
"""

from __future__ import annotations

import numpy as np

_U64 = np.uint64


def _mix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = (x + _U64(0x9E3779B97F4A7C15)).astype(_U64)
        x = ((x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)).astype(_U64)
        x = ((x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)).astype(_U64)
        return x ^ (x >> _U64(31))


def _feistel_params(n: int):
    bits = 1
    while (1 << bits) < n and bits < 62:
        bits += 1
    half_bits = (bits + 1) // 2
    return half_bits, (1 << half_bits) - 1


def _cipher_np(x: np.ndarray, seed: int, half_bits: int, half_mask: int):
    l = x >> _U64(half_bits)
    r = x & _U64(half_mask)
    for rnd in range(4):
        f = _mix64(r ^ _U64(seed) ^ (_U64(rnd) << _U64(56))) & _U64(half_mask)
        l, r = r, l ^ f
    return (l << _U64(half_bits)) | r


def _permute_np(n: int, seed: int, start: int, count: int) -> np.ndarray:
    seed = int(_mix64(np.array(seed, _U64)))
    half_bits, half_mask = _feistel_params(n)
    x = np.arange(start, start + count, dtype=_U64)
    x = _cipher_np(x, seed, half_bits, half_mask)
    # cycle-walk stragglers back into [0, n)
    out = (x >= _U64(n))
    while out.any():
        x[out] = _cipher_np(x[out], seed, half_bits, half_mask)
        out = (x >= _U64(n))
    return x.astype(np.int64)


def permute_indices(n: int, seed: int, start: int, count: int) -> np.ndarray:
    """``sigma(start : start+count)`` for the seeded permutation sigma of
    [0, n): the epoch-exact shuffle at O(1) memory."""
    if count <= 0:
        return np.empty((0,), np.int64)
    if start + count > n:
        raise ValueError(f"window [{start}, {start + count}) exceeds domain {n}")
    return _permute_np(n, seed, start, count)


class EpochPermutation:
    """Exact epoch-shuffle semantics of a shuffled DataLoader: every
    window index appears exactly once per epoch, a fresh permutation each
    epoch, O(1) memory. ``take(count)`` streams the next ``count``
    indices, rolling epochs as needed; ``epoch`` and ``cursor`` are the
    position (the trainer sets both to fast-forward a resumed run)."""

    def __init__(self, n: int, seed: int):
        if n <= 0:
            raise ValueError("empty index domain")
        self.n = n
        self.seed = seed
        self.epoch = 0
        self.cursor = 0

    def _epoch_seed(self) -> int:
        return int(_mix64(np.array(self.seed, _U64) ^ _U64(self.epoch)))

    def take(self, count: int) -> np.ndarray:
        parts = []
        remaining = count
        while remaining > 0:
            avail = self.n - self.cursor
            grab = min(avail, remaining)
            parts.append(
                permute_indices(self.n, self._epoch_seed(), self.cursor, grab)
            )
            self.cursor += grab
            remaining -= grab
            if self.cursor == self.n:
                self.cursor = 0
                self.epoch += 1
        return np.concatenate(parts) if len(parts) > 1 else parts[0]
