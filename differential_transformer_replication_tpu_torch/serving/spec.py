"""Speculative-decoding drafters for the serving engine (a copy of the
JAX package's serving/spec.py, n-gram drafter only).

A drafter proposes up to k tokens per slot per iteration; the target
verifies all of them in ONE multi-row pool step
(models/decode.py:``forward_decode_spec``, serving/engine.py
``_decode_spec``) instead of k sequential decode steps. Every proposal
is verified, so a bad drafter costs throughput, never correctness:
greedy requests accept a draft token iff it equals the target's argmax
(bit-identical to non-spec greedy decoding in the exact verify mode),
sampled requests run the acceptance-ratio test (Leviathan et al. 2023).

:class:`NGramDrafter` is the drafter-free prompt-lookup fallback: a
host-side suffix map over each request's prompt + emitted tokens
proposes the continuation that followed the most recent occurrence of
the current n-gram suffix. Zero device cost. The JAX package's
``ModelDrafter`` (a small checkpoint on its own slot pool) is a later
item (ROADMAP Queue A: serving subsystems); ``ServingConfig`` refuses
``spec_mode="model"``.

Thread-safety: the drafter owns a lock — the engine thread mutates the
suffix maps while /health handlers read :meth:`NGramDrafter.stats`.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple


class DraftSlot:
    """One slot's proposal context, passed by the engine each
    iteration: the slot index, the FULL token history (cropped prompt
    + generated so far), the target position P of the last emitted
    token (history[P] is that token), and the per-slot draft cap the
    engine already clamped against max_new_tokens / the ring window /
    the request's own ``draft_len``."""

    __slots__ = ("index", "tokens", "pos", "cap")

    def __init__(self, index: int, tokens: Sequence[int], pos: int,
                 cap: int):
        self.index = index
        self.tokens = tokens
        self.pos = pos
        self.cap = cap


class NGramDrafter:
    """Prompt-lookup speculative decoding (drafter-free fallback).

    Per slot, a suffix map from every n-gram (n = ``max_n`` down to
    ``min_n``) of the request's token history to the position right
    after its most recent occurrence; a proposal is the continuation
    that followed the longest matching suffix of the current history.
    The map is built incrementally (each token indexes ``max_n`` keys),
    so per-iteration cost is O(new tokens), not O(history).
    """

    kind = "ngram"

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not (1 <= min_n <= max_n):
            raise ValueError(
                f"need 1 <= min_n <= max_n, got {min_n}..{max_n}"
            )
        self._lock = threading.Lock()
        self._proposed = 0
        self.max_n = max_n
        self.min_n = min_n
        # slot -> ({ngram tuple: (previous end, last end)},
        #          tokens indexed so far). Two ends per key because
        #          the history TAIL always matches itself at
        #          end == len(history) — the useful occurrence is the
        #          one before it.
        self._maps: Dict[int, Tuple[dict, int]] = {}

    def stats(self) -> dict:
        with self._lock:
            return {"kind": self.kind, "proposed_total": self._proposed,
                    "drafter_crashes_total": 0}

    def _index_locked(self, index: int, tokens: Sequence[int]):
        entry = self._maps.get(index)
        if entry is None or entry[1] > len(tokens):
            entry = ({}, 0)  # new occupant (slot reuse): fresh map
        smap, done = entry
        first = self.min_n if done == 0 else done + 1
        for end in range(first, len(tokens) + 1):
            for n in range(self.min_n, self.max_n + 1):
                if end - n >= 0:
                    key = tuple(tokens[end - n:end])
                    old = smap.get(key)
                    smap[key] = (old[1] if old else None, end)
        self._maps[index] = (smap, len(tokens))
        return smap

    def propose_all(self, slots: List[DraftSlot]) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        with self._lock:
            for s in slots:
                if s.cap <= 0:
                    continue
                # the engine passes history ending exactly at pos (the
                # common case) — avoid a per-iteration copy then
                hist = (
                    s.tokens if len(s.tokens) == s.pos + 1
                    else list(s.tokens[:s.pos + 1])
                )
                smap = self._index_locked(s.index, hist)
                prop: List[int] = []
                for n in range(min(self.max_n, len(hist)), self.min_n - 1,
                               -1):
                    ends = smap.get(tuple(hist[-n:]))
                    if ends is None:
                        continue
                    # the match ending AT the history tail proposes
                    # nothing (its continuation is the future); fall
                    # back to the occurrence before it
                    at = ends[1] if ends[1] < len(hist) else ends[0]
                    if at is not None:
                        prop = hist[at:at + s.cap]
                        break
                if prop:
                    out[s.index] = prop
                    self._proposed += len(prop)
        return out

    def release(self, index: int) -> None:
        """The slot retired (finish, deadline or cancel)."""
        with self._lock:
            self._maps.pop(index, None)

    def reset(self) -> None:
        """Engine crash recovery: drop every suffix map."""
        with self._lock:
            self._maps.clear()


def build_drafter(serving):
    """The configured drafter of an engine, or None with spec off.
    ``ServingConfig`` already refuses ``spec_mode="model"``."""
    if not serving.spec_enabled():
        return None
    if serving.spec_mode != "ngram":
        raise ValueError(f"unknown spec_mode {serving.spec_mode!r}")
    return NGramDrafter()
