"""Host-RAM KV page tier: graceful degradation under HBM page pressure.

A copy of the JAX package's serving/host_tier.py (which imports no JAX),
with page images held as host torch tensors.

The paged pool (serving/pages.py) has one pressure valve — LRU eviction
of unreferenced radix leaves — and eviction is PERMANENT: the prefix's
KV is gone and the next request that needs it pays a full recompute.
This module adds the second tier: evicted pages DEMOTE into host memory
here instead of vanishing, and a later admission that matches a demoted
prefix PROMOTES it back with a host->device copy — a copy, never a
recompute.

Two kinds of entry share one byte budget (``budget_bytes``):

- **Cached prefixes** (:meth:`put` / :meth:`get`), keyed by the full
  token prefix a page covers. LRU-evicted when the budget is exceeded
  — the tier is a cache; losing an entry costs a recompute, never
  correctness.
- **Stashes** (:meth:`stash` / :meth:`unstash`), keyed by an opaque
  tag (the engine uses request ids): the page images of a PREEMPTED
  request mid-decode. Stashes are byte-accounted but NEVER evicted —
  they are correctness state, not cache — so a burst of preemptions
  may overshoot the budget (cached entries are evicted first to make
  room; the overshoot is visible on the ``bytes`` gauge).

Every payload is checksummed (CRC32 over the raw leaf bytes) at
insertion and verified at retrieval: a torn or corrupted host copy is
detected and counted (``corrupt_total``), surfaces as a MISS, and the
engine degrades to recompute — never a garbage token (the
``page_swap_corrupt`` fault in utils/faults.py drills exactly this).

Payloads are opaque to this module: per-layer dicts of host arrays (one
physical page's K/V leaves, models/decode.py:``extract_cache_page``),
torch tensors or numpy arrays. Their checksum covers the leaves' raw
bytes — a bf16 leaf's two-byte values as they lie in device memory — so
one page image has one fingerprint in either package and on the wire
(serving/migrate.py).

Lock order: PagePool._lock -> HostTier._lock. The pool consults the
tier while planning an admission (under its own lock); the tier NEVER
calls back into the pool.
"""

from __future__ import annotations

import threading
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional

import torch


def leaf_bytes(leaf) -> bytes:
    """A host leaf's raw C-order bytes: a numpy array's ``tobytes()``, a
    torch tensor's through a uint8 view (numpy has no bfloat16, so a
    bf16 leaf's bytes are taken without a numpy dtype of its own)."""
    if isinstance(leaf, torch.Tensor):
        flat = leaf.detach().contiguous().reshape(-1)
        return flat.view(torch.uint8).numpy().tobytes()
    return leaf.tobytes()


def payload_nbytes(payload: List[dict]) -> int:
    """Host bytes of one page payload (per-layer leaf dicts)."""
    return sum(arr.nbytes for layer in payload for arr in layer.values())


def payload_checksum(payload: List[dict]) -> int:
    """CRC32 over every leaf's raw bytes, in canonical (layer, sorted
    key) order — the torn-copy detector both tiers of the hierarchy
    verify against."""
    crc = 0
    for layer in payload:
        for key in sorted(layer):
            crc = zlib.crc32(leaf_bytes(layer[key]), crc)
    return crc


class TierEntry:
    """One stored page image: the payload, its byte size, and the
    CRC32 stamped at insertion (verified at every retrieval)."""

    __slots__ = ("payload", "nbytes", "checksum")

    def __init__(self, payload: List[dict]):
        self.payload = payload
        self.nbytes = payload_nbytes(payload)
        self.checksum = payload_checksum(payload)

    def verify(self) -> bool:
        return payload_checksum(self.payload) == self.checksum


class HostTier:
    """Byte-budgeted host-RAM page store (module docstring).

    All mutable state is guarded by ``self._lock``: the engine thread
    demotes/promotes while /health handlers read :meth:`stats`
    concurrently. Nothing blocking ever runs under the lock — payload
    copies happen in the caller."""

    def __init__(self, *, budget_bytes: int):
        if budget_bytes < 1:
            raise ValueError(
                f"budget_bytes must be >= 1, got {budget_bytes}"
            )
        self.budget_bytes = budget_bytes
        self._lock = threading.Lock()
        with self._lock:
            self._entries: "OrderedDict[tuple, TierEntry]" = OrderedDict()
            self._stashes: Dict[object, List[TierEntry]] = {}
            self._cached_bytes = 0
            self._stash_bytes = 0
            self._hits = 0
            self._misses = 0
            self._evictions = 0
            self._corrupt = 0
            self._rejected = 0

    # -- cached prefixes ----------------------------------------------

    def put(self, key: tuple, payload: List[dict]) -> bool:
        """Demote one page image under ``key`` (the full token prefix
        it covers). LRU-evicts older cached entries to fit the budget;
        returns False (counted ``rejected_total``) when the payload
        cannot fit even with every cached entry evicted — stashes are
        pinned and never make way for a cache insert."""
        ent = TierEntry(payload)
        with self._lock:
            if ent.nbytes + self._stash_bytes > self.budget_bytes:
                self._rejected += 1
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._cached_bytes -= old.nbytes
            self._evict_until_locked(ent.nbytes)
            self._entries[key] = ent
            self._cached_bytes += ent.nbytes
            return True

    def get(self, key: tuple) -> Optional[TierEntry]:
        """The cached entry for ``key``, LRU-refreshed — or None on a
        miss. A checksum mismatch (torn/corrupted host copy) drops the
        entry, counts ``corrupt_total``, and reads as a miss: the
        caller recomputes, it never injects garbage KV."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self._misses += 1
                return None
            if not ent.verify():
                del self._entries[key]
                self._cached_bytes -= ent.nbytes
                self._corrupt += 1
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            return ent

    def _evict_until_locked(self, incoming: int) -> None:
        while (self._cached_bytes + self._stash_bytes + incoming
               > self.budget_bytes and self._entries):
            _, old = self._entries.popitem(last=False)
            self._cached_bytes -= old.nbytes
            self._evictions += 1

    # -- preemption stashes -------------------------------------------

    def stash(self, tag, payloads: List[List[dict]]) -> None:
        """Pin a preempted request's page images under ``tag``. Never
        refused and never evicted — this is the request's decode state,
        not a cache; cached entries are evicted to make room, and a
        stash burst may overshoot the budget (visible on the gauges)."""
        ents = [TierEntry(p) for p in payloads]
        nbytes = sum(e.nbytes for e in ents)
        with self._lock:
            old = self._stashes.pop(tag, None)
            if old is not None:
                self._stash_bytes -= sum(e.nbytes for e in old)
            self._evict_until_locked(nbytes)
            self._stashes[tag] = ents
            self._stash_bytes += nbytes

    def unstash(self, tag) -> Optional[List[TierEntry]]:
        """Pop (and return) the stash under ``tag``; None when absent.
        The caller verifies each entry's checksum at injection time —
        a mismatch there degrades to a full restart, bit-exact under
        the per-request draw seeds (serving/engine.py:draw_seed)."""
        with self._lock:
            ents = self._stashes.pop(tag, None)
            if ents is not None:
                self._stash_bytes -= sum(e.nbytes for e in ents)
            return ents

    def drop_stash(self, tag) -> None:
        """Discard a stash (cancelled/expired/crashed request) so its
        pinned bytes return to the budget."""
        with self._lock:
            ents = self._stashes.pop(tag, None)
            if ents is not None:
                self._stash_bytes -= sum(e.nbytes for e in ents)

    def note_corrupt(self, n: int = 1) -> None:
        """Count a corruption the CALLER detected (stash checksum
        verified at injection time, outside the tier's lock)."""
        with self._lock:
            self._corrupt += n

    # -- lifecycle ----------------------------------------------------

    def clear_cache(self) -> None:
        """Drop every CACHED entry, keep stashes. The crash-recovery
        path: after an engine crash every cached prefix is untrusted
        (a poisoned device page may have been demoted here), but
        stashes remain valid — they hold host copies of a preempted
        request's state, and preempted requests survive a crash in the
        preserved queue. Monotonic counters survive."""
        with self._lock:
            self._entries.clear()
            self._cached_bytes = 0

    # -- telemetry ----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "budget_bytes": self.budget_bytes,
                "bytes": self._cached_bytes + self._stash_bytes,
                "cached_bytes": self._cached_bytes,
                "stash_bytes": self._stash_bytes,
                "entries": len(self._entries),
                "stashes": len(self._stashes),
                "hits_total": self._hits,
                "misses_total": self._misses,
                "evictions_total": self._evictions,
                "corrupt_total": self._corrupt,
                "rejected_total": self._rejected,
            }
