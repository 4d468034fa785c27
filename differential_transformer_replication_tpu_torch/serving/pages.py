"""Paged KV-cache pool with radix-tree shared-prefix reuse (a copy of
the JAX package's serving/pages.py, which imports no JAX).

- **Fixed-size pages.** Device KV state lives in one pool of
  ``total_pages`` pages of ``page_size`` tokens each
  (models/decode.py:``init_cache_paged``). A slot's logical ring of
  ``block_size`` tokens maps onto physical pages through a per-slot
  PAGE TABLE row — ``(num_slots, pages_per_slot)`` int32. Page 0 is the
  reserved TRASH page: unallocated logical pages and inactive rows'
  decode writes land there, so the decode step needs no masking.
- **Host-only bookkeeping** under ONE lock (``self._lock``): admission
  planning, refcounts, the radix tree and eviction. Device copies a plan
  requires (copy-on-write forks) are returned as ``(src_page,
  dst_page)`` pairs; the engine applies them before its next pool call.
- **Radix-tree prefix cache.** Retired prompts donate their KV pages to
  a refcounted radix tree keyed on prompt token ids, one node per page.
  A new request SHARES fully-matching pages (prefill skips them) and
  FORKS copy-on-write at a partial-page boundary. Matches are capped at
  ``len(prompt) - 1`` so at least one prompt token is recomputed — its
  logits seed the first sampled token.
- **Admission keys on free pages, not slots.** :meth:`plan_admission`
  reserves the request's worst-case private pages up front, so a
  mid-decode allocation never fails; unreferenced cached prefixes are
  LRU-evicted to satisfy a reservation; when even eviction cannot, the
  request waits (FCFS). A request that can never fit raises the typed
  :class:`PagePoolExhaustedError` (HTTP 503 ``page_pool_exhausted``).

The host-tier hooks (``tier``, demotions, promotions, ``plan_resume``)
and the migration probes (``probe_prefix``, ``chain_pages``) are kept as
in the JAX package; the engine passes its tier (serving/host_tier.py)
when ``ServingConfig.host_tier_bytes > 0``. Byte accounting is
int8-aware (:func:`page_bytes`).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


class PagePoolExhaustedError(RuntimeError):
    """The page pool cannot satisfy an allocation. Typed and RETRIABLE
    by default (the pool drains as requests retire and cached prefixes
    evict — a client that backs off lands on a drained pool); a request
    whose worst case exceeds the whole pool can never fit and carries
    ``retriable = False``. HTTP maps this to the 503 shed path with a
    machine-readable ``page_pool_exhausted`` code."""

    retriable = True


@dataclass
class Admission:
    """One planned admission: how much prefill the prefix cache covers,
    the device copies the engine must apply (COW forks), and the
    host-tier pages to promote. ``cached_len`` counts DEVICE-resident
    tokens plus every planned promotion; ``device_cached`` counts only
    the device-resident part — when a promotion fails mid-apply the
    engine truncates its effective cached length back toward
    ``device_cached`` (recompute fallback, never garbage KV)."""

    cached_len: int  # prompt tokens covered, promotions included
    copies: List[Tuple[int, int]] = field(default_factory=list)
    hit: bool = False
    # host-tier promotions: (dst physical page, TierEntry) per promoted
    # full page, in prompt order starting at device_cached. The payload
    # was fetched (and checksum-verified) at plan time; the engine
    # re-verifies at injection and degrades to recompute on mismatch.
    promotes: List[Tuple[int, object]] = field(default_factory=list)
    device_cached: int = 0  # tokens already resident in HBM


class _Node:
    """One cached page: ``key`` is the token tuple it covers (length ==
    ``filled``; < page_size for a partial tail page), ``page`` the
    physical page id, ``refs`` the number of slots currently sharing
    it. Children are keyed by their OWN token tuples."""

    __slots__ = ("key", "page", "filled", "children", "refs",
                 "last_use", "parent")

    def __init__(self, key: tuple, page: int, parent: "_Node",
                 clock: int):
        self.key = key
        self.page = page
        self.filled = len(key)
        self.children: Dict[tuple, "_Node"] = {}
        self.refs = 0
        self.last_use = clock
        self.parent = parent


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def page_bytes(cfg, page_size: int) -> int:
    """HBM bytes one physical page holds across ALL layers, int8-aware
    (int8 K/V values plus the fp32 per-vector scale planes). Pure
    arithmetic over the ModelConfig."""
    S = {"control": 1, "diff": 2, "ndiff": cfg.n_terms}[cfg.model]
    H, d, dv = cfg.n_head, cfg.head_size, cfg.value_size
    store = cfg.kv_cache_dtype
    if store == "int8":
        per_layer = (
            S * H * page_size * d          # k int8
            + H * page_size * dv           # v int8
            + S * H * page_size * 4        # k_scale fp32
            + H * page_size * 4            # v_scale fp32
        )
    else:
        b = _DTYPE_BYTES["bfloat16" if store == "bf16"
                         else cfg.compute_dtype]
        per_layer = (S * H * page_size * d + H * page_size * dv) * b
    return per_layer * cfg.n_layer


class PagePool:
    """Host-side page allocator + radix prefix cache (module docstring).

    All mutable state is guarded by ``self._lock``: the engine thread
    plans/releases while /health handlers read :meth:`stats`
    concurrently. Nothing blocking ever runs under the lock."""

    TRASH = 0  # reserved physical page: unallocated / inactive writes
    # observation window for the page drain-rate estimate behind
    # PagePoolExhaustedError's Retry-After (estimated_drain_s)
    DRAIN_WINDOW_S = 30.0

    def __init__(self, *, page_size: int, pages_per_slot: int,
                 num_slots: int, total_pages: int,
                 prefix_cache: bool = True, tier=None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if total_pages < pages_per_slot + 2:
            raise ValueError(
                f"total_pages ({total_pages}) must hold at least one "
                f"max-length request plus the trash page "
                f"({pages_per_slot + 1} + 1)"
            )
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.num_slots = num_slots
        self.total_pages = total_pages
        self.capacity = total_pages - 1  # page 0 is the trash page
        self.prefix_cache = prefix_cache
        # optional host-RAM page tier (serving/host_tier.py): evicted
        # full radix pages demote there instead of vanishing, and
        # admission planning consults it past the device match. Lock
        # order is PagePool._lock -> HostTier._lock: the tier never
        # calls back into the pool.
        self._tier = tier
        self._lock = threading.Lock()
        self._clock = 0
        self._force_exhausted = False
        # import here to keep module import light; np is host-side only
        import numpy as np

        self._np = np
        with self._lock:
            self._reset_locked()

    # -- lifecycle ----------------------------------------------------

    def _reset_locked(self) -> None:
        np = self._np
        self._free: List[int] = list(range(1, self.total_pages))
        self._tables = np.zeros(
            (self.num_slots, self.pages_per_slot), np.int32
        )
        self._slot_private: List[List[int]] = [
            [] for _ in range(self.num_slots)
        ]
        self._slot_nodes: List[List[_Node]] = [
            [] for _ in range(self.num_slots)
        ]
        self._root = _Node((), self.TRASH, None, 0)
        self._nodes: List[_Node] = []
        # demotion plans awaiting the engine: (full token prefix, page)
        # per evicted full page. The engine drains this IMMEDIATELY
        # after every planning call — before applying copies/promotes
        # and before any prefill — so the page's device bytes are still
        # the evicted prefix when captured. A pool reset discards them
        # (the device data is untrusted after a crash).
        self._pending_demotions: List[Tuple[tuple, int]] = []
        # recent page-free events (monotonic timestamp, count) — the
        # observed drain throughput behind estimated_drain_s(), which
        # turns PagePoolExhaustedError's Retry-After into a measure of
        # actual pool drain time instead of a static queue bound
        if not hasattr(self, "_freed_log"):
            self._freed_log: List[Tuple[float, int]] = []
        # monotonic counters (prometheus semantics) survive reset —
        # a crash-rebuild must not zero the fleet's hit-rate series
        for name in ("hits", "misses", "evictions", "cow_forks",
                     "tier_hits"):
            if not hasattr(self, "_" + name):
                setattr(self, "_" + name, 0)

    def reset(self) -> None:
        """Drop every table, reservation and cached prefix; every page
        returns to the free list. The crash-recovery path
        (``ServingEngine.reset_after_crash``): a poisoned cached prefix
        (``prefix_corrupt`` fault) trips the finite-logits guard, and
        the supervised restart lands here — the poisoned pages are
        evicted wholesale instead of ever serving garbage tokens."""
        with self._lock:
            self._reset_locked()

    def force_exhaust(self) -> None:
        """Test hook: the next admission plan raises
        :class:`PagePoolExhaustedError` regardless of free pages, proving
        the typed-shed path (HTTP 503) end to end."""
        with self._lock:
            self._force_exhausted = True

    # -- sizing -------------------------------------------------------

    def pages_needed(self, prompt_len: int, max_new: int) -> int:
        """Worst-case PRIVATE pages a request may hold (no sharing)."""
        M = self.pages_per_slot * self.page_size
        total = min(prompt_len + max_new, M)
        return -(-total // self.page_size)

    # -- admission ----------------------------------------------------

    def plan_admission(self, slot: int, prompt: Sequence[int],
                       max_new: int) -> Optional[Admission]:
        """Reserve everything the request will ever write, consulting
        the radix cache first. Returns None when the pool is too full
        right now (the scheduler keeps the request queued, FCFS);
        raises :class:`PagePoolExhaustedError` when the request can
        NEVER fit or the ``page_exhaust`` fault is armed. On success
        the slot's page-table row is live and ``Admission.copies``
        lists the fork copies the engine must apply before its next
        pool call."""
        with self._lock:
            if self._force_exhausted:
                self._force_exhausted = False
                raise PagePoolExhaustedError(
                    "page pool exhausted (fault-injected); retry later"
                )
            ps = self.page_size
            M = self.pages_per_slot * ps
            total = min(len(prompt) + max_new, M)
            total_pages = -(-total // ps)
            if total_pages > self.capacity:
                err = PagePoolExhaustedError(
                    f"request needs {total_pages} pages but the pool "
                    f"holds {self.capacity}; raise kv_pool_pages or "
                    "lower max_new_tokens"
                )
                err.retriable = False
                raise err
            rolls = len(prompt) + max_new > M
            full: List[_Node] = []
            fork: Optional[Tuple[_Node, int]] = None
            matched = 0
            if self.prefix_cache and not rolls:
                full, fork, matched = self._match_locked(prompt)
            device_cached = len(full) * ps
            # host-tier extension: where the device walk ended, keep
            # matching FULL pages against demoted prefixes. Payloads
            # are fetched (and checksum-verified) NOW, under the pool
            # lock (pool -> tier order, GL601), so a later tier
            # eviction cannot tear this plan. A tier hit supersedes a
            # partial COW fork at the same logical page — a full page
            # strictly dominates a partial one.
            tier_entries: List[object] = []
            if (self._tier is not None and self.prefix_cache
                    and not rolls):
                j = len(full)
                while (j + 1) * ps <= len(prompt) - 1:
                    ent = self._tier.get(tuple(prompt[:(j + 1) * ps]))
                    if ent is None:
                        break
                    tier_entries.append(ent)
                    j += 1
                if tier_entries:
                    fork = None
                    matched = j * ps
                    self._tier_hits += 1
            # pin the matched chain before eviction runs: a refs==0
            # cached node we are about to share must not be evicted to
            # satisfy our own reservation
            self._clock += 1
            for n in full:
                n.refs += 1
                n.last_use = self._clock
            if fork is not None:
                fork[0].refs += 1
                fork[0].last_use = self._clock
            need = total_pages - len(full)
            pages = self._take_pages_locked(need)
            if fork is not None:
                # the fork source is COPIED, not shared: unpin. The
                # engine applies the copy before any further pool call,
                # so the source cannot be evicted-and-reused first.
                fork[0].refs -= 1
            if pages is None:
                for n in full:
                    n.refs -= 1
                return None
            row = self._np.zeros(self.pages_per_slot, self._np.int32)
            for j, n in enumerate(full):
                row[j] = n.page
            for j, pg in zip(range(len(full), total_pages), pages):
                row[j] = pg
            self._tables[slot] = row
            self._slot_nodes[slot] = full
            self._slot_private[slot] = list(pages)
            copies: List[Tuple[int, int]] = []
            if fork is not None:
                copies.append((fork[0].page, pages[0]))
                self._cow_forks += 1
            # promoted pages land on the slot's FIRST private pages
            # (logical indices len(full)..): injected there they are
            # ordinary private prefix KV, donated back to the radix
            # tree at release like any prefilled page
            promotes = [
                (pages[t], ent) for t, ent in enumerate(tier_entries)
            ]
            if matched > 0:
                self._hits += 1
            else:
                self._misses += 1
            return Admission(cached_len=matched, copies=copies,
                             hit=matched > 0, promotes=promotes,
                             device_cached=device_cached)

    def _match_locked(self, prompt: Sequence[int]):
        """Longest cached prefix of ``prompt``, capped at
        ``len(prompt) - 1``: (fully-shared nodes, optional
        (node, tokens) partial fork, matched token count)."""
        ps = self.page_size
        limit = len(prompt) - 1
        node = self._root
        full: List[_Node] = []
        i = 0
        while limit - i > 0:
            rem = limit - i
            key = tuple(prompt[i:i + ps])
            child = node.children.get(key)
            if (child is not None and child.filled == ps
                    and rem >= ps):
                full.append(child)
                node = child
                i += ps
                continue
            # partial-page boundary: the best common prefix of any
            # child page is usable via a COW fork (K/V at position p
            # depends only on tokens <= p, so a prefix of a cached
            # page is valid K/V even when the tails diverge)
            best, best_t = None, 0
            for c in node.children.values():
                t = min(_common_prefix(c.key, prompt[i:i + c.filled]),
                        rem)
                if t > best_t:
                    best, best_t = c, t
            if best is not None:
                return full, (best, best_t), i + best_t
            break
        return full, None, i

    def _take_pages_locked(self, n: int) -> Optional[List[int]]:
        while len(self._free) < n:
            if not self._evict_one_locked():
                return None
        return [self._free.pop() for _ in range(n)]

    def _evict_one_locked(self) -> bool:
        """Free the least-recently-used unreferenced LEAF of the radix
        tree (interior nodes are pinned by their children: evicting a
        middle page would orphan the chain below it). The linear scan
        is deliberate: the node count is bounded by the page pool
        (hundreds, not thousands) and eviction only runs when an
        admission is already short on pages — simplicity beats an
        index here until profiles say otherwise."""
        victim = None
        for node in self._nodes:
            if node.refs == 0 and not node.children:
                if victim is None or node.last_use < victim.last_use:
                    victim = node
        if victim is None:
            return False
        if self._tier is not None and victim.filled == self.page_size:
            # demote instead of forget: plan a host capture of the
            # evicted FULL page (partial tails are rare — one per
            # prompt — and stay plain evictions). The HBM page is
            # freed either way; the engine captures its still-intact
            # bytes when it drains the plan, before any reuse writes.
            self._pending_demotions.append(
                (self._node_prefix(victim), victim.page)
            )
        del victim.parent.children[victim.key]
        self._nodes.remove(victim)
        self._free.append(victim.page)
        self._note_freed_locked(1)
        self._evictions += 1
        return True

    @staticmethod
    def _node_prefix(node: _Node) -> tuple:
        """The full token prefix a node's page covers (root -> node key
        concatenation) — the host tier's lookup key."""
        parts = []
        while node is not None and node.key:
            parts.append(node.key)
            node = node.parent
        out: List[int] = []
        for key in reversed(parts):
            out.extend(key)
        return tuple(out)

    def _note_freed_locked(self, n: int) -> None:
        """Record page-free events for the drain-rate estimate; the
        log is pruned to the observation window on every append."""
        now = time.monotonic()
        self._freed_log.append((now, n))
        cutoff = now - self.DRAIN_WINDOW_S
        while self._freed_log and self._freed_log[0][0] < cutoff:
            self._freed_log.pop(0)

    def plan_resume(self, slot: int,
                    total_pages: int) -> Optional[List[int]]:
        """Reserve PRIVATE pages for a preempted request swapping back
        in: no radix matching — the request's full KV image (prompt
        AND generated tokens) is injected from its host-tier stash, so
        every page is privately owned from the start. Returns the
        allocated pages in logical order, or None when the pool cannot
        free enough right now (the request stays queued; the priority
        scheduler may preempt a lower class to make room)."""
        with self._lock:
            pages = self._take_pages_locked(total_pages)
            if pages is None:
                return None
            row = self._np.zeros(self.pages_per_slot, self._np.int32)
            for j, pg in enumerate(pages):
                row[j] = pg
            self._tables[slot] = row
            self._slot_nodes[slot] = []
            self._slot_private[slot] = list(pages)
            return pages

    def probe_prefix(self, prompt: Sequence[int]) -> int:
        """How many LEADING FULL PAGES of ``prompt`` this pool's radix
        tree holds on device — the migration dedup probe
        (the JAX package's serving/migrate.py): the source replica skips shipping pages
        the destination can copy device-locally. Read-only (no
        refcount, no eviction) and conservative: the chain is
        re-resolved under the lock at import time and a miss there
        degrades to a typed import failure, never garbage KV."""
        with self._lock:
            full, _fork, _matched = self._match_locked(prompt)
            return len(full)

    def chain_pages(self, prompt: Sequence[int],
                    n_pages: int) -> Optional[List[int]]:
        """Physical page ids of the first ``n_pages`` full-page radix
        nodes covering ``prompt``, or None when the chain is no longer
        fully cached (evicted between the dedup probe and the import —
        the race is closed by failing typed, not by pinning). Bumps
        each node's LRU clock; the caller (engine thread) must read the
        pages' device bytes before its next pool planning call, the
        same single-thread invariant COW forks rely on."""
        with self._lock:
            ps = self.page_size
            node = self._root
            out: List[int] = []
            for i in range(n_pages):
                key = tuple(prompt[i * ps:(i + 1) * ps])
                child = (
                    node.children.get(key) if len(key) == ps else None
                )
                if child is None or child.filled != ps:
                    return None
                self._clock += 1
                child.last_use = self._clock
                out.append(child.page)
                node = child
            return out

    def take_demotions(self) -> List[Tuple[tuple, int]]:
        """Drain the pending demotion plans (prefix key, freed page).
        The engine MUST call this immediately after EVERY planning call
        (plan_admission / plan_resume, success or not) and capture the
        named pages' device bytes before applying any copy, promote or
        prefill — freed pages are only ever handed back out by later
        planning calls on the same single engine thread, so the bytes
        are still the evicted prefix at capture time."""
        with self._lock:
            out, self._pending_demotions = self._pending_demotions, []
            return out

    def estimated_drain_s(self, pages_needed: int) -> Optional[float]:
        """Seconds until ``pages_needed`` pages drain at the observed
        free rate (evictions + releases over the last DRAIN_WINDOW_S)
        — the Retry-After a shed request should back off for. None
        when nothing freed recently (no basis for an estimate; callers
        fall back to their static default)."""
        with self._lock:
            if not self._freed_log:
                return None
            now = time.monotonic()
            cutoff = now - self.DRAIN_WINDOW_S
            freed = sum(n for t, n in self._freed_log if t >= cutoff)
            if freed <= 0:
                return None
            oldest = max(self._freed_log[0][0], cutoff)
            elapsed = max(now - oldest, 1e-3)
            rate = freed / elapsed
            return max(pages_needed, 1) / rate

    # -- release / cache insertion ------------------------------------

    def release(self, slot: int, prompt: Sequence[int],
                cacheable: bool) -> None:
        """Return a retiring slot's pages. Shared nodes are
        dereferenced; with ``cacheable`` (prompt fully prefilled, ring
        never rolled) the prompt's private pages are DONATED to the
        radix tree — full pages as shared nodes, the partial tail page
        as a forkable partial node — and only the decode-only pages go
        back to the free list."""
        with self._lock:
            self._clock += 1
            for n in self._slot_nodes[slot]:
                n.refs -= 1
                n.last_use = self._clock
            shared_full = len(self._slot_nodes[slot])
            private = list(self._slot_private[slot])
            row = self._tables[slot].copy()
            self._tables[slot] = self.TRASH
            self._slot_nodes[slot] = []
            self._slot_private[slot] = []
            donated: List[int] = []
            if cacheable and self.prefix_cache and len(prompt) > 0:
                donated = self._insert_locked(prompt, row, shared_full)
            freed = 0
            for pg in private:
                if pg not in donated:
                    self._free.append(pg)
                    freed += 1
            if freed:
                self._note_freed_locked(freed)

    def _insert_locked(self, prompt: Sequence[int], row,
                       shared_full: int) -> List[int]:
        """Donate the slot's prompt pages into the tree; returns the
        page ids the tree now owns. Pages duplicating an existing node
        are NOT donated (the caller frees them) — the tree stays
        canonical when identical prompts retire concurrently."""
        ps = self.page_size
        donated: List[int] = []
        node = self._root
        n_full = len(prompt) // ps
        for j in range(n_full):
            key = tuple(prompt[j * ps:(j + 1) * ps])
            child = node.children.get(key)
            if child is not None and child.filled == ps:
                node = child
                continue
            if j < shared_full:
                # the row held a shared page here but the node chain
                # diverged meanwhile (evicted + re-cached differently);
                # we do not own this page — stop donating
                break
            self._clock += 1
            child = _Node(key, int(row[j]), node, self._clock)
            node.children[key] = child
            self._nodes.append(child)
            donated.append(int(row[j]))
            node = child
        tail = tuple(prompt[n_full * ps:])
        if tail and n_full >= shared_full:
            if tail not in node.children:
                self._clock += 1
                child = _Node(tail, int(row[n_full]), node, self._clock)
                node.children[tail] = child
                self._nodes.append(child)
                donated.append(int(row[n_full]))
        return donated

    # -- queries (engine hot path + telemetry) ------------------------

    def tables(self):
        """Snapshot of the full page-table array (num_slots,
        pages_per_slot) int32 — what rides into the jitted decode step
        each iteration."""
        with self._lock:
            return self._tables.copy()

    def table_row(self, slot: int):
        with self._lock:
            return self._tables[slot].copy()

    def cached_pages(self) -> List[int]:
        """Physical pages currently owned by the radix tree (the
        ``prefix_corrupt`` fault poisons one of these)."""
        with self._lock:
            return [n.page for n in self._nodes]

    def stats(self) -> dict:
        with self._lock:
            return {
                "total": self.capacity,
                "free": len(self._free),
                "cached": len(self._nodes),
                "cow_forks_total": self._cow_forks,
                "hits_total": self._hits,
                "misses_total": self._misses,
                "evictions_total": self._evictions,
                "tier_hits_total": self._tier_hits,
                "page_size": self.page_size,
                "pages_per_slot": self.pages_per_slot,
            }
