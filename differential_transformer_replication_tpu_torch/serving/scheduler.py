"""Admission + iteration-level scheduling for the serving engine (a copy
of the JAX package's serving/scheduler.py, which imports no JAX).

Orca-style continuous batching: scheduling decisions are made per
ITERATION, not per request. Each call to :meth:`Scheduler.plan` (one
engine step) does two things, both FCFS:

1. **Admission** — queued requests move into FREE slots of the fixed
   pool while any are free. A request occupies exactly one slot from
   admission to retirement; the pool size never grows, so the decode
   batch shape is static and admissions never recompile.
2. **Prefill planning** — slots still prefilling advance by at most
   ``prefill_budget`` prompt tokens per iteration, split into
   descending power-of-two chunks no larger than ``prefill_chunk``.
   The budget is the fairness knob: without it, one block_size-long
   prompt would stall every decoding sequence for its whole prefill
   (the "prefill starves decode" failure mode Orca's iteration-level
   scheduling exists to fix). The power-of-two ladder bounds the set of
   chunk shapes that ever compile to log2(prefill_chunk)+1.

The scheduler is pure host-side bookkeeping — slot state, queue, stats.
Device work (the actual chunk/decode calls) lives in serving/engine.py.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from differential_transformer_replication_tpu_torch.config import ServingConfig
from differential_transformer_replication_tpu_torch.serving.request import (
    PRIORITY_CLASSES,
    PRIORITY_RANK,
    Request,
)

FREE = "free"
PREFILL = "prefill"
ACTIVE = "active"


class QueueFullError(RuntimeError):
    """Admission rejected: the wait queue is at ``max_queue_len``. The
    graceful-overload contract — callers get an immediate, retryable
    error (HTTP 503 from the server) instead of an unbounded wait."""

    retriable = True


class DeadlineExceededError(RuntimeError):
    """The request's server-side deadline expired before completion.

    Raised to the CALLER only (serving/server.py delivers it, HTTP 504);
    engine-side the request is shed at admission or retired mid-decode
    so its KV slot goes back to the pool instead of decoding for a
    client that has already given up. ``output`` carries the partial
    :class:`RequestOutput` (``finish_reason == "deadline"``; tokens
    generated before expiry, empty when shed at admission)."""

    def __init__(self, message: str, output=None):
        super().__init__(message)
        self.output = output


@dataclass
class Slot:
    """One KV-cache slot's host-side state."""

    index: int
    state: str = FREE
    request: Optional[Request] = None
    prompt: Optional[np.ndarray] = None  # cropped prompt actually run
    filled: int = 0  # prompt tokens already prefilled
    # prompt tokens whose KV the radix prefix cache already held at
    # admission (serving/pages.py): prefill starts here, and the
    # engine's queue-wait/TTFT instrumentation keys the first RUN
    # chunk on it. Always 0 on the contiguous path.
    cached_len: int = 0
    generated: List[int] = field(default_factory=list)
    admit_seq: int = -1  # admission order, for FCFS prefill within a step
    submit_time: float = 0.0
    # absolute perf_counter() deadline; 0.0 = none. The engine retires
    # the slot (reason "deadline") once now >= deadline, mid-decode.
    deadline: float = 0.0
    first_token_time: float = 0.0
    token_times: List[float] = field(default_factory=list)
    # the request's cross-process trace context
    # (obs/trace.py:TraceContext), or None when it arrived untraced —
    # pure host-side bookkeeping, stamped onto span/instant args only
    trace: Optional[object] = None
    # speculative-decoding accounting (serving/spec.py): draft tokens
    # proposed/accepted for this request so far — copied onto the
    # RequestOutput at retirement
    spec_proposed: int = 0
    spec_accepted: int = 0
    # the cropped prompt as a plain int list, built lazily by the
    # engine's proposal collector — per-element int() conversion of
    # the numpy prompt every decode iteration was measurable hot-loop
    # host cost
    prompt_ids: Optional[list] = None
    # structured decoding (serving/constrain.py): the compiled token
    # FSM (attached lazily by the engine on first hot-path touch, so
    # unconstrained slots never pay the cache lookup) and the cursor
    # into its state table, advanced host-side per emitted token.
    # fsm_state -1 is the dead-end sentinel (all-zero mask row) — only
    # the constrain_dead_end fault plants it; compiled FSMs prune dead
    # states so natural generation cannot reach one.
    constraint: Optional[object] = None
    fsm_state: int = 0
    # generated-token occurrence counts for the repetition/presence/
    # frequency penalties — a (V,) int32 histogram, allocated lazily
    # (None for requests with every penalty off)
    penalty_counts: Optional[np.ndarray] = None
    # logprob echo accumulators (SamplingParams.logprobs > 0): chosen
    # token's logprob and top-N (id, logprob) pairs per emitted token
    token_logprobs: Optional[list] = None
    top_logprobs: Optional[list] = None

    @property
    def prompt_len(self) -> int:
        return 0 if self.prompt is None else int(self.prompt.shape[0])

    def reset(self) -> None:
        self.state = FREE
        self.request = None
        self.prompt = None
        self.filled = 0
        self.cached_len = 0
        self.generated = []
        self.admit_seq = -1
        self.submit_time = 0.0
        self.deadline = 0.0
        self.first_token_time = 0.0
        self.token_times = []
        self.trace = None
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.prompt_ids = None
        self.constraint = None
        self.fsm_state = 0
        self.penalty_counts = None
        self.token_logprobs = None
        self.top_logprobs = None


def _pow2_chunk(n: int, cap: int) -> int:
    """Largest power of two <= min(n, cap); n, cap >= 1."""
    m = min(n, cap)
    return 1 << (m.bit_length() - 1)


class Scheduler:
    """FCFS queue + slot pool bookkeeping (see module docstring)."""

    def __init__(self, serving: ServingConfig, on_retire=None,
                 on_preempt=None):
        self.serving = serving
        # retirement hook: called with the slot BEFORE it resets, on
        # EVERY retire path (finish, deadline, cancel) — how the paged
        # engine returns KV pages / inserts prompts into the radix
        # cache (serving/engine.py:_release_slot_pages). None = no-op.
        self.on_retire = on_retire
        # preemption hook (serving/engine.py:_preempt_slot, set only
        # when the host tier is on): called with an ACTIVE victim slot
        # when a strictly better-ranked request is blocked on pages.
        # The engine stashes the victim's KV to the host tier, releases
        # its pages, REQUEUES it (original submit_time, so aging keeps
        # accruing) and resets the slot. None = no preemption.
        self.on_preempt = on_preempt
        self.slots = [Slot(index=i) for i in range(serving.num_slots)]
        # (request, cropped prompt, submit_time, deadline, trace) —
        # deadline is an absolute perf_counter() timestamp, 0.0 = none;
        # trace is the request's TraceContext or None
        self.queue: Deque[
            Tuple[Request, np.ndarray, float, float, Optional[object]]
        ] = deque()
        self._admit_seq = 0
        # invariant checked by tests: concurrent occupied slots never
        # exceed the pool
        self.max_concurrent = 0

    # -- submission ---------------------------------------------------

    def submit(self, request: Request, prompt: np.ndarray,
               submit_time: float, deadline: float = 0.0,
               trace: Optional[object] = None) -> None:
        """Enqueue an engine-validated (request, cropped prompt) pair.
        Raises :class:`QueueFullError` when the wait queue is at
        ``max_queue_len`` (0 = unbounded): overload must degrade into
        fast rejections, not an ever-growing queue of requests that will
        all miss their caller's deadline anyway."""
        maxq = self.serving.max_queue_len
        if maxq and len(self.queue) >= maxq:
            raise QueueFullError(
                f"admission queue full ({len(self.queue)}/{maxq} waiting, "
                f"{self.occupied()}/{len(self.slots)} slots busy); retry "
                "later"
            )
        self.queue.append((request, prompt, submit_time, deadline, trace))

    def cancel(self, request_id: int) -> bool:
        """Remove a request wherever it lives: still waiting (dropped
        from the queue) or holding a slot (the slot is retired, so its
        KV rows go back to the pool for the next admission). Returns
        whether the request was found."""
        for i, entry in enumerate(self.queue):
            if entry[0].request_id == request_id:
                del self.queue[i]
                return True
        for slot in self.slots:
            if slot.state != FREE and slot.request.request_id == request_id:
                self.retire(slot)
                return True
        return False

    # -- queries ------------------------------------------------------

    def has_work(self) -> bool:
        return bool(self.queue) or any(s.state != FREE for s in self.slots)

    def queue_len(self) -> int:
        return len(self.queue)

    def queue_depths(self) -> Dict[str, int]:
        """Waiting requests per priority class — the per-class queue
        depth EngineRunner surfaces on /health and /metrics."""
        depths = {c: 0 for c in PRIORITY_CLASSES}
        for e in self.queue:
            depths[e[0].params.priority] += 1
        return depths

    def free_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.state == FREE]

    def active_slots(self) -> List[Slot]:
        return [s for s in self.slots if s.state == ACTIVE]

    def occupied(self) -> int:
        return sum(1 for s in self.slots if s.state != FREE)

    # -- deadlines ----------------------------------------------------

    def shed_expired(self, now: float) -> List[
        Tuple[Request, np.ndarray, float, float, Optional[object]]
    ]:
        """Drop already-expired entries from the wait queue and return
        them. Admission-time shedding: a request whose deadline passed
        while it waited would burn prefill + decode iterations for a
        caller that has already given up — it never gets a slot. The
        engine converts the returned entries into ``finish_reason ==
        "deadline"`` outputs (a typed error at the caller)."""
        if not any(e[3] and now >= e[3] for e in self.queue):
            return []
        expired = [e for e in self.queue if e[3] and now >= e[3]]
        self.queue = deque(
            e for e in self.queue if not (e[3] and now >= e[3])
        )
        return expired

    def expired_slots(self, now: float) -> List[Slot]:
        """Occupied slots whose request's deadline has passed — the
        engine retires these (KV rows back to the pool) instead of
        decoding for nobody. Does not mutate; retirement is the
        engine's move (it must emit the partial output first)."""
        return [
            s for s in self.slots
            if s.state != FREE and s.deadline and now >= s.deadline
        ]

    # -- the per-iteration decision -----------------------------------

    def _effective_rank(self, priority: str, submit_time: float,
                        now: float) -> float:
        """Class rank with anti-starvation aging: every
        ``priority_aging_s`` seconds waited improves the rank by one
        class, so a starved batch request eventually outranks fresh
        high-priority traffic (bounded starvation by construction)."""
        rank = float(PRIORITY_RANK.get(priority, 1))
        aging = self.serving.priority_aging_s
        if aging > 0:
            rank -= int(max(now - submit_time, 0.0) / aging)
        return rank

    def _preempt_victim(self, blocked_rank: float,
                        now: float) -> Optional[Slot]:
        """The ACTIVE slot with the WORST effective rank, provided it
        is STRICTLY worse than the blocked request's — equal-class
        peers never preempt each other, so all-one-class traffic
        degrades exactly like the pre-priority FCFS engine."""
        worst, worst_rank = None, blocked_rank
        for s in self.slots:
            if s.state != ACTIVE:
                continue
            r = self._effective_rank(
                s.request.params.priority, s.submit_time, now
            )
            if r > worst_rank:
                worst, worst_rank = s, r
        return worst

    def plan(self, admit=None) -> List[Tuple[Slot, int, int]]:
        """Admit + plan this iteration's prefill work.

        Returns ``[(slot, start, length), ...]`` chunks (FCFS by
        admission order, budget-capped); the engine executes them in
        order and flips a slot to ACTIVE when its prompt completes.

        Admission is priority-aware: each round picks the queued
        request with the best (effective rank, queue position) — aging
        per :meth:`_effective_rank` — skipping classes at their
        ``priority_max_slots`` bound. All-normal traffic reduces
        exactly to the old FCFS order.

        ``admit`` is the paged engine's admission gate: called with
        ``(slot, queue_entry)`` for the selected request BEFORE it is
        committed, it returns the cached prefix length to skip (>= 0,
        prefill starts there), None to keep the request queued (free
        pages exhausted), or -1 when the gate consumed the entry
        itself (typed shed). On None, if a preemption hook is set and
        an ACTIVE slot ranks strictly worse than the blocked request,
        that victim is preempted (its pages stash to the host tier)
        and the gate retried; otherwise admission stops for this
        iteration — blocking preserves rank order. None gate = admit
        unconditionally (the contiguous path).
        """
        bounds = self.serving.priority_slot_bounds()
        now = time.perf_counter()
        while self.queue:
            free = [s for s in self.slots if s.state == FREE]
            if not free:
                break
            # per-class occupancy for the admission bounds; recomputed
            # each round (admissions and preemptions change it)
            occ: Dict[str, int] = {}
            for s in self.slots:
                if s.state != FREE:
                    cls = s.request.params.priority
                    occ[cls] = occ.get(cls, 0) + 1
            best_i, best_key = None, None
            for i, e in enumerate(self.queue):
                cls = e[0].params.priority
                if cls in bounds and occ.get(cls, 0) >= bounds[cls]:
                    continue
                key = (self._effective_rank(cls, e[2], now), i)
                if best_key is None or key < best_key:
                    best_i, best_key = i, key
            if best_i is None:
                break  # every waiting class is at its slot bound
            slot = free[0]
            entry = self.queue[best_i]
            cached = 0
            if admit is not None:
                verdict = admit(slot, entry)
                if verdict is None:
                    if self.on_preempt is not None:
                        victim = self._preempt_victim(best_key[0], now)
                        if victim is not None:
                            # the hook stashes KV, releases pages,
                            # requeues the victim and resets the slot;
                            # retry the gate against the freed pages
                            self.on_preempt(victim)
                            continue
                    break
                if verdict < 0:
                    del self.queue[best_i]
                    continue
                cached = verdict
            del self.queue[best_i]
            request, prompt, t_submit, deadline, trace = entry
            slot.state = PREFILL
            slot.request = request
            slot.prompt = prompt
            slot.filled = cached
            slot.cached_len = cached
            slot.generated = []
            slot.token_times = []
            slot.spec_proposed = 0
            slot.spec_accepted = 0
            slot.prompt_ids = None
            slot.constraint = None
            slot.fsm_state = 0
            slot.penalty_counts = None
            slot.token_logprobs = None
            slot.top_logprobs = None
            slot.submit_time = t_submit
            slot.deadline = deadline
            slot.trace = trace
            slot.admit_seq = self._admit_seq
            self._admit_seq += 1
        self.max_concurrent = max(self.max_concurrent, self.occupied())

        budget = self.serving.prefill_budget
        chunks: List[Tuple[Slot, int, int]] = []
        pending = sorted(
            (s for s in self.slots if s.state == PREFILL),
            key=lambda s: s.admit_seq,
        )
        for slot in pending:
            start = slot.filled
            while budget > 0 and start < slot.prompt_len:
                size = _pow2_chunk(
                    min(slot.prompt_len - start, budget),
                    self.serving.prefill_chunk,
                )
                chunks.append((slot, start, size))
                start += size
                budget -= size
            if budget <= 0:
                break
        return chunks

    # -- retirement ---------------------------------------------------

    def retire(self, slot: Slot) -> None:
        """Return a slot to the FREE pool. The KV rows need no clearing:
        the ring mask derives visibility purely from position arithmetic
        (models/decode.py:_attn_chunk), so a fresh prefill at pos=0
        masks every stale key the previous occupant left behind. The
        ``on_retire`` hook (paged engine) sees the slot first — every
        retire path (finish, deadline, cancel) releases its pages."""
        if self.on_retire is not None and slot.state != FREE:
            self.on_retire(slot)
        slot.reset()
