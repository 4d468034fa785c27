"""Continuous-batching inference engine of the port (contiguous slot pool).

Counterpart of the JAX package's serving/engine.py, restricted to the
contiguous per-slot KV pool:

- **Slot-pool KV cache**: one ``init_cache(cfg, num_slots)`` pool holds
  every in-flight sequence's K/V rings. A request owns one slot row from
  admission to retirement; rows are reused WITHOUT clearing because the
  ring mask derives visibility purely from position arithmetic
  (models/decode.py) — a fresh prefill at pos=0 makes every stale key
  invisible by construction.
- **Iteration-level scheduling**: each :meth:`step` admits queued
  requests into free slots, advances prefill by a bounded token budget
  in power-of-two chunks (serving/scheduler.py), then decodes ALL active
  slots as one batched length-1 step (``forward_decode_pool``), samples,
  and emits or retires. A sequence that finishes frees its slot for the
  next iteration without stalling the rest of the batch.

Differences from the JAX engine, by design: the cache is updated in
place (prefill writes straight into its pool row; decode writes only
the active rows, where the JAX engine computes every row and masks the
merge); there is no compilation, so no shape ladder has to be pinned
(the power-of-two prefill chunks are kept for the same scheduling); and
sampling draws from a ``torch.Generator`` seeded by a pure function of
``(seed, t)`` for the request's t-th token, which cannot reproduce
``jax.random``'s stream — greedy output is the parity surface, sampled
output is deterministic per request and tested for that.

Family limits: control/ndiff roll the ring past block_size up to
``ServingConfig.max_seq_len``; the diff family's learned position table
cannot roll, so its requests are capped at
``prompt + max_new_tokens <= block_size``.

The paged KV pool, speculative decoding, the int8 KV cache, the host
tier, migration, constraints, penalties, logprobs and quality telemetry
belong to later slices: a request that asks for one is refused at
submit with a ValueError naming the field.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from differential_transformer_replication_tpu_torch.config import (
    ModelConfig,
    ServingConfig,
)
from differential_transformer_replication_tpu_torch.models import common
from differential_transformer_replication_tpu_torch.models.decode import (
    compute_dtype,
    forward_chunk,
    forward_decode_pool,
    init_cache,
)
from differential_transformer_replication_tpu_torch.serving.request import (
    Request,
    RequestOutput,
    SamplingParams,
)
from differential_transformer_replication_tpu_torch.serving.scheduler import (
    ACTIVE,
    FREE,
    Scheduler,
    Slot,
)

STAT_KEYS = (
    "iterations", "prefill_tokens", "prefill_chunks", "decode_tokens",
    "decode_steps", "completed", "cancelled", "rejected",
    "deadline_expired", "engine_restarts",
)


class EngineCrashError(RuntimeError):
    """The engine failed mid-flight (device error, non-finite logits).
    Typed and RETRIABLE: the supervised runner (serving/server.py) fails
    in-flight requests with it, rebuilds the slot pool and serves on."""

    retriable = True


class Stats(dict):
    """Engine counters: a dict (the /health JSON shape) whose increments
    and snapshots are locked, because the runner bumps ``rejected`` from
    HTTP handler threads while the engine thread bumps the rest."""

    def __init__(self, keys):
        super().__init__((k, 0) for k in keys)
        self._lock = threading.Lock()

    def inc(self, key: str, n: int = 1) -> None:
        with self._lock:
            self[key] += n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self)


def unsupported_field(p: SamplingParams) -> Optional[str]:
    """The first SamplingParams field set to something this slice does
    not serve (a later slice of the port), or None."""
    checks = (
        ("json_schema", p.json_schema is not None),
        ("regex", p.regex is not None),
        ("choices", p.choices is not None),
        ("repetition_penalty", p.repetition_penalty != 1.0),
        ("presence_penalty", p.presence_penalty != 0.0),
        ("frequency_penalty", p.frequency_penalty != 0.0),
        ("logprobs", p.logprobs != 0),
        ("draft_len", p.draft_len is not None),
        ("key_offset", p.key_offset != 0),
    )
    for name, is_set in checks:
        if is_set:
            return name
    return None


def draw_seed(seed: int, t: int) -> int:
    """Generator seed of a request's t-th token: splitmix64 of the pair,
    so the draw is a pure function of (seed, t) and neighbouring t's get
    unrelated streams."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(t) + 1) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


def sample_tokens(logits: torch.Tensor, params: Sequence[SamplingParams],
                  steps: Sequence[int]):
    """One token per row of ``logits`` (n, V) fp32. Row i samples with
    ``params[i]``: temperature <= 0 is greedy (argmax, first index on
    ties); otherwise top-k masking (values below the k-th largest go to
    -inf; 0/None = off), division by the temperature, and a Gumbel-max
    draw from a generator seeded with ``draw_seed(seed, steps[i])``.
    Returns host (tokens int64 (n,), finite-ok bool (n,)) — ``ok`` is
    over the RAW logits, so a corrupt pool or diverged params surface as
    a typed crash instead of a garbage argmax."""
    n, V = logits.shape
    ok = torch.isfinite(logits).all(dim=-1)
    tokens = torch.argmax(logits, dim=-1)
    for i, p in enumerate(params):
        if p.temperature <= 0:
            continue
        row = logits[i]
        if p.top_k:
            kth = torch.topk(row, min(p.top_k, V)).values[-1]
            row = torch.where(row < kth, torch.full_like(row, -float("inf")), row)
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(draw_seed(p.seed, steps[i]))
        u = torch.rand(V, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u))
        tokens[i] = torch.argmax(row / p.temperature + gumbel)
    return tokens.cpu(), ok.cpu()


def resolve_device(device) -> torch.device:
    """The engine's device; asking for CUDA where there is none raises
    (the port never quietly runs on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev


class ServingEngine:
    """Continuous-batching engine over one model's params.

    Drive it synchronously (``submit()`` then ``run()`` / ``generate()``)
    or one :meth:`step` at a time (the thread in serving/server.py). Not
    thread-safe by itself. ``params`` is the JAX-layout param tree (see
    params.py); the engine keeps a copy on ``device`` with the matmul
    weights cast once to the compute dtype. ``device`` defaults to
    ``cuda`` and raises when CUDA is absent.
    """

    def __init__(self, params: dict, cfg: ModelConfig,
                 serving: Optional[ServingConfig] = None, device="cuda"):
        self.device = resolve_device(device)
        self.serving = serving or ServingConfig()
        if self.serving.kv_cache_dtype:
            cfg = cfg.replace(kv_cache_dtype=self.serving.kv_cache_dtype)
        self.cfg = cfg
        self.max_total = self.serving.resolved_max_seq_len(cfg)
        self.params = common.inference_params(params, compute_dtype(cfg),
                                              self.device)
        self.cache = init_cache(cfg, self.serving.num_slots, self.device)
        self.scheduler = Scheduler(self.serving)
        self._next_id = 0
        self._seeds: dict = {}  # request_id -> sampling seed (live requests)
        # outputs of a step() that later raised: already retired, so the
        # supervisor must still deliver them (take_finished)
        self._finished_prior: List[RequestOutput] = []
        self.stats = Stats(STAT_KEYS)

    # -- submission ---------------------------------------------------

    def submit(self, prompt: Sequence[int],
               params: Optional[SamplingParams] = None,
               deadline: Optional[float] = None, **kw) -> int:
        """Queue one request; returns its request_id. ``kw`` are
        SamplingParams fields. ``deadline`` is an ABSOLUTE
        ``time.perf_counter`` timestamp (None applies
        ``ServingConfig.default_deadline_s`` when set). Raises ValueError
        when the request cannot fit the engine (family limits, vocab
        range) or asks for a feature of a later slice."""
        req = Request.make(self._next_id, prompt, params, **kw)
        bad = unsupported_field(req.params)
        if bad is not None:
            self.stats.inc("rejected")
            raise ValueError(
                f"{bad} is not supported by the port's serving engine yet"
            )
        M = self.cfg.block_size
        p = np.asarray(req.prompt, np.int64)
        if p.min() < 0 or p.max() >= self.cfg.vocab_size:
            self.stats.inc("rejected")
            raise ValueError(
                f"prompt token ids must lie in [0, {self.cfg.vocab_size})"
            )
        if self.cfg.model == "diff":
            if p.shape[0] + req.params.max_new_tokens > M:
                self.stats.inc("rejected")
                raise ValueError(
                    f"prompt ({p.shape[0]}) + max_new_tokens "
                    f"({req.params.max_new_tokens}) exceeds block_size ({M}) "
                    "and the diff family's learned absolute position table "
                    "cannot roll with a KV cache"
                )
        else:
            if p.shape[0] > M:
                p = p[-M:]  # the reference's own crop
            if p.shape[0] + req.params.max_new_tokens > self.max_total:
                self.stats.inc("rejected")
                raise ValueError(
                    f"cropped prompt ({p.shape[0]}) + max_new_tokens "
                    f"({req.params.max_new_tokens}) exceeds the engine's "
                    f"max_seq_len ({self.max_total}); build the engine with "
                    "a larger ServingConfig.max_seq_len"
                )
        now = time.perf_counter()
        if deadline is None and self.serving.default_deadline_s > 0:
            deadline = now + self.serving.default_deadline_s
        try:
            self.scheduler.submit(req, p, now, deadline or 0.0)
        except Exception:
            self.stats.inc("rejected")
            raise
        self._next_id += 1
        self._seeds[req.request_id] = req.params.seed
        return req.request_id

    def cancel(self, request_id: int) -> bool:
        """Abandon an in-flight request: dropped from the wait queue, or
        its slot retired so the KV row returns to the pool. False when
        the request is unknown or already finished."""
        if request_id not in self._seeds:
            return False
        self.scheduler.cancel(request_id)
        del self._seeds[request_id]
        self.stats.inc("cancelled")
        return True

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def queue_len(self) -> int:
        return self.scheduler.queue_len()

    # -- one engine iteration -----------------------------------------

    def step(self) -> List[RequestOutput]:
        """Deadline shed -> admit -> prefill (budgeted) -> batched
        decode. Returns the requests that finished THIS iteration."""
        if not self.scheduler.has_work():
            out, self._finished_prior = self._finished_prior, []
            return out
        finished = self._finished_prior
        now = time.perf_counter()
        for req, prompt, t_submit, _dl, _trace in self.scheduler.shed_expired(now):
            finished.append(self._expire_queued(req, prompt, t_submit, now))
        for slot in self.scheduler.expired_slots(now):
            finished.append(self._finish(slot, "deadline", now=now))
        chunks = self.scheduler.plan()
        if chunks:
            self._run_prefill(chunks, finished)
        active = self.scheduler.active_slots()
        if active:
            self._decode(active, finished)
        self.stats.inc("iterations")
        self._finished_prior = []
        return finished

    def _run_prefill(self, chunks, finished: List[RequestOutput]) -> None:
        """Run this iteration's planned prefill chunks, each straight
        into its slot's pool row; a chunk that completes its prompt
        samples the request's first token from its last position."""
        for slot, start, size in chunks:
            i = slot.index
            row = [{"k": c["k"][:, i:i + 1], "v": c["v"][i:i + 1]}
                   for c in self.cache]
            tokens = torch.as_tensor(
                slot.prompt[start:start + size], device=self.device
            )[None]
            logits, _ = forward_chunk(self.params, tokens, start, row,
                                      self.cfg, rope_len=self.max_total)
            slot.filled = start + size
            self.stats.inc("prefill_tokens", size)
            self.stats.inc("prefill_chunks")
            if slot.filled == slot.prompt_len:
                tok, ok = sample_tokens(
                    logits[0, -1:].to(torch.float32), [slot.request.params],
                    [len(slot.generated)],
                )
                if not bool(ok[0]):
                    raise EngineCrashError(
                        f"non-finite logits prefilling slot {i} (request "
                        f"{slot.request.request_id}): corrupt slot pool or "
                        "numerically diverged params"
                    )
                self._emit(slot, int(tok[0]), time.perf_counter(), finished)

    def _decode(self, active: List[Slot], finished: List[RequestOutput]) -> None:
        """One batched L=1 step over the whole pool; only the active
        rows' K/V are written and only their tokens are used."""
        B = self.serving.num_slots
        tokens = np.zeros((B,), np.int64)
        pos = np.zeros((B,), np.int32)
        for s in active:
            tokens[s.index] = s.generated[-1]
            pos[s.index] = s.prompt_len + len(s.generated) - 1
        rows = torch.as_tensor([s.index for s in active], device=self.device)
        logits, _ = forward_decode_pool(
            self.params, torch.as_tensor(tokens, device=self.device),
            torch.as_tensor(pos, device=self.device), self.cache, self.cfg,
            rope_len=self.max_total, active=rows,
        )
        toks, ok = sample_tokens(
            logits[rows].to(torch.float32),
            [s.request.params for s in active],
            [len(s.generated) for s in active],
        )
        bad = [s for s, good in zip(active, ok.tolist()) if not good]
        if bad:
            raise EngineCrashError(
                f"non-finite logits decoding slot(s) {[s.index for s in bad]} "
                f"(request(s) {[s.request.request_id for s in bad]}): "
                "corrupt slot pool or numerically diverged params"
            )
        self.stats.inc("decode_steps")
        self.stats.inc("decode_tokens", len(active))
        now = time.perf_counter()
        for s, tok in zip(active, toks.tolist()):
            self._emit(s, int(tok), now, finished)

    def _emit(self, slot: Slot, token: int, now: float,
              finished: List[RequestOutput]) -> None:
        slot.generated.append(token)
        slot.token_times.append(now)
        if len(slot.generated) == 1:
            slot.first_token_time = now
            slot.state = ACTIVE
        p = slot.request.params
        eos = (p.eos_token_id if p.eos_token_id is not None
               else self.serving.eos_token_id)
        hit_eos = eos is not None and token == eos
        stop_hit = bool(p.stop) and any(
            len(slot.generated) >= len(seq)
            and tuple(slot.generated[-len(seq):]) == seq
            for seq in p.stop
        )
        if hit_eos or stop_hit or len(slot.generated) >= p.max_new_tokens:
            finished.append(self._finish(
                slot,
                "eos" if hit_eos else ("stop_sequence" if stop_hit else "length"),
            ))

    def _finish(self, slot: Slot, reason: str,
                now: Optional[float] = None) -> RequestOutput:
        out = RequestOutput(
            request_id=slot.request.request_id,
            prompt=[int(t) for t in slot.prompt],
            tokens=list(slot.generated),
            finish_reason=reason,
            submit_time=slot.submit_time,
            first_token_time=slot.first_token_time,
            finish_time=(slot.token_times[-1] if slot.token_times
                         else (now if now is not None else time.perf_counter())),
            token_times=list(slot.token_times),
        )
        del self._seeds[slot.request.request_id]
        self.stats.inc("deadline_expired" if reason == "deadline" else "completed")
        self.scheduler.retire(slot)
        return out

    def _expire_queued(self, request, prompt, submit_time: float,
                       now: float) -> RequestOutput:
        """A request whose deadline passed while it waited for a slot."""
        self._seeds.pop(request.request_id, None)
        self.stats.inc("deadline_expired")
        return RequestOutput(
            request_id=request.request_id,
            prompt=[int(t) for t in prompt],
            tokens=[],
            finish_reason="deadline",
            submit_time=submit_time,
            first_token_time=0.0,
            finish_time=now,
        )

    # -- synchronous use ----------------------------------------------

    def take_finished(self) -> List[RequestOutput]:
        """Outputs accumulated by a :meth:`step` that raised partway
        (already retired; the supervisor must deliver them)."""
        out, self._finished_prior = self._finished_prior, []
        return out

    def run(self) -> List[RequestOutput]:
        """Drain the queue; returns every output, in completion order."""
        outs: List[RequestOutput] = []
        while self.scheduler.has_work():
            outs.extend(self.step())
        return outs

    def generate(self, prompts: Sequence[Sequence[int]],
                 params: Optional[Sequence[SamplingParams]] = None,
                 **kw) -> List[RequestOutput]:
        """Submit-all + drain; outputs in submission order. ``params``
        gives per-request SamplingParams, else ``kw`` build one shared."""
        shared = SamplingParams(**kw) if params is None else None
        ids = []
        try:
            for i, p in enumerate(prompts):
                ids.append(self.submit(p, params=shared if shared else params[i]))
        except Exception:
            for rid in ids:
                self.cancel(rid)
            raise
        by_id = {o.request_id: o for o in self.run()}
        return [by_id[i] for i in ids]

    def reset_after_crash(self) -> List[int]:
        """Rebuild device state after a failed :meth:`step`: in-flight
        requests lost their KV and are returned for the supervisor to
        fail; queued requests survive verbatim (same ids, prompts,
        deadlines, seeds). Params are never written, so the rebuilt pool
        starts from the same weights."""
        lost: List[int] = []
        for slot in self.scheduler.slots:
            if slot.state != FREE and slot.request is not None:
                lost.append(slot.request.request_id)
                self._seeds.pop(slot.request.request_id, None)
        preserved = list(self.scheduler.queue)
        self.cache = init_cache(self.cfg, self.serving.num_slots, self.device)
        self.scheduler = Scheduler(self.serving)
        self.scheduler.queue.extend(preserved)
        self.stats.inc("engine_restarts")
        return lost
