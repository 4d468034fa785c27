"""Continuous-batching inference engine of the port.

Counterpart of the JAX package's serving/engine.py:

- **KV pool**: the contiguous slot pool (``init_cache(cfg, num_slots)``,
  one ring row per in-flight sequence) or, with
  ``ServingConfig.kv_page_size > 0``, the paged pool
  (``init_cache_paged``) behind a :class:`PagePool` (serving/pages.py):
  admission keys on free pages, and a radix tree of retired prompts'
  pages lets a request that shares a cached prefix skip its prefill
  (copy-on-write forks at partial pages through ``copy_cache_pages``).
  Rows and pages are reused WITHOUT clearing: the ring mask derives
  visibility purely from position arithmetic (models/decode.py). Either
  pool may store int8 K/V (``kv_cache_dtype="int8"``).
- **Iteration-level scheduling**: each :meth:`step` admits queued
  requests, advances prefill by a bounded token budget in power-of-two
  chunks (serving/scheduler.py), then decodes ALL active slots as one
  batched step, samples, and emits or retires.
- **Speculative decoding** (``spec_mode="ngram"``, serving/spec.py): when
  the drafter proposes tokens for some slot, the step is one k+1-row
  verify over the pool (``forward_decode_spec`` or its paged twin, exact
  or batched) with the accept/reject of the JAX
  ``_build_spec_step_fns._accept``: greedy rows accept draft j iff it
  equals row j-1's argmax, sampled rows run the Leviathan test and on
  rejection sample the residual. The contiguous pool then carries one
  extra trash row for the rejected rows' writes; the paged pool uses its
  trash page.

Differences from the JAX engine, by design: the cache is updated in
place (prefill writes straight into its pool row or through its page
table; decode writes only the active rows, or sends inactive rows'
writes to the trash page); there is no compilation, so no shape ladder
has to be pinned (the power-of-two prefill chunks are kept for the same
scheduling); and sampling draws from ``torch.Generator``s seeded by pure
functions of ``(seed, t)`` for the request's t-th token
(:func:`draw_seed`, and :func:`accept_seed` for the verify step's
acceptance uniforms), which cannot reproduce ``jax.random``'s stream —
greedy output is the parity surface, sampled output is deterministic
per request and tested for that.

Family limits: control/ndiff roll the ring past block_size up to
``ServingConfig.max_seq_len``; the diff family's learned position table
cannot roll, so its requests are capped at
``prompt + max_new_tokens <= block_size``.

The host tier, migration, the model drafter, constraints, penalties,
logprobs and quality telemetry belong to later slices: ``ServingConfig``
refuses the first three, and a request that asks for one of the others
is refused at submit with a ValueError naming the field.
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
from differential_transformer_replication_tpu_torch.models import (
    check_card_envelope,
    common,
)
from differential_transformer_replication_tpu_torch.models.decode import (
    KV_CACHE_BATCH_AXIS,
    compute_dtype,
    copy_cache_pages,
    forward_chunk,
    forward_decode_pool,
    forward_decode_pool_paged,
    forward_decode_spec,
    forward_decode_spec_paged,
    gather_slot_cache,
    init_cache,
    init_cache_paged,
    scatter_slot_cache,
)
from differential_transformer_replication_tpu_torch.serving.pages import (
    PagePool,
    PagePoolExhaustedError,
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
from differential_transformer_replication_tpu_torch.serving.spec import (
    DraftSlot,
    build_drafter,
)

STAT_KEYS = (
    "iterations", "prefill_tokens", "prefill_chunks", "decode_tokens",
    "decode_steps", "spec_steps", "spec_proposed", "spec_accepted",
    "completed", "cancelled", "rejected", "deadline_expired", "page_shed",
    "engine_restarts",
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


# salt distinguishing a draft position's acceptance uniform from its
# token draw: both stay pure functions of (request seed, t)
SPEC_ACCEPT_SALT = 0x9E3779B9


def accept_seed(seed: int, t: int) -> int:
    """Generator seed of the acceptance uniform of a request's t-th token
    in a verify step (the JAX package salts the token's fold_in key)."""
    return draw_seed(draw_seed(seed, t), SPEC_ACCEPT_SALT)


def _gumbel_argmax(row: torch.Tensor, temperature: float, seed: int) -> int:
    gen = torch.Generator(device=row.device)
    gen.manual_seed(seed)
    u = torch.rand(row.shape[-1], generator=gen, device=row.device)
    return int(torch.argmax(row / temperature - torch.log(-torch.log(u))))


def _top_k_mask(row: torch.Tensor, top_k: Optional[int]) -> torch.Tensor:
    """Logits below the k-th largest of their row go to -inf (0/None =
    off)."""
    if not top_k:
        return row
    kth = torch.topk(row, min(top_k, row.shape[-1]), dim=-1).values[..., -1:]
    return torch.where(row < kth, torch.full_like(row, -float("inf")), row)


def spec_accept(logits: torch.Tensor, drafts: Sequence[Sequence[int]],
                params: Sequence[SamplingParams], steps: Sequence[int]):
    """Accept/reject of one verify step, per slot (the JAX
    ``_build_spec_step_fns._accept`` without the logit pipeline).
    ``logits`` (n, L, V) fp32 of the n active slots; ``drafts[i]`` the
    slot's drafted tokens (dl <= L - 1 of them); ``steps[i]`` the index t
    of the token row 0 produces. Greedy rows accept draft j iff it
    equals row j's argmax. Sampled rows accept draft j with probability
    p_j(d_j) under the top-k / temperature-processed target, with a
    uniform from :func:`accept_seed`, and draw the correction from row a
    (the first rejected row, or the bonus row) with the rejected token
    masked out — so a row with no draft reduces to :func:`sample_tokens`
    exactly. Returns host lists (emitted tokens per slot, finite-ok per
    slot over its used rows)."""
    pred = torch.argmax(logits, dim=-1).cpu().tolist()
    finite = torch.isfinite(logits).all(dim=-1).cpu().tolist()
    out, ok = [], []
    for i, (d, p, t0) in enumerate(zip(drafts, params, steps)):
        dl = len(d)
        ok.append(all(finite[i][:dl + 1]))
        if p.temperature <= 0:
            a = 0
            while a < dl and pred[i][a] == d[a]:
                a += 1
            out.append(list(d[:a]) + [pred[i][a]])
            continue
        rows = _top_k_mask(logits[i, :dl + 1], p.top_k)
        a = 0
        if dl:
            probs = torch.softmax(rows[:dl] / p.temperature, dim=-1)
            p_d = probs[torch.arange(dl, device=rows.device),
                        torch.as_tensor(d, device=rows.device)].cpu().tolist()
            for j in range(dl):
                gen = torch.Generator(device=rows.device)
                gen.manual_seed(accept_seed(p.seed, t0 + j))
                u = float(torch.rand(1, generator=gen, device=rows.device))
                if u >= p_d[j]:
                    break
                a += 1
        corr = rows[a]
        if a < dl:  # the residual: the target with the rejected token out
            corr = corr.clone()
            corr[d[a]] = -float("inf")
        out.append(list(d[:a]) + [_gumbel_argmax(corr, p.temperature,
                                                 draw_seed(p.seed, t0 + a))])
    return out, ok


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
    ok = torch.isfinite(logits).all(dim=-1)
    tokens = torch.argmax(logits, dim=-1)
    for i, p in enumerate(params):
        if p.temperature > 0:
            tokens[i] = _gumbel_argmax(_top_k_mask(logits[i], p.top_k),
                                       p.temperature, draw_seed(p.seed, steps[i]))
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
        if self.device.type == "cuda":
            check_card_envelope(cfg, "serve")
        self.cfg = cfg
        self.max_total = self.serving.resolved_max_seq_len(cfg)
        self.params = common.inference_params(params, compute_dtype(cfg),
                                              self.device)
        # the paged pool (serving/pages.py): KV in fixed pages behind
        # per-slot page tables, admission on free pages, radix prefixes
        self.pages: Optional[PagePool] = None
        if self.serving.paged():
            ps = self.serving.kv_page_size
            self.pages = PagePool(
                page_size=ps, pages_per_slot=cfg.block_size // ps,
                num_slots=self.serving.num_slots,
                total_pages=self.serving.resolved_pool_pages(cfg) + 1,
                prefix_cache=self.serving.prefix_cache,
            )
        # speculative decoding: the contiguous pool carries one extra
        # TRASH row (index num_slots) for rejected rows' writes; the
        # paged pool's trash page does that job
        self.drafter = build_drafter(self.serving)
        self._spec_k = self.serving.spec_draft_len if self.drafter else 0
        self._rows = self.serving.num_slots + (
            1 if self._spec_k and self.pages is None else 0)
        self.cache = self._new_cache()
        self.scheduler = self._new_scheduler()
        self._next_id = 0
        self._seeds: dict = {}  # request_id -> sampling seed (live requests)
        # outputs of a step() that later raised: already retired, so the
        # supervisor must still deliver them (take_finished)
        self._finished_prior: List[RequestOutput] = []
        self.stats = Stats(STAT_KEYS)

    def _new_cache(self) -> list:
        if self.pages is not None:
            return init_cache_paged(self.cfg, self.pages.total_pages,
                                    self.serving.kv_page_size, self.device)
        return init_cache(self.cfg, self._rows, self.device)

    def _new_scheduler(self) -> Scheduler:
        hook = self._on_retire if (self.pages or self.drafter) else None
        return Scheduler(self.serving, on_retire=hook)

    # -- submission ---------------------------------------------------

    def submit(self, prompt: Sequence[int],
               params: Optional[SamplingParams] = None,
               deadline: Optional[float] = None, **kw) -> int:
        """Queue one request; returns its request_id. ``kw`` are
        SamplingParams fields. ``deadline`` is an ABSOLUTE
        ``time.perf_counter`` timestamp (None applies
        ``ServingConfig.default_deadline_s`` when set). Raises ValueError
        when the request cannot fit the engine (family limits, vocab
        range) or asks for a feature of a later slice, and a
        non-retriable PagePoolExhaustedError when its worst case exceeds
        the whole page pool."""
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
        if self.pages is not None:
            need = self.pages.pages_needed(int(p.shape[0]),
                                           req.params.max_new_tokens)
            if need > self.pages.capacity:
                self.stats.inc("rejected")
                err = PagePoolExhaustedError(
                    f"request needs {need} KV pages but the pool holds "
                    f"{self.pages.capacity}; raise "
                    "ServingConfig.kv_pool_pages or lower max_new_tokens"
                )
                err.retriable = False
                raise err
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
        decode or verify. Returns the requests that finished THIS
        iteration."""
        if not self.scheduler.has_work():
            out, self._finished_prior = self._finished_prior, []
            return out
        finished = self._finished_prior
        now = time.perf_counter()
        for req, prompt, t_submit, _dl, _trace in self.scheduler.shed_expired(now):
            finished.append(self._expire_queued(req, prompt, t_submit, now))
        for slot in self.scheduler.expired_slots(now):
            finished.append(self._finish(slot, "deadline", now=now))
        admit = None
        if self.pages is not None:
            admit = lambda slot, entry: self._admit_paged(slot, entry, finished)
        chunks = self.scheduler.plan(admit=admit)
        if chunks:
            self._run_prefill(chunks, finished)
        active = self.scheduler.active_slots()
        proposals = self._collect_proposals(active) if active and self.drafter else {}
        if proposals:
            self._decode_spec(active, proposals, finished)
        elif active:
            self._decode(active, finished)
        self.stats.inc("iterations")
        self._finished_prior = []
        return finished

    def _table_row(self, index: int) -> torch.Tensor:
        return torch.as_tensor(self.pages.table_row(index), device=self.device)

    def _run_prefill(self, chunks, finished: List[RequestOutput]) -> None:
        """Run this iteration's planned prefill chunks, each into its
        slot's pool row (contiguous) or through its page-table row
        (paged: gather the ring view, run the chunk, scatter it back); a
        chunk that completes its prompt samples the request's first
        token from its last position."""
        for slot, start, size in chunks:
            i = slot.index
            if self.pages is not None:
                table = self._table_row(i)
                row = gather_slot_cache(self.cache, table)
            else:
                row = [{key: (t[:, i:i + 1] if KV_CACHE_BATCH_AXIS[key]
                              else t[i:i + 1]) for key, t in c.items()}
                       for c in self.cache]
            tokens = torch.as_tensor(
                slot.prompt[start:start + size], device=self.device
            )[None]
            logits, _ = forward_chunk(self.params, tokens, start, row,
                                      self.cfg, rope_len=self.max_total)
            if self.pages is not None:
                scatter_slot_cache(self.cache, row, table)
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

    @staticmethod
    def _pos0(s: Slot) -> int:
        """Position of the slot's last emitted token."""
        return s.prompt_len + len(s.generated) - 1

    def _write_page(self, tables: np.ndarray, index: int, pos: int) -> int:
        """Physical page a row of slot ``index`` at ``pos`` writes."""
        M, ps = self.cfg.block_size, self.serving.kv_page_size
        return int(tables[index, (pos % M) // ps])

    def _check_finite(self, bad: List[Slot], what: str) -> None:
        if bad:
            raise EngineCrashError(
                f"non-finite logits {what} slot(s) {[s.index for s in bad]} "
                f"(request(s) {[s.request.request_id for s in bad]}): "
                "corrupt slot pool or numerically diverged params"
            )

    def _decode(self, active: List[Slot], finished: List[RequestOutput]) -> None:
        """One batched L=1 step over the whole pool; only the active
        rows' K/V land in live rows/pages and only their tokens are
        used."""
        B = self._rows
        tokens = np.zeros((B,), np.int64)
        pos = np.zeros((B,), np.int32)
        for s in active:
            tokens[s.index] = s.generated[-1]
            pos[s.index] = self._pos0(s)
        rows = torch.as_tensor([s.index for s in active], device=self.device)
        tok_t = torch.as_tensor(tokens, device=self.device)
        pos_t = torch.as_tensor(pos, device=self.device)
        if self.pages is not None:
            tables = self.pages.tables()
            write = np.zeros((B,), np.int32)  # inactive rows: the trash page
            for s in active:
                write[s.index] = self._write_page(tables, s.index, int(pos[s.index]))
            logits, _ = forward_decode_pool_paged(
                self.params, tok_t, pos_t, self.cache,
                torch.as_tensor(tables, device=self.device),
                torch.as_tensor(write, device=self.device), self.cfg,
                rope_len=self.max_total)
        else:
            logits, _ = forward_decode_pool(
                self.params, tok_t, pos_t, self.cache, self.cfg,
                rope_len=self.max_total, active=rows)
        toks, ok = sample_tokens(
            logits[rows].to(torch.float32),
            [s.request.params for s in active],
            [len(s.generated) for s in active],
        )
        self._check_finite([s for s, good in zip(active, ok.tolist()) if not good],
                           "decoding")
        self.stats.inc("decode_steps")
        self.stats.inc("decode_tokens", len(active))
        now = time.perf_counter()
        for s, tok in zip(active, toks.tolist()):
            self._emit(s, int(tok), now, finished)

    # -- speculative decoding (serving/spec.py) ------------------------

    def _collect_proposals(self, active: List[Slot]) -> dict:
        """Ask the drafter for up to k tokens per eligible active slot.
        Each slot's cap keeps the verify block inside the request's
        max_new_tokens (the corrected token must still fit), its
        ``draft_len`` and the ring window (the verify writes positions
        pos..pos+cap; a rolled-over write would evict keys a rejected row
        still needs)."""
        infos = []
        for s in active:
            p = s.request.params
            cap = self._spec_k
            if p.draft_len is not None:
                cap = min(cap, p.draft_len)
            pos0 = self._pos0(s)
            cap = min(cap, p.max_new_tokens - len(s.generated) - 1,
                      self.cfg.block_size - 1 - pos0)
            if cap <= 0:
                continue
            if s.prompt_ids is None:  # once per admission
                s.prompt_ids = [int(t) for t in s.prompt]
            infos.append(DraftSlot(s.index, s.prompt_ids + s.generated, pos0, cap))
        return self.drafter.propose_all(infos) if infos else {}

    def _decode_spec(self, active: List[Slot], proposals: dict,
                     finished: List[RequestOutput]) -> None:
        """One k+1-row verify step over the whole pool: row 0 of each
        slot is its last emitted token, rows 1..dl its drafts; rows past
        the draft length (and every row of an inactive slot) write to
        the trash row/page. Then accept/reject per slot and emit each
        slot's accepted prefix plus its corrected token."""
        B = self.serving.num_slots
        L = self._spec_k + 1
        tokens = np.zeros((B, L), np.int64)
        pos = np.zeros((B, L), np.int32)
        targets = np.zeros((B, L), np.int32)  # paged: the trash page 0
        if self.pages is None:
            targets[:] = B  # contiguous: the trash row
        else:
            tables = self.pages.tables()
        drafts = []
        for s in active:
            d = proposals.get(s.index, [])
            dl = len(d)
            drafts.append(d)
            p0 = self._pos0(s)
            tokens[s.index, 0] = s.generated[-1]
            tokens[s.index, 1:dl + 1] = d
            pos[s.index, :] = p0
            pos[s.index, :dl + 1] = p0 + np.arange(dl + 1)
            for j in range(dl + 1):
                targets[s.index, j] = (
                    s.index if self.pages is None
                    else self._write_page(tables, s.index, p0 + j))
        dev = self.device
        args = (self.params, torch.as_tensor(tokens, device=dev),
                torch.as_tensor(pos, device=dev), self.cache)
        batched = self.serving.spec_verify == "batched"
        if self.pages is not None:
            logits, _ = forward_decode_spec_paged(
                *args, torch.as_tensor(tables, device=dev),
                torch.as_tensor(targets, device=dev), self.cfg,
                rope_len=self.max_total, batched=batched)
        else:
            logits, _ = forward_decode_spec(
                *args, self.cfg, torch.as_tensor(targets, device=dev),
                rope_len=self.max_total, batched=batched)
        rows = torch.as_tensor([s.index for s in active], device=dev)
        emitted, ok = spec_accept(logits[rows], drafts,
                                  [s.request.params for s in active],
                                  [len(s.generated) for s in active])
        self._check_finite([s for s, good in zip(active, ok) if not good],
                           "verifying")
        self.stats.inc("decode_steps")
        self.stats.inc("spec_steps")
        now = time.perf_counter()
        n_out = 0
        for s, d, toks in zip(active, drafts, emitted):
            if d:
                s.spec_proposed += len(d)
                s.spec_accepted += len(toks) - 1
                self.stats.inc("spec_proposed", len(d))
                self.stats.inc("spec_accepted", len(toks) - 1)
            for tok in toks:
                n_out += 1
                self._emit(s, int(tok), now, finished)
                if s.state == FREE:
                    break  # EOS/stop/length retired the slot mid-block
        self.stats.inc("decode_tokens", n_out)

    def spec_stats(self) -> Optional[dict]:
        """Speculative-decoding snapshot for /health (None with spec
        off): mode, verify formulation, draft rung, proposed/accepted
        counters and the acceptance rate, plus the drafter's own."""
        if not self._spec_k:
            return None
        st = self.stats.snapshot()
        proposed, accepted = st["spec_proposed"], st["spec_accepted"]
        return {
            "mode": self.serving.spec_mode,
            "verify": self.serving.spec_verify,
            "draft_len": self._spec_k,
            "proposed": proposed,
            "accepted": accepted,
            "acceptance_rate": (round(accepted / proposed, 4)
                                if proposed else None),
            "verify_steps": st["spec_steps"],
            "drafter": self.drafter.stats(),
        }

    def page_stats(self) -> Optional[dict]:
        """Page-pool snapshot for /health (None on the contiguous pool)."""
        return None if self.pages is None else self.pages.stats()

    # -- paged admission / release (serving/pages.py) ------------------

    def _on_retire(self, slot: Slot) -> None:
        """Scheduler retirement hook (every retire path): return the
        slot's pages and drop its drafter state."""
        if self.pages is not None:
            self._release_slot_pages(slot)
        if self.drafter is not None:
            self.drafter.release(slot.index)

    def _admit_paged(self, slot: Slot, entry,
                     finished: List[RequestOutput]) -> Optional[int]:
        """Scheduler admission gate: plan the request against the radix
        cache and the page pool. Returns the cached prefix length to
        skip (>= 0), None to keep it queued (pages short right now), or
        -1 after shedding it with a ``page_exhausted`` output."""
        request, prompt, t_submit, _deadline, _trace = entry
        try:
            adm = self.pages.plan_admission(
                slot.index, [int(t) for t in prompt],
                request.params.max_new_tokens)
        except PagePoolExhaustedError:
            finished.append(self._shed_page_exhausted(request, prompt, t_submit))
            return -1
        if adm is None:
            return None
        for src, dst in adm.copies:  # COW forks, before any pool call
            copy_cache_pages(self.cache, src, dst)
        return adm.cached_len

    def _release_slot_pages(self, slot: Slot) -> None:
        """Dereference shared pages and donate the prompt's pages to the
        radix cache when they are trustworthy: prompt fully prefilled
        and the ring never rolled over them."""
        prompt = [] if slot.prompt is None else [int(t) for t in slot.prompt]
        cacheable = (
            slot.prompt_len > 0
            and slot.filled == slot.prompt_len
            and slot.prompt_len + len(slot.generated) <= self.cfg.block_size
        )
        self.pages.release(slot.index, prompt, cacheable)

    def _shed_page_exhausted(self, request, prompt,
                             submit_time: float) -> RequestOutput:
        """A request the page pool refused: shed at admission with a
        typed output the server maps to HTTP 503 ``page_pool_exhausted``;
        ``retry_after`` comes from the pool's observed drain rate."""
        self._seeds.pop(request.request_id, None)
        self.stats.inc("page_shed")
        return RequestOutput(
            request_id=request.request_id,
            prompt=[int(t) for t in prompt],
            tokens=[],
            finish_reason="page_exhausted",
            submit_time=submit_time,
            first_token_time=0.0,
            finish_time=time.perf_counter(),
            retry_after=self.pages.estimated_drain_s(self.pages.pages_needed(
                len(prompt), request.params.max_new_tokens)),
        )

    # -- emission / retirement -----------------------------------------

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
            spec_proposed=slot.spec_proposed,
            spec_accepted=slot.spec_accepted,
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
        deadlines, seeds). Nothing cached survives: the page pool and its
        radix tree start empty and the drafter forgets its maps. Params
        are never written, so the rebuilt pool starts from the same
        weights."""
        lost: List[int] = []
        for slot in self.scheduler.slots:
            if slot.state != FREE and slot.request is not None:
                lost.append(slot.request.request_id)
                self._seeds.pop(slot.request.request_id, None)
        preserved = list(self.scheduler.queue)
        if self.pages is not None:
            self.pages.reset()
        if self.drafter is not None:
            self.drafter.reset()
        self.cache = self._new_cache()
        self.scheduler = self._new_scheduler()
        self.scheduler.queue.extend(preserved)
        self.stats.inc("engine_restarts")
        return lost
