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
- **Host tier and preemption** (``ServingConfig.host_tier_bytes > 0``,
  serving/host_tier.py): evicted full radix pages demote into host
  memory and promote back with a copy at a later admission that matches
  them; a higher-priority request blocked on pages preempts a
  lower-priority ACTIVE slot, whose pages are stashed in the tier and
  injected back (CRC-verified) into whatever pages it gets when it is
  readmitted, so it continues bit for bit. Pages move between the pool
  and the host through ``extract_cache_page`` / ``inject_cache_page``.
- **Migration and replay** (serving/migrate.py): ``export_slot_state``
  captures an ACTIVE slot's pages and host state as a wire image,
  ``import_state`` readmits one through the same swap-in as a resume,
  ``release_migrated`` retires the source slot once the peer holds it.
  A request with ``key_offset`` (a replay of an earlier attempt's
  prompt + emitted tokens) draws token t with key position
  ``key_offset + t``.
- **Iteration-level scheduling**: each :meth:`step` admits queued
  requests, advances prefill by a bounded token budget in power-of-two
  chunks (serving/scheduler.py), then decodes ALL active slots as one
  batched step, samples, and emits or retires.
- **Speculative decoding** (serving/spec.py; ``spec_mode="ngram"``, or
  ``"model"``: a small checkpoint on its own slot pool, passed as
  ``spec_drafter=(params, cfg)`` or loaded from ``spec_drafter_ckpt``):
  when the drafter proposes tokens for some slot, the step is one k+1-row
  verify over the pool (``forward_decode_spec`` or its paged twin, exact
  or batched) with the accept/reject of the JAX
  ``_build_spec_step_fns._accept``: greedy rows accept draft j iff it
  equals row j-1's argmax, sampled rows run the Leviathan test and on
  rejection sample the residual. The contiguous pool then carries one
  extra trash row for the rejected rows' writes; the paged pool uses its
  trash page.
- **The logit pipeline** (models/decode.py:``apply_logit_pipeline``):
  repetition, presence and frequency penalties over a request's
  generated-token histogram, then its constraint mask, ahead of top-k
  and temperature, in the L=1 sampler and in every verify row (row j
  with the histogram and FSM state reached through drafts 0..j-1). A
  request's ``json_schema``, ``regex`` or ``choices`` compiles at submit
  into a token FSM (serving/constrain.py, cached and refcounted; a
  malformed spec raises ``ConstraintCompileError`` with the engine
  untouched); a sweep before each decode retires a slot whose mask row
  is empty (``constraint_complete`` or ``constraint_dead_end``).
  ``logprobs`` echoes each token's logprob and its top-N alternatives
  over the distribution sampled from, in the same device-to-host copy
  as the tokens. A step with no constrained or penalized row skips the
  pipeline (bit-identical: it passes inert rows through).
- **Telemetry** (obs/): ``stats`` is a :class:`StatsMap` over the JAX
  engine's counters (the same keys and counter names), beside its
  histograms and gauges, in a :class:`Registry` the server renders at
  ``GET /metrics``. A real tracer gets the ``schedule``, ``prefill``,
  ``decode``, ``sample`` and ``emit`` host spans of every step and the
  request lifecycle instants stamped with the request's
  :class:`TraceContext`. With ``ServingConfig.quality_telemetry`` the
  sampler and the verify's accept compute each token's entropy and
  margin on the device and bring them to the host in the same copy as
  the tokens (obs/quality.py consumes them). The families of subsystems
  not ported yet are left out: :data:`UNPORTED_FAMILIES`.
- **Chaos** (utils/faults.py): ``serve_raise``, ``serve_hang``,
  ``serve_corrupt``, ``page_exhaust``, ``prefix_corrupt``,
  ``spec_reject_storm``, ``quality_drift``, ``quality_nan`` and the
  tier kinds ``page_demote_fail``, ``page_promote_hang`` and
  ``page_swap_corrupt`` fire at the JAX engine's points, keyed on
  ``stats["iterations"]``; ``migrate_hang`` and ``migrate_corrupt`` at
  each export; ``spec_drafter_crash`` poisons a model drafter's pool
  before its propose rounds and ``constrain_dead_end`` a constrained
  slot's FSM cursor before the sweep.

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

Where the FSM masks live: as in the JAX engine, each step's mask rows
are built on the host from the cached FSM tables and copied to the
device — one copy of the constrained rows per step, none for inert
traffic.
"""

from __future__ import annotations

import math
import sys
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
    apply_logit_pipeline,
    compute_dtype,
    copy_cache_pages,
    entropy_margin,
    extract_cache_page,
    forward_chunk,
    forward_decode_pool,
    forward_decode_pool_paged,
    forward_decode_spec,
    forward_decode_spec_paged,
    gather_slot_cache,
    init_cache,
    init_cache_paged,
    inject_cache_page,
    kv_store_dtype,
    scatter_slot_cache,
)
from differential_transformer_replication_tpu_torch.obs.introspect import (
    serving_lambda_summary,
)
from differential_transformer_replication_tpu_torch.obs.quality import (
    ENTROPY_BINS,
    MARGIN_BINS,
    QualityMonitor,
    build_quality_row,
    load_fingerprint,
)
from differential_transformer_replication_tpu_torch.obs.registry import (
    Registry,
    StatsMap,
)
from differential_transformer_replication_tpu_torch.obs.spans import NOOP_TRACER
from differential_transformer_replication_tpu_torch.obs.trace import (
    TraceContext,
    child_span_args,
    instant_args,
)
from differential_transformer_replication_tpu_torch.serving.constrain import (
    ConstraintCache,
    ConstraintCompileError,
    spec_key,
)
from differential_transformer_replication_tpu_torch.serving.host_tier import (
    HostTier,
    TierEntry,
)
from differential_transformer_replication_tpu_torch.serving.migrate import (
    MigrateExportError,
    decode_slot_state,
    encode_slot_state,
    params_from_dict,
    params_to_dict,
)
from differential_transformer_replication_tpu_torch.serving.pages import (
    PagePool,
    PagePoolExhaustedError,
    page_bytes,
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
    constrain_proposals,
)
from differential_transformer_replication_tpu_torch.utils import faults

# engine.stats keys -> (Prometheus counter name, help): a copy of the JAX
# engine's _STAT_SPEC. The keys are the /health JSON contract, the names
# the /metrics one; StatsMap keeps both views over one set of values.
_STAT_SPEC = {
    "iterations": (
        "serving_engine_iterations_total",
        "Engine step() iterations executed.",
    ),
    "prefill_tokens": (
        "serving_prefill_tokens_total",
        "Prompt tokens prefilled into KV slots.",
    ),
    "decode_tokens": (
        "serving_decode_tokens_total",
        "Tokens generated by batched decode steps.",
    ),
    "completed": (
        "serving_requests_completed_total",
        "Requests finished normally (eos or length).",
    ),
    "cancelled": (
        "serving_requests_cancelled_total",
        "Requests abandoned by their caller (timeout/cancel).",
    ),
    "rejected": (
        "serving_requests_rejected_total",
        "Submissions rejected at admission (queue full / invalid).",
    ),
    "deadline_expired": (
        "serving_requests_deadline_expired_total",
        "Requests shed or retired past their server-side deadline.",
    ),
    "engine_restarts": (
        "serving_engine_restarts_total",
        "Slot-pool rebuilds after a crashed engine step.",
    ),
    "page_shed": (
        "serving_requests_page_shed_total",
        "Requests shed at admission because the KV page pool could "
        "not hold them (typed PagePoolExhaustedError).",
    ),
    "spec_proposed": (
        "serving_spec_proposed_tokens_total",
        "Draft tokens proposed to the speculative verify step.",
    ),
    "spec_accepted": (
        "serving_spec_accepted_tokens_total",
        "Draft tokens the target model accepted.",
    ),
    "spec_drafter_crashes": (
        "serving_spec_drafter_crashes_total",
        "Drafter pools rebuilt after the finite-logits guard tripped "
        "(engine fell back to non-spec decode, never garbage tokens).",
    ),
    "preemptions": (
        "serving_preemptions_total",
        "Mid-decode preemptions: a lower-priority request's KV pages "
        "stashed to the host tier to unblock a higher class.",
    ),
    "resumes": (
        "serving_preempt_resumes_total",
        "Preempted requests swapped back in bit-exact from their "
        "host-tier stash.",
    ),
    "tier_demotions": (
        "serving_host_tier_demotions_total",
        "Evicted radix pages demoted into the host-RAM tier.",
    ),
    "tier_promotions": (
        "serving_host_tier_promotions_total",
        "Host-tier pages promoted back to device at admission "
        "(a copy, never a recompute).",
    ),
    "tier_fallbacks": (
        "serving_host_tier_fallbacks_total",
        "Tier transfers that degraded to recompute or full restart "
        "(failed/corrupt demote, promote, or swap-in) — typed, "
        "counted, never a wedge.",
    ),
    "migrate_exports": (
        "serving_migrate_exports_total",
        "Slot decode states exported to a peer replica (drain path).",
    ),
    "migrate_imports": (
        "serving_migrate_imports_total",
        "Migrated slot states imported and re-admitted bit-exact.",
    ),
    "migrate_pages_shipped": (
        "serving_migrate_pages_shipped_total",
        "KV pages shipped over the wire by slot-state exports.",
    ),
    "migrate_pages_deduped": (
        "serving_migrate_pages_deduped_total",
        "KV pages NOT shipped because the destination's radix tree "
        "already held the prompt-prefix node (copied device-locally).",
    ),
    "migrate_bytes": (
        "serving_migrate_bytes_total",
        "Wire bytes of exported slot states (post-dedup).",
    ),
    "migrate_failed": (
        "serving_migrate_failed_total",
        "Migration imports that failed after admission (bad checksum, "
        "torn payload, injection failure) — typed, counted, degraded "
        "to a bit-exact recompute, never garbage KV.",
    ),
}

# Metric families the JAX engine registers that the port leaves out until
# their subsystem is ported: the device_* gauges of the sampled on-device
# profiler (``ServingConfig.profile_every``).
UNPORTED_FAMILIES = ("device_*",)

# the step counts the card's checks turn into kernel launches (the JAX
# engine has no such counters: its steps are compiled programs)
STEP_KEYS = ("prefill_chunks", "decode_steps", "spec_steps")


class EngineCrashError(RuntimeError):
    """The engine failed mid-flight (device error, non-finite logits).
    Typed and RETRIABLE: the supervised runner (serving/server.py) fails
    in-flight requests with it, rebuilds the slot pool and serves on."""

    retriable = True


def _penalties_on(p: SamplingParams) -> bool:
    """Whether a request engages the histogram side of the logit
    pipeline (repetition, presence or frequency penalty)."""
    return (p.repetition_penalty != 1.0 or p.presence_penalty != 0.0
            or p.frequency_penalty != 0.0)


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


def _uniform(n: int, seed: int, device) -> torch.Tensor:
    """``n`` uniforms in [0, 1) from a generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.rand(n, generator=gen, device=device)


def _gumbel_argmax(row: torch.Tensor, seed: int) -> torch.Tensor:
    """Gumbel-max draw from a processed row (top-k masked and divided by
    the temperature), with a generator seeded with ``seed``: the token
    as a 0-d tensor on the row's device."""
    u = _uniform(row.shape[-1], seed, row.device)
    return torch.argmax(row - torch.log(-torch.log(u)))


def _processed(logits: torch.Tensor, params: Sequence[SamplingParams],
               top_k_on: bool = True):
    """The JAX ``_sample``'s processed surface of ``logits`` (n, V) or
    (n, L, V) fp32 — already through the logit pipeline when a row needs
    it (:func:`_piped`) — batched on their device: values below the k-th
    largest of their row go to -inf (slot i's ``params[i].top_k``; 0/None
    = off, and every row off with ``top_k_on=False``, as the JAX verify's
    all-greedy accept does), then division by the greedy-safe
    temperature (1 for a greedy row). Returns the surface and, when the
    top-k ranking ran, each row's two largest values (else None). Draws,
    acceptance probabilities, the logprob echo and the quality tail all
    read this one surface."""
    n, V = logits.shape[0], logits.shape[-1]
    ks = [(p.top_k or 0) if top_k_on else 0 for p in params]
    temps = [p.temperature if p.temperature > 0 else 1.0 for p in params]
    kmax = max(ks)
    if not kmax and all(t == 1.0 for t in temps):
        return logits, None
    ops = torch.as_tensor(np.asarray([temps, ks], np.float32).T,
                          device=logits.device)
    bshape = (n,) + (1,) * (logits.dim() - 1)
    masked, top2 = logits, None
    if kmax:
        vals = torch.topk(logits, min(max(kmax, 2), V), dim=-1).values
        k = ops[:, 1].to(torch.int64)
        kth = (k - 1).clamp(0, vals.shape[-1] - 1).view(bshape)
        thresh = vals.gather(-1, kth.expand(*logits.shape[:-1], 1))
        masked = torch.where((k.view(bshape) > 0) & (logits < thresh),
                             torch.full_like(logits, -float("inf")), logits)
        if vals.shape[-1] >= 2:
            top2 = vals[..., :2]
    return masked / ops[:, 0].view(bshape), top2


class Pipe:
    """The logit-pipeline operands of n sampled rows (None where no row
    needs that part): ``allowed`` (n, V) or (n, L, V) bool constraint
    mask rows, ``counts`` (n, V) int32 generated-token histograms (a
    verify step adds each row's earlier drafts on the device), and
    ``pens`` (n, 3) fp32 repetition, presence and frequency penalties.
    Built by the engine only when an active row is constrained or
    penalized; otherwise the sampler skips the pipeline entirely, which
    is bit-identical (the pipeline passes inert rows through)."""

    __slots__ = ("allowed", "counts", "pens")

    def __init__(self, allowed=None, counts=None, pens=None):
        self.allowed, self.counts, self.pens = allowed, counts, pens


def _piped(logits: torch.Tensor, pipe: Optional[Pipe],
           drafts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``logits`` (n, V) or (n, L, V) through
    models/decode.py:``apply_logit_pipeline`` (unchanged with no
    ``pipe``). For an L-row verify block, row j's histogram also counts
    the drafts before it (``drafts`` (n, L - 1), zero-padded; the cumsum
    of their one-hots on the device, as the JAX accept does) and its
    mask is ``pipe.allowed[:, j]``."""
    if pipe is None:
        return logits
    shape, V = logits.shape, logits.shape[-1]
    L = shape[1] if logits.dim() == 3 else 1
    counts = pens = None
    if pipe.counts is not None:
        counts = pipe.counts
        if L > 1:
            oh = torch.nn.functional.one_hot(drafts, V).to(counts.dtype)
            counts = counts[:, None] + torch.cat(
                [torch.zeros_like(oh[:, :1]), oh.cumsum(dim=1)], dim=1)
        counts = counts.reshape(-1, V)
        pens = pipe.pens.repeat_interleave(L, dim=0)
    out = apply_logit_pipeline(
        logits.reshape(-1, V),
        None if pipe.allowed is None else pipe.allowed.reshape(-1, V),
        counts, *((None,) * 3 if pens is None else pens.unbind(1)))
    return out.reshape(shape)


def _lp_rows(lsm: torch.Tensor, tokens: torch.Tensor, k: int):
    """The logprob echo of sampled rows on the device: each row's chosen
    token's logprob under ``lsm`` (the log-softmax of the surface drawn
    from), and its top-``k`` (ids, logprobs), ties to the lower id as
    XLA's top_k breaks them."""
    chosen = lsm.gather(-1, tokens[..., None])[..., 0]
    vals, ids = torch.sort(lsm, dim=-1, descending=True, stable=True)
    return chosen, ids[..., :k], vals[..., :k]


def _host_rows(tokens: torch.Tensor, finite: torch.Tensor,
               em: Optional[torch.Tensor] = None, lp=None):
    """Tokens (n, ...) and their finite flags on the host, as numpy
    (tokens, finite, tail, echo). With the (..., 2) fp32 quality tail
    ``em`` and/or the logprob echo ``lp`` (:func:`_lp_rows`) everything
    comes back in ONE copy, packed as int32 (floats by their bits);
    without either the tokens and flags are copied as they are and the
    tail and echo are None."""
    if em is None and lp is None:
        return tokens.cpu().numpy(), finite.cpu().numpy(), None, None
    n = tokens.shape[0]
    parts = [tokens, finite] + ([] if em is None else [em]) + \
        ([] if lp is None else list(lp))
    host = torch.cat([(t.contiguous().view(torch.int32)
                       if t.is_floating_point() else t.to(torch.int32)
                       ).reshape(n, -1) for t in parts], dim=1).cpu().numpy()
    out, o = [], 0
    for t in parts:
        w = t[0].numel()
        a = host[:, o:o + w]
        o += w
        if t.is_floating_point():
            a = a.view(np.float32)
        elif t.dtype == torch.bool:
            a = a.astype(bool)
        out.append(a.reshape(t.shape))
    tok, ok = out[0], out[1]
    em_h = out[2] if em is not None else None
    lp_h = tuple(out[-3:]) if lp is not None else None
    return tok, ok, em_h, lp_h


def spec_accept(logits: torch.Tensor, drafts: Sequence[Sequence[int]],
                params: Sequence[SamplingParams], steps: Sequence[int],
                force_reject: bool = False, quality: bool = False,
                pipe: Optional[Pipe] = None, lp_k: int = 0):
    """Accept/reject of one verify step, per slot (the JAX
    ``_build_spec_step_fns._accept``). ``logits`` (n, L, V) fp32 of the
    n active slots; ``drafts[i]`` the slot's drafted tokens (dl <= L - 1
    of them); ``steps[i]`` the index t of the token row 0 produces;
    ``pipe`` the rows' logit-pipeline operands (None: no row needs it).
    Every row first goes through the pipeline (row j with the histogram
    and mask reached through drafts 0..j-1). Greedy rows accept draft j
    iff it equals row j's argmax. Sampled rows accept draft j with
    probability p_j(d_j) under the processed target (:func:`_processed`),
    with a uniform from :func:`accept_seed`, and draw the correction
    from row a (the first rejected row, or the bonus row) with the
    rejected token masked out — so a row with no draft reduces to
    :func:`sample_tokens` exactly — all on the device
    (:func:`_spec_draw`). ``force_reject`` rejects every draft
    (the ``spec_reject_storm`` fault): each slot then emits one token,
    from row 0. Returns host values (emitted tokens per slot, finite-ok
    per slot over its used rows), with ``quality`` each row's (entropy,
    margin) as a host (n, L, 2) float32 array (else None), and with
    ``lp_k`` > 0 the logprob echo of every row's emitted token as host
    arrays (chosen (n, L), top ids (n, L, lp_k), top logprobs) (else
    None); the argmax, the sampled rows' draws, the flags, the tail and
    the echo come back in one copy."""
    drawn = [i for i, p in enumerate(params) if p.temperature > 0]
    n, L, dev = logits.shape[0], logits.shape[1], logits.device
    dpad = None
    if pipe is not None or lp_k or drawn:
        dpad = torch.as_tensor([list(d) + [0] * (L - len(d)) for d in drafts],
                               dtype=torch.int64, device=dev)
    base = _piped(logits, pipe, None if dpad is None else dpad[:, :L - 1])
    proc = top2 = None
    if drawn or quality or lp_k:
        # the verify ranks for top-k only when a row samples, as JAX's
        # rungs do
        proc, top2 = _processed(base, params, top_k_on=bool(drawn))
    pred_t = torch.argmax(base, dim=-1)
    # each sampled row's accepted count and correction token, drawn on
    # the device: (n, 2), zero on greedy rows
    drawn_t = torch.zeros((n, 2), dtype=torch.int64, device=dev)
    emit_t = pred_t
    if drawn:
        drawn_t[drawn] = torch.stack([
            _spec_draw(proc[i, :len(drafts[i]) + 1], dpad[i], len(drafts[i]),
                       params[i].seed, steps[i], force_reject) for i in drawn])
        # a sampled row emits its drafts below the first rejection,
        # then the correction
        is_drawn = torch.zeros((n, 1), dtype=torch.bool, device=dev)
        is_drawn[drawn] = True
        at_a = torch.arange(L, device=dev)[None] == drawn_t[:, :1]
        emit_t = torch.where(is_drawn, torch.where(at_a, drawn_t[:, 1:], dpad), pred_t)
    lsm = torch.log_softmax(proc, dim=-1) if (quality or lp_k) else None
    # the echo reads each row's EMITTED token: a greedy row's is its
    # argmax at every row up to the correction (an accepted draft
    # equals it)
    pred, finite, em_host, lp_host = _host_rows(
        torch.cat([pred_t, drawn_t], dim=1), torch.isfinite(logits).all(dim=-1),
        entropy_margin(lsm, base, top2) if quality else None,
        _lp_rows(lsm, emit_t, lp_k) if lp_k else None)
    pred, finite = pred.tolist(), finite.tolist()
    out, ok = [], []
    for i, (d, p) in enumerate(zip(drafts, params)):
        dl = len(d)
        ok.append(all(finite[i][:dl + 1]))
        if p.temperature > 0:
            a, corr = pred[i][L:]
            out.append(list(d[:a]) + [corr])
            continue
        a = 0
        while not force_reject and a < dl and pred[i][a] == d[a]:
            a += 1
        out.append(list(d[:a]) + [pred[i][a]])
    return out, ok, em_host, lp_host


def _spec_draw(rows: torch.Tensor, dpad: torch.Tensor, dl: int, seed: int,
               t0: int, force_reject: bool) -> torch.Tensor:
    """One sampled row's verify decision on its device, without a copy
    to the host: ``rows`` (dl + 1, V) its processed surface, ``dpad``
    its drafts zero-padded. Draft j is accepted with probability
    p_j(d_j) against a uniform from :func:`accept_seed`; a, the accepted
    count, is the leading run. The correction comes from row a, with
    the rejected draft masked out when a < dl, drawn by
    :func:`_gumbel_argmax`'s rule with ``draw_seed(seed, t0 + a)``:
    every candidate a is drawn and a selects one, as a is not known on
    the host. Returns (a, correction) as an int64 (2,) tensor."""
    dev, V = rows.device, rows.shape[-1]
    d = dpad[:dl]
    if dl and not force_reject:
        p_d = torch.softmax(rows[:dl], dim=-1).gather(-1, d[:, None])[:, 0]
        u = torch.cat([_uniform(1, accept_seed(seed, t0 + j), dev)
                       for j in range(dl)])
        a = torch.cumprod((u < p_d).to(torch.int64), dim=0).sum()
    else:
        a = torch.zeros((), dtype=torch.int64, device=dev)
    cand = rows.clone()
    cand[torch.arange(dl, device=dev), d] = -float("inf")
    noise = torch.stack([_uniform(V, draw_seed(seed, t0 + c), dev)
                         for c in range(dl + 1)])
    toks = torch.argmax(cand - torch.log(-torch.log(noise)), dim=-1)
    return torch.stack([a, toks.gather(0, a.view(1))[0]])


def sample_tokens(logits: torch.Tensor, params: Sequence[SamplingParams],
                  steps: Sequence[int], quality: bool = False,
                  pipe: Optional[Pipe] = None, lp_k: int = 0):
    """One token per row of ``logits`` (n, V) fp32. The rows first go
    through the logit pipeline when ``pipe`` is given (penalties, then
    the constraint mask). Row i samples with ``params[i]``: temperature
    <= 0 is greedy (argmax of the piped surface, first index on ties);
    otherwise a Gumbel-max draw over the processed surface
    (:func:`_processed`: top-k masking, division by the temperature) from
    a generator seeded with ``draw_seed(seed, steps[i])``. Returns host
    values (tokens, finite-ok), with ``quality`` each row's (entropy,
    margin) over that same surface as a host (n, 2) float32 array (else
    None), and with ``lp_k`` > 0 the logprob echo (chosen (n,), top ids
    (n, lp_k), top logprobs (n, lp_k)) over the distribution sampled
    from (else None), all brought back in one copy. ``ok`` is over the
    RAW logits, so a corrupt pool or diverged params surface as a typed
    crash instead of a garbage argmax."""
    base = _piped(logits, pipe)
    tokens = torch.argmax(base, dim=-1)
    drawn = [i for i, p in enumerate(params) if p.temperature > 0]
    proc = top2 = lsm = None
    if drawn or quality or lp_k:
        proc, top2 = _processed(base, params)
        for i in drawn:
            tokens[i] = _gumbel_argmax(proc[i], draw_seed(params[i].seed, steps[i]))
        if quality or lp_k:
            lsm = torch.log_softmax(proc, dim=-1)
    tok, ok, em, lp = _host_rows(
        tokens, torch.isfinite(logits).all(dim=-1),
        entropy_margin(lsm, base, top2) if quality else None,
        _lp_rows(lsm, tokens, lp_k) if lp_k else None)
    return tok.tolist(), ok.tolist(), em, lp


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
    ``cuda`` and raises when CUDA is absent. ``registry`` (obs/registry.py;
    a fresh one when None) holds the counters, histograms and gauges;
    ``tracer`` (obs/spans.py; the no-op when None) gets the step's host
    spans and, being real, the request lifecycle instants.
    """

    def __init__(self, params: dict, cfg: ModelConfig,
                 serving: Optional[ServingConfig] = None, device="cuda",
                 registry: Optional[Registry] = None, tracer=None,
                 spec_drafter=None, vocab: Optional[Sequence[str]] = None):
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
        # the host-RAM page tier (serving/host_tier.py): demoted radix
        # pages and preempted requests' stashes
        self._tier: Optional[HostTier] = None
        # request_id -> host-side decode snapshot of a preempted (or
        # imported) request, consumed by the swap-in in _admit_paged
        self._resume: dict = {}
        # (slot, snapshot) pairs swapped in by this step's admission
        # gate; step() restores their decode state after plan() commits
        self._resumed: list = []
        if self.serving.paged():
            ps = self.serving.kv_page_size
            if self.serving.tiered():
                self._tier = HostTier(budget_bytes=self.serving.host_tier_bytes)
            self.pages = PagePool(
                page_size=ps, pages_per_slot=cfg.block_size // ps,
                num_slots=self.serving.num_slots,
                total_pages=self.serving.resolved_pool_pages(cfg) + 1,
                prefix_cache=self.serving.prefix_cache,
                tier=self._tier,
            )
        # speculative decoding: the contiguous pool carries one extra
        # TRASH row (index num_slots) for rejected rows' writes; the
        # paged pool's trash page does that job. A model drafter
        # (``spec_drafter=(params, cfg)``, or spec_drafter_ckpt) keeps
        # its own pool, and its ring bounds the verify window
        self.drafter = build_drafter(self.serving, cfg, self.max_total,
                                     drafter=spec_drafter, device=self.device)
        self._spec_k = self.serving.spec_draft_len if self.drafter else 0
        self._spec_window = cfg.block_size
        if self.drafter is not None and hasattr(self.drafter, "window"):
            self._spec_window = min(self._spec_window, self.drafter.window())
        self._drafter_crashes_seen = 0
        # structured decoding (serving/constrain.py): the compiled-FSM
        # cache, request_id -> (cache key, token FSM) of in-flight
        # constrained requests, the id -> string vocabulary the compiler
        # walks, and the logprob echo's widest top list
        self._vocab = tuple(vocab) if vocab is not None else None
        self._lp_k = min(self.serving.max_logprobs, cfg.vocab_size)
        self._constraint_cache = ConstraintCache(
            self.serving.constraint_cache_entries)
        self._constraints: dict = {}
        self._rows = self.serving.num_slots + (
            1 if self._spec_k and self.pages is None else 0)
        self.cache = self._new_cache()
        self.scheduler = self._new_scheduler()
        self._next_id = 0
        self._seeds: dict = {}  # request_id -> sampling seed (live requests)
        # outputs of a step() that later raised: already retired, so the
        # supervisor must still deliver them (take_finished)
        self._finished_prior: List[RequestOutput] = []
        self.steps = dict.fromkeys(STEP_KEYS, 0)
        self._quality = bool(self.serving.quality_telemetry)
        self._init_telemetry(registry, tracer)

    def _new_cache(self) -> list:
        if self.pages is not None:
            return init_cache_paged(self.cfg, self.pages.total_pages,
                                    self.serving.kv_page_size, self.device)
        return init_cache(self.cfg, self._rows, self.device)

    def _new_scheduler(self) -> Scheduler:
        hook = self._on_retire if (self.pages or self.drafter) else None
        return Scheduler(
            self.serving, on_retire=hook,
            on_preempt=self._preempt_slot if self._tier is not None else None)

    def _init_telemetry(self, registry: Optional[Registry], tracer) -> None:
        """The JAX engine's metric families (names, help, labels), less
        :data:`UNPORTED_FAMILIES`; a supervised restart keeps them."""
        self.registry = registry or Registry()
        self.tracer = tracer or NOOP_TRACER
        # the request lifecycle (admit / first_token / finish instants,
        # the request span) is gated on a real tracer, so tracing off
        # costs nothing per request or per token
        self._tracing = self.tracer is not NOOP_TRACER
        reg = self.registry
        self.stats = StatsMap(reg, _STAT_SPEC)
        self._finished_counter = reg.counter(
            "serving_requests_finished_total",
            "Retired requests by finish reason.", labelnames=("reason",))
        self._ttft_hist = reg.histogram(
            "serving_ttft_seconds",
            "Time from submit to first generated token.")
        self._itl_hist = reg.histogram(
            "serving_itl_seconds",
            "Inter-token latency between consecutive generated tokens.")
        self._queue_wait_hist = reg.histogram(
            "serving_queue_wait_seconds",
            "Time from submit to first prefill chunk (slot admission).")
        self._step_hist = reg.histogram(
            "serving_engine_step_seconds",
            "Wall time of one engine iteration (schedule+prefill+decode).")
        self._slot_gauge = reg.gauge(
            "serving_slot_occupancy",
            "KV slots currently held by in-flight requests.")
        reg.gauge("serving_slots", "Size of the fixed KV slot pool.").set(
            self.serving.num_slots)
        self._kv_gauge = reg.gauge(
            "serving_kv_utilization",
            "Fraction of pooled KV positions holding live sequence state.")
        self._queue_gauge = reg.gauge(
            "serving_queue_depth", "Requests waiting for a slot.")
        self._queue_class_gauge = reg.gauge(
            "serving_queue_depth_by_class",
            "Requests waiting for a slot, by priority class.",
            labelnames=("priority",))
        self._class_ttft_hist = reg.histogram(
            "serving_class_ttft_seconds",
            "Time from submit to first generated token, by priority "
            "class.", labelnames=("priority",))
        self._class_itl_hist = reg.histogram(
            "serving_class_itl_seconds",
            "Inter-token latency between consecutive generated tokens, "
            "by priority class.", labelnames=("priority",))
        reg.gauge(
            "serving_kv_cache_bytes_per_slot",
            "HBM bytes of pooled KV-cache state per slot "
            "(includes int8 scale planes when quantized).",
        ).set(sum(t.numel() * t.element_size() for layer in self.cache
                  for t in layer.values()) // self._rows)
        reg.gauge(
            "serving_kv_cache_dtype",
            "Active KV-cache storage dtype (constant 1; the identity "
            "rides the label).", labelnames=("dtype",),
        ).set(1, dtype=str(kv_store_dtype(self.cfg)).replace("torch.", ""))
        if self.pages is not None:
            reg.gauge(
                "serving_kv_pages_total",
                "Physical KV pages in the pool (trash page excluded).",
            ).set(self.pages.stats()["total"])
            self._pages_free_gauge = reg.gauge(
                "serving_kv_pages_free", "KV pages currently unallocated.")
            self._pages_cached_gauge = reg.gauge(
                "serving_kv_pages_cached",
                "KV pages held by the radix prefix cache.")
            self._cow_forks_counter = reg.counter(
                "serving_kv_pages_cow_forks_total",
                "Copy-on-write forks of shared prefix pages.")
            self._prefix_hits_counter = reg.counter(
                "serving_prefix_cache_hits_total",
                "Admissions that reused a cached prompt prefix.")
            self._prefix_misses_counter = reg.counter(
                "serving_prefix_cache_misses_total",
                "Admissions with no cached prefix to reuse.")
            self._prefix_evictions_counter = reg.counter(
                "serving_prefix_cache_evictions_total",
                "Cached prefix pages LRU-evicted under page pressure.")
            reg.gauge(
                "serving_kv_page_bytes",
                "HBM bytes per physical KV page across all layers "
                "(int8-aware: values + fp32 scale planes).",
            ).set(page_bytes(self.cfg, self.serving.kv_page_size))
            self._tier_prefix_hits_counter = reg.counter(
                "serving_host_tier_prefix_hits_total",
                "Admissions whose prefix match extended into the "
                "host tier (promoted, never recomputed).")
        if self._tier is not None:
            reg.gauge(
                "serving_host_tier_budget_bytes",
                "Configured host-RAM byte budget of the KV page tier.",
            ).set(self.serving.host_tier_bytes)
            self._tier_bytes_gauge = reg.gauge(
                "serving_host_tier_bytes",
                "Host bytes currently held by the KV page tier "
                "(cached prefixes + pinned preemption stashes).")
            self._tier_entries_gauge = reg.gauge(
                "serving_host_tier_entries",
                "Demoted prefix pages currently cached in the host tier.")
            self._tier_stashes_gauge = reg.gauge(
                "serving_host_tier_stashes",
                "Preempted requests with KV stashed in the host tier.")
            self._tier_hits_counter = reg.counter(
                "serving_host_tier_hits_total",
                "Host-tier prefix lookups that hit a demoted page.")
            self._tier_misses_counter = reg.counter(
                "serving_host_tier_misses_total",
                "Host-tier prefix lookups that missed.")
            self._tier_evictions_counter = reg.counter(
                "serving_host_tier_evictions_total",
                "Cached tier pages LRU-evicted under the byte budget.")
            self._tier_corrupt_counter = reg.counter(
                "serving_host_tier_corrupt_total",
                "Tier page images whose CRC32 verify failed (dropped "
                "and recomputed, never injected).")
        self._spec_accept_gauge = None
        if self._spec_k:
            self._spec_accept_gauge = reg.gauge(
                "serving_spec_acceptance_rate",
                "Accepted / proposed draft tokens (cumulative).")
            reg.gauge(
                "serving_spec_draft_len",
                "Compiled draft-length rung k of the fused verify step.",
            ).set(self._spec_k)
            reg.gauge(
                "serving_spec_mode",
                "Active speculative-decoding drafter (constant 1; the "
                "identity rides the label).", labelnames=("mode",),
            ).set(1, mode=self.serving.spec_mode)
            if hasattr(self.drafter, "bytes_total"):
                reg.gauge(
                    "serving_spec_drafter_kv_bytes",
                    "HBM bytes held by the drafter's own KV slot pool.",
                ).set(self.drafter.bytes_total())
        self._constrained_gauge = reg.gauge(
            "serving_constrained_requests_active",
            "In-flight requests decoding under a compiled constraint.")
        self._ccache_entries_gauge = reg.gauge(
            "serving_constraint_cache_entries",
            "Compiled constraint FSMs currently cached.")
        self._ccache_bytes_gauge = reg.gauge(
            "serving_constraint_cache_bytes",
            "Host bytes held by cached constraint FSM tables.")
        self._ccache_hits_counter = reg.counter(
            "serving_constraint_cache_hits_total",
            "Constraint compiles avoided by the FSM cache.")
        self._ccache_misses_counter = reg.counter(
            "serving_constraint_cache_misses_total",
            "Constraint specs compiled from scratch.")
        # model-quality telemetry (obs/quality.py): the accumulator and
        # the fault flag exist always (cheap pops on every retire path),
        # the monitor and its families only with quality on
        self._q_acc: dict = {}
        self._q_force_nan = False
        self._q_constraint_total = 0
        self._q_constraint_bad = 0
        self._quality_monitor = None
        self._lambda_gauge = None
        self._lambda_summary: dict = {}
        if self._quality:
            ref = None
            if self.serving.quality_fingerprint:
                # a bad reference path fails at build, not at judging
                ref = load_fingerprint(self.serving.quality_fingerprint)
            self._quality_monitor = QualityMonitor(reference=ref)
            self._q_entropy_hist = reg.histogram(
                "serving_token_entropy",
                "Sampled-distribution entropy (nats) per emitted token.",
                buckets=ENTROPY_BINS)
            self._q_margin_hist = reg.histogram(
                "serving_logit_margin",
                "Top-1 vs top-2 processed-logit margin per emitted "
                "token.", buckets=MARGIN_BINS)
            self._q_drift_gauge = reg.gauge(
                "serving_quality_drift",
                "Max PSI drift of the live entropy/margin sketches vs "
                "the recorded reference fingerprint (0 = no reference, "
                "thin evidence, or no drift).")
            self._q_validity_gauge = reg.gauge(
                "serving_constraint_validity_rate",
                "Fraction of finished constrained requests that did "
                "NOT dead-end (1.0 until any constrained request "
                "finishes).")
            self._q_validity_gauge.set(1.0)
            self._lambda_gauge = reg.gauge(
                "serving_lambda_mean",
                "Per-layer effective differential-attention lambda of "
                "the serving params (head/term mean; absent for the "
                "control family).", labelnames=("layer",))
            self._refresh_lambda_gauges()

    # -- submission ---------------------------------------------------

    def submit(self, prompt: Sequence[int],
               params: Optional[SamplingParams] = None,
               deadline: Optional[float] = None,
               trace: Optional[TraceContext] = None, **kw) -> int:
        """Queue one request; returns its request_id. ``kw`` are
        SamplingParams fields. ``deadline`` is an ABSOLUTE
        ``time.perf_counter`` timestamp (None applies
        ``ServingConfig.default_deadline_s`` when set). ``trace`` is the
        request's trace context (obs/trace.py): host-side only, stamped
        onto its lifecycle instants and span when tracing is on, and
        echoed as ``RequestOutput.trace_id``. Raises ValueError when the
        request cannot fit the engine (family limits, vocab range) or
        a non-retriable PagePoolExhaustedError when its worst case exceeds
        the whole page pool, and a ConstraintCompileError (a ValueError)
        when its constraint does not compile: the constraint is compiled
        (or found in the cache) before the scheduler sees the request, so
        a malformed spec leaves the engine untouched."""
        req = Request.make(self._next_id, prompt, params, **kw)
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
        ckey = cfsm = None
        if req.params.constrained:
            eos = (req.params.eos_token_id
                   if req.params.eos_token_id is not None
                   else self.serving.eos_token_id)
            ckey = spec_key(req.params, eos)
            if self._vocab is None:
                self.stats.inc("rejected")
                raise ConstraintCompileError(
                    "constrained request but the engine was built "
                    "without a vocabulary (pass vocab= — the id->string "
                    "table the FSM compiler walks)")
            try:
                cfsm = self._constraint_cache.acquire(ckey, self._vocab)
            except ConstraintCompileError:
                self.stats.inc("rejected")
                raise
        now = time.perf_counter()
        if deadline is None and self.serving.default_deadline_s > 0:
            deadline = now + self.serving.default_deadline_s
        try:
            self.scheduler.submit(req, p, now, deadline or 0.0, trace=trace)
        except Exception:
            if ckey is not None:
                self._constraint_cache.release(ckey)
            self.stats.inc("rejected")
            raise
        self._next_id += 1
        if ckey is not None:
            self._constraints[req.request_id] = (ckey, cfsm)
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
        self._drop_constraint(request_id)
        self._drop_resume(request_id)
        self._q_acc.pop(request_id, None)
        self.stats.inc("cancelled")
        self._finished_counter.inc(reason="cancelled")
        return True

    def _drop_constraint(self, request_id: int) -> None:
        """Release a request's compiled-FSM reference on every path that
        forgets the request (finish, cancel, shed, expire, crash, a
        migration's release): a leaked reference pins the entry."""
        ent = self._constraints.pop(request_id, None)
        if ent is not None:
            self._constraint_cache.release(ent[0])

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
        iteration = self.stats["iterations"]
        t_step = time.perf_counter()
        faults.serve_fire(iteration)
        if self._quality:
            # the drift detector's drills: quality_drift perturbs the
            # live params (logits stay finite, only the quality axis
            # sees it); quality_nan poisons this iteration's tail on the
            # host, which must degrade to "no signal"
            if faults.quality_drift_at(iteration):
                self._apply_quality_drift()
            self._q_force_nan = faults.quality_nan_at(iteration)
        finished = self._finished_prior
        if self.pages is not None and faults.page_exhaust_at(iteration):
            # the next admission plan raises the typed
            # PagePoolExhaustedError: the 503 shed path
            self.pages.force_exhaust()
        with self.tracer.span("schedule", iteration=iteration):
            now = time.perf_counter()
            for req, prompt, t_submit, _dl, trace in self.scheduler.shed_expired(now):
                finished.append(self._expire_queued(req, prompt, t_submit,
                                                    now, trace))
            for slot in self.scheduler.expired_slots(now):
                finished.append(self._finish(slot, "deadline", now=now))
            admit = None
            if self.pages is not None:
                admit = lambda slot, entry: self._admit_paged(
                    slot, entry, iteration, finished)
            chunks = self.scheduler.plan(admit=admit)
        if self._resumed:
            self._restore_resumed()
        if chunks:
            with self.tracer.span("prefill", iteration=iteration,
                                  chunks=len(chunks)):
                self._run_prefill(chunks, finished)
        if faults.serve_corrupt_at(iteration):
            self._corrupt_one_slot()
        if self.pages is not None and faults.prefix_corrupt_at(iteration):
            self._corrupt_cached_prefix()
        active = self.scheduler.active_slots()
        if self._constraints:
            active = self._sweep_constraints(active, iteration, finished)
        proposals = (self._collect_proposals(active, iteration)
                     if active and self.drafter else {})
        if proposals:
            self._decode_spec(active, proposals, iteration, finished)
        elif active:
            self._decode(active, iteration, finished)
        self.stats.inc("iterations")
        self._step_hist.observe(time.perf_counter() - t_step)
        self._update_gauges()
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
            if start == slot.cached_len:
                # the first chunk RUN: the request got its slot, and the
                # submit -> admission interval is TTFT's queue wait
                self._queue_wait_hist.observe(
                    time.perf_counter() - slot.submit_time)
                if self._tracing:
                    self.tracer.instant(
                        "admit", rid=slot.request.request_id, slot=i,
                        cached=slot.cached_len, **self._targs(slot.trace))
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
            self.steps["prefill_chunks"] += 1
            if slot.filled == slot.prompt_len:
                tok, ok, em, lp = sample_tokens(
                    logits[0, -1:].to(torch.float32), [slot.request.params],
                    [self._key_pos(slot)], quality=self._quality,
                    pipe=self._pipe([slot]), lp_k=self._lp_width([slot]))
                if not ok[0]:
                    raise EngineCrashError(
                        f"non-finite logits prefilling slot {i} (request "
                        f"{slot.request.request_id}): corrupt slot pool or "
                        "numerically diverged params"
                    )
                self._emit(slot, tok[0], time.perf_counter(), finished,
                           None if em is None else em[0],
                           self._lp_pair(slot, lp, 0))

    @staticmethod
    def _pos0(s: Slot) -> int:
        """Position of the slot's last emitted token."""
        return s.prompt_len + len(s.generated) - 1

    @staticmethod
    def _key_pos(s: Slot) -> int:
        """Key position of the slot's next token: its index t, shifted by
        the request's ``key_offset`` (a replayed continuation: the first
        ``key_offset`` prompt tokens were emitted by an earlier attempt,
        so token t draws as that attempt's token ``key_offset + t``)."""
        return s.request.params.key_offset + len(s.generated)

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

    def _decode_args(self, iteration: int, active: List[Slot]) -> dict:
        """The decode span's args: with a real tracer, the trace ids the
        step advanced, so a stitched timeline shows which requests
        shared it."""
        args = {"iteration": iteration, "active": len(active)}
        if self._tracing:
            tids = [s.trace.trace_id for s in active if s.trace is not None]
            if tids:
                args["trace_ids"] = tids
        return args

    def _decode(self, active: List[Slot], iteration: int,
                finished: List[RequestOutput]) -> None:
        """One batched L=1 step over the whole pool; only the active
        rows' K/V land in live rows/pages and only their tokens are
        used."""
        B = self._rows
        tokens = np.zeros((B,), np.int64)
        pos = np.zeros((B,), np.int32)
        for s in active:
            tokens[s.index] = s.generated[-1]
            pos[s.index] = self._pos0(s)
        with self.tracer.span("decode", **self._decode_args(iteration, active)):
            rows = torch.as_tensor([s.index for s in active], device=self.device)
            tok_t = torch.as_tensor(tokens, device=self.device)
            pos_t = torch.as_tensor(pos, device=self.device)
            if self.pages is not None:
                tables = self.pages.tables()
                write = np.zeros((B,), np.int32)  # inactive rows: the trash page
                for s in active:
                    write[s.index] = self._write_page(tables, s.index,
                                                      int(pos[s.index]))
                logits, _ = forward_decode_pool_paged(
                    self.params, tok_t, pos_t, self.cache,
                    torch.as_tensor(tables, device=self.device),
                    torch.as_tensor(write, device=self.device), self.cfg,
                    rope_len=self.max_total)
            else:
                logits, _ = forward_decode_pool(
                    self.params, tok_t, pos_t, self.cache, self.cfg,
                    rope_len=self.max_total, active=rows)
        with self.tracer.span("sample", iteration=iteration):
            toks, ok, em, lp = sample_tokens(
                logits[rows].to(torch.float32),
                [s.request.params for s in active],
                [self._key_pos(s) for s in active], quality=self._quality,
                pipe=self._pipe(active), lp_k=self._lp_width(active))
        self._check_finite([s for s, good in zip(active, ok) if not good],
                           "decoding")
        with self.tracer.span("emit", iteration=iteration):
            self.steps["decode_steps"] += 1
            self.stats.inc("decode_tokens", len(active))
            now = time.perf_counter()
            for n, (s, tok) in enumerate(zip(active, toks)):
                self._emit(s, tok, now, finished, None if em is None else em[n],
                           self._lp_pair(s, lp, n))

    # -- speculative decoding (serving/spec.py) ------------------------

    def _collect_proposals(self, active: List[Slot], iteration: int) -> dict:
        """Ask the drafter for up to k tokens per eligible active slot.
        Each slot's cap keeps the verify block inside the request's
        max_new_tokens (the corrected token must still fit), its
        ``draft_len`` and the ring windows of the target and of a model
        drafter (the verify writes positions pos..pos+cap; a rolled-over
        write would evict keys a rejected row still needs). Drafts of a
        constrained slot are cut at the first token its FSM refuses. The
        ``spec_drafter_crash`` fault poisons a model drafter's pool here;
        a tripped drafter proposes nothing and its crash is counted."""
        if faults.spec_drafter_crash_at(iteration):
            poison = getattr(self.drafter, "poison", None)
            if poison is not None:
                poison()
        infos = []
        for s in active:
            p = s.request.params
            cap = self._spec_k
            if p.draft_len is not None:
                cap = min(cap, p.draft_len)
            pos0 = self._pos0(s)
            cap = min(cap, p.max_new_tokens - len(s.generated) - 1,
                      self._spec_window - 1 - pos0)
            if cap <= 0:
                continue
            if s.prompt_ids is None:  # once per admission
                s.prompt_ids = [int(t) for t in s.prompt]
            infos.append(DraftSlot(s.index, s.prompt_ids + s.generated, pos0, cap))
        if not infos:
            return {}
        props = self.drafter.propose_all(infos)
        if props and self._constraints:
            fsms = {}
            for s in active:
                fsm = self._slot_fsm(s)
                if fsm is not None:
                    fsms[s.index] = (fsm, s.fsm_state)
            props = constrain_proposals(props, fsms)
        if not props:
            # the no-proposal signature of a tripped drafter: mirror its
            # crash counter on this path only
            crashes = self.drafter.stats()["drafter_crashes_total"]
            if crashes > self._drafter_crashes_seen:
                self.stats.inc("spec_drafter_crashes",
                               crashes - self._drafter_crashes_seen)
                self._drafter_crashes_seen = crashes
                print("[serving] spec drafter pool tripped the finite-logits "
                      "guard; rebuilt from params, falling back to non-spec "
                      "decode this iteration", file=sys.stderr)
        return props

    def _decode_spec(self, active: List[Slot], proposals: dict, iteration: int,
                     finished: List[RequestOutput]) -> None:
        """One k+1-row verify step over the whole pool: row 0 of each
        slot is its last emitted token, rows 1..dl its drafts; rows past
        the draft length (and every row of an inactive slot) write to
        the trash row/page. Then accept/reject per slot (every draft
        rejected under the ``spec_reject_storm`` fault) and emit each
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
        decode_args = self._decode_args(iteration, active)
        decode_args["drafted"] = sum(len(d) for d in drafts)
        with self.tracer.span("decode", **decode_args):
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
        with self.tracer.span("sample", iteration=iteration):
            rows = torch.as_tensor([s.index for s in active], device=dev)
            emitted, ok, em, lp = spec_accept(
                logits[rows], drafts, [s.request.params for s in active],
                [self._key_pos(s) for s in active],
                force_reject=faults.spec_reject_storm_at(iteration),
                quality=self._quality, pipe=self._pipe(active, drafts),
                lp_k=self._lp_width(active))
        self._check_finite([s for s, good in zip(active, ok) if not good],
                           "verifying")
        with self.tracer.span("emit", iteration=iteration):
            self.steps["decode_steps"] += 1
            self.steps["spec_steps"] += 1
            now = time.perf_counter()
            n_out = 0
            for n, (s, d, toks) in enumerate(zip(active, drafts, emitted)):
                if s.constraint is not None:
                    # a constraint can close inside the verify block:
                    # every later row's mask is all-zero, so its "token"
                    # is garbage. Cut at the first token of a zeroed row;
                    # the next step's sweep retires the slot typed
                    st, keep = s.fsm_state, 0
                    for tok in toks:
                        if st < 0 or not s.constraint.masks[st].any():
                            break
                        st = s.constraint.advance(st, tok)
                        keep += 1
                    toks = toks[:keep]
                p0 = self._pos0(s)
                if d:
                    s.spec_proposed += len(d)
                    s.spec_accepted += len(toks) - 1
                    self.stats.inc("spec_proposed", len(d))
                    self.stats.inc("spec_accepted", len(toks) - 1)
                # the drafter's validity cursor follows the accepted
                # prefix; its entries past it are fed again next round
                self.drafter.commit(s.index, p0 + len(toks))
                for j, tok in enumerate(toks):
                    n_out += 1
                    self._emit(s, tok, now, finished,
                               None if em is None else em[n, j],
                               self._lp_pair(s, lp, n, j))
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
            "drafter_crashes": st["spec_drafter_crashes"],
            "verify_steps": self.steps["spec_steps"],
            "drafter": self.drafter.stats(),
        }

    def page_stats(self) -> Optional[dict]:
        """Page-pool snapshot for /health (None on the contiguous pool)."""
        return None if self.pages is None else self.pages.stats()

    def tier_stats(self) -> Optional[dict]:
        """Host-tier snapshot for /health (None when the tier is off):
        byte budget and usage, cached entries and pinned stashes, the
        tier's own counters (serving/host_tier.py:HostTier.stats), and
        the engine's demote, promote, preempt, resume and fallback
        totals."""
        if self._tier is None:
            return None
        out = dict(self._tier.stats())
        out["demotions"] = self.stats["tier_demotions"]
        out["promotions"] = self.stats["tier_promotions"]
        out["fallbacks"] = self.stats["tier_fallbacks"]
        out["preemptions"] = self.stats["preemptions"]
        out["resumes"] = self.stats["resumes"]
        return out

    def constrain_stats(self) -> dict:
        """Structured-decoding snapshot for /health: in-flight
        constrained requests and the compile cache's counters
        (serving/constrain.py:ConstraintCache.stats)."""
        out = dict(self._constraint_cache.stats())
        out["active"] = len(self._constraints)
        return out

    def _update_gauges(self) -> None:
        """Refresh the point-in-time gauges (/metrics): slot occupancy,
        queue depths, the constraint cache, the spec acceptance rate,
        the quality drift and constraint validity, and the fraction of
        pooled KV positions holding live state; the paged pool also
        mirrors its locked host counters."""
        self._slot_gauge.set(self.scheduler.occupied())
        self._queue_gauge.set(self.scheduler.queue_len())
        for cls, depth in self.scheduler.queue_depths().items():
            self._queue_class_gauge.set(depth, priority=cls)
        self._constrained_gauge.set(len(self._constraints))
        cst = self._constraint_cache.stats()
        self._ccache_entries_gauge.set(cst["entries"])
        self._ccache_bytes_gauge.set(cst["bytes"])
        self._ccache_hits_counter.set(cst["hits_total"])
        self._ccache_misses_counter.set(cst["misses_total"])
        if self._spec_accept_gauge is not None:
            proposed = self.stats["spec_proposed"]
            self._spec_accept_gauge.set(
                self.stats["spec_accepted"] / proposed if proposed else 0.0)
        if self._quality_monitor is not None:
            self._q_drift_gauge.set(self._quality_monitor.drift())
            if self._q_constraint_total:
                self._q_validity_gauge.set(
                    1.0 - self._q_constraint_bad / self._q_constraint_total)
        if self.pages is not None:
            st = self.pages.stats()
            self._pages_free_gauge.set(st["free"])
            self._pages_cached_gauge.set(st["cached"])
            self._cow_forks_counter.set(st["cow_forks_total"])
            self._prefix_hits_counter.set(st["hits_total"])
            self._prefix_misses_counter.set(st["misses_total"])
            self._prefix_evictions_counter.set(st["evictions_total"])
            self._tier_prefix_hits_counter.set(st["tier_hits_total"])
            if self._tier is not None:
                ts = self._tier.stats()
                self._tier_bytes_gauge.set(ts["bytes"])
                self._tier_entries_gauge.set(ts["entries"])
                self._tier_stashes_gauge.set(ts["stashes"])
                self._tier_hits_counter.set(ts["hits_total"])
                self._tier_misses_counter.set(ts["misses_total"])
                self._tier_evictions_counter.set(ts["evictions_total"])
                self._tier_corrupt_counter.set(ts["corrupt_total"])
            held = sum(min(s.filled + len(s.generated), self.cfg.block_size)
                       for s in self.scheduler.slots if s.state != FREE)
            self._kv_gauge.set(held / (st["total"] * self.serving.kv_page_size))
            return
        held = sum(min(s.filled + len(s.generated), self.max_total)
                   for s in self.scheduler.slots if s.state != FREE)
        self._kv_gauge.set(held / (self.serving.num_slots * self.max_total))

    # -- model-quality observability (obs/quality.py) ------------------

    def quality_stats(self) -> Optional[dict]:
        """Point-in-time quality snapshot (None with quality off): live
        sketch means, token counts, skipped ("no signal") observations,
        the drift score, the constraint-validity rate (the share of
        finished constrained requests that did not dead-end), the
        cumulative spec acceptance when spec ran, and the per-layer
        lambda summary."""
        if self._quality_monitor is None:
            return None
        out = self._quality_monitor.stats()
        out["constraint_validity_rate"] = (
            1.0 - self._q_constraint_bad / self._q_constraint_total
            if self._q_constraint_total else 1.0)
        proposed = self.stats["spec_proposed"]
        if proposed:
            out["spec_acceptance_rate"] = round(
                self.stats["spec_accepted"] / proposed, 4)
        out.update(self._lambda_summary)
        return out

    def quality_fingerprint(self, meta: Optional[dict] = None) -> Optional[dict]:
        """The live sketches as a reference fingerprint —
        ``--quality-record``'s payload (obs/quality.py:save_fingerprint).
        None with quality off."""
        if self._quality_monitor is None:
            return None
        return self._quality_monitor.fingerprint(meta=meta)

    def quality_row(self) -> Optional[dict]:
        """One ``{"record": "quality"}`` JSONL row with the
        ``lambda_l<k>`` keys ``tools/lambda_report.py --serving`` renders.
        None with quality off."""
        if self._quality_monitor is None:
            return None
        return build_quality_row(self._quality_monitor,
                                 self.stats["iterations"],
                                 lambdas=self._lambda_summary)

    def _refresh_lambda_gauges(self) -> None:
        """Mirror the serving params' per-layer effective lambdas into
        ``serving_lambda_mean{layer=}``; at build and after a params
        rebind (the quality_drift fault), never per step: the summary
        copies device scalars to the host."""
        if self._lambda_gauge is None:
            return
        self._lambda_summary = serving_lambda_summary(self.params, self.cfg)
        for key, val in self._lambda_summary.items():
            if "_t" in key:
                continue  # per-term ndiff detail rides quality_row only
            self._lambda_gauge.set(val, layer=key[len("lambda_l"):])

    def _apply_quality_drift(self) -> None:
        """The ``quality_drift@N`` fault: perturb the live params so the
        generated distributions shift while every logit stays finite.
        Every family's lm head is scaled by 0.25 (the greedy argmax is
        unchanged); diff and ndiff also get +2.0 on both ``lambda_q[0]``
        and ``lambda_k[0]`` of layer 1, which the lambda gauges show.
        The tree is rebound with new tensors, as the JAX engine rebinds
        its params."""
        params = dict(self.params)
        if self.cfg.model in ("diff", "ndiff"):
            blocks = list(params["blocks"])
            blk = dict(blocks[0])
            attn = dict(blk["attn"])
            for name in ("lambda_q", "lambda_k"):
                vec = attn[name].clone()
                vec[0] += 2.0
                attn[name] = vec
            blk["attn"] = attn
            blocks[0] = blk
            params["blocks"] = blocks
        params["lm_head"] = {k: v * 0.25 for k, v in params["lm_head"].items()}
        self.params = params
        self._refresh_lambda_gauges()

    def _q_observe(self, rid: int, ent: float, margin: float,
                   rep: bool) -> None:
        """Fold one emitted token's quality tail into the histograms, the
        drift monitor and the request's accumulator. The ``quality_nan``
        fault poisons the values here: non-finite signals are skipped
        everywhere downstream ("no signal", never a crash)."""
        if self._q_force_nan:
            ent = margin = float("nan")
        if math.isfinite(ent):
            self._q_entropy_hist.observe(ent)
        if math.isfinite(margin):
            self._q_margin_hist.observe(margin)
        self._quality_monitor.observe(ent, margin)
        acc = self._q_acc.get(rid)
        if acc is None:
            # ent_sum, ent_n, margin_sum, margin_n, rep_run, rep_max
            acc = self._q_acc[rid] = [0.0, 0, 0.0, 0, 0, 0]
        if math.isfinite(ent):
            acc[0] += ent
            acc[1] += 1
        if math.isfinite(margin):
            acc[2] += margin
            acc[3] += 1
        if rep:
            acc[4] += 1
            acc[5] = max(acc[5], acc[4])
        else:
            acc[4] = 0

    # -- structured decoding and the logit pipeline (serving/constrain.py)

    def _sweep_constraints(self, active: List[Slot], iteration: int,
                           finished: List[RequestOutput]) -> List[Slot]:
        """Before each decode: retire every constrained slot whose mask
        row is all-zero (nothing it could emit) — ``constraint_complete``
        in an accepting state (the structure is done and no EOS was
        configured), ``constraint_dead_end`` otherwise (only the
        ``constrain_dead_end`` fault plants one: compiled FSMs have no
        dead states). Returns the slots still active."""
        if faults.constrain_dead_end_at(iteration):
            for s in active:
                if self._slot_fsm(s) is not None:
                    s.fsm_state = -1
                    break
        swept = False
        for s in active:
            fsm = self._slot_fsm(s)
            if fsm is None:
                continue
            if s.fsm_state >= 0 and fsm.masks[s.fsm_state].any():
                continue
            swept = True
            finished.append(self._finish(
                s, "constraint_complete" if fsm.is_accepting(s.fsm_state)
                else "constraint_dead_end"))
        return self.scheduler.active_slots() if swept else active

    def _slot_fsm(self, s: Slot):
        """The slot's compiled token FSM (None when unconstrained),
        attached at its first use: admission happens in the scheduler,
        which knows nothing of constraints. A replayed continuation
        (``key_offset``) walks the fresh cursor over the prompt tail the
        earlier attempt emitted, so the masks go on from its state."""
        if s.constraint is None:
            ent = self._constraints.get(s.request.request_id)
            if ent is None:
                return None
            s.constraint = ent[1]
            s.fsm_state = ent[1].start
            ko = s.request.params.key_offset
            if ko:
                P, st = s.prompt_len, s.fsm_state
                for t in s.prompt[max(0, P - ko):P]:
                    if st < 0:
                        break
                    st = ent[1].advance(st, int(t))
                s.fsm_state = st
        return s.constraint

    def _slot_counts(self, s: Slot) -> np.ndarray:
        """The slot's generated-token histogram, built at its first
        penalized sample (seeded from a replay's prompt tail, which the
        earlier attempt emitted and penalized) and then advanced per
        emitted token by :meth:`_emit`."""
        if s.penalty_counts is None:
            h = np.zeros((self.cfg.vocab_size,), np.int32)
            ko = s.request.params.key_offset
            if ko:
                P = s.prompt_len
                for t in s.prompt[max(0, P - ko):P]:
                    h[int(t)] += 1
            for t in s.generated:
                h[t] += 1
            s.penalty_counts = h
        return s.penalty_counts

    def _pipe(self, slots: List[Slot], drafts=None) -> Optional[Pipe]:
        """The logit-pipeline operands of the rows of ``slots`` (one row
        each, or with ``drafts`` a verify block of spec_draft_len + 1
        rows each), or None when no slot is constrained or penalized:
        inert traffic then runs the sampler of a pipeline-free engine,
        with no (n, V) operand built or copied. The constraint rows are
        built on the host from the cached FSM tables (row j of a verify
        block: the state reached through drafts 0..j-1) and copied to
        the device with the histograms, once per step."""
        fsms = [self._slot_fsm(s) for s in slots]
        penal = [_penalties_on(s.request.params) for s in slots]
        if not any(f is not None for f in fsms) and not any(penal):
            return None
        n, V, dev = len(slots), self.cfg.vocab_size, self.device
        allowed = counts = pens = None
        if any(f is not None for f in fsms):
            L = 1 if drafts is None else self._spec_k + 1
            am = np.ones((n, L, V), bool)
            for i, (s, fsm) in enumerate(zip(slots, fsms)):
                if fsm is None:
                    continue
                st = s.fsm_state
                am[i, 0] = fsm.allowed_row(st)
                for j, t in enumerate(drafts[i] if drafts is not None else ()):
                    st = fsm.advance(st, int(t))
                    am[i, j + 1] = fsm.allowed_row(st)
            allowed = torch.as_tensor(am if drafts is not None else am[:, 0],
                                      device=dev)
        if any(penal):
            cm = np.zeros((n, V), np.int32)
            pv = np.tile(np.asarray([1.0, 0.0, 0.0], np.float32), (n, 1))
            for i, s in enumerate(slots):
                if penal[i]:
                    p = s.request.params
                    cm[i] = self._slot_counts(s)
                    pv[i] = (p.repetition_penalty, p.presence_penalty,
                             p.frequency_penalty)
            counts = torch.as_tensor(cm, device=dev)
            pens = torch.as_tensor(pv, device=dev)
        return Pipe(allowed, counts, pens)

    def _lp_width(self, slots: List[Slot]) -> int:
        """Top-list width of this step's logprob echo: the widest the
        rows ask for, capped at ``max_logprobs`` (0 = no echo)."""
        return min(max(s.request.params.logprobs for s in slots), self._lp_k)

    @staticmethod
    def _lp_pair(s: Slot, lp, n: int, j: Optional[int] = None):
        """Row n's (row n, verify row j's) echo as the (chosen logprob,
        [(id, logprob)]) pair :meth:`_emit` keeps, truncated to what the
        request asked for; None when it asked for none."""
        k = s.request.params.logprobs
        if not k or lp is None:
            return None
        chosen, ids, vals = lp
        at = (n,) if j is None else (n, j)
        return float(chosen[at]), [(int(i), float(v)) for i, v in
                                   zip(ids[at][:k], vals[at][:k])]

    # -- paged admission / release (serving/pages.py) ------------------

    def _on_retire(self, slot: Slot) -> None:
        """Scheduler retirement hook (every retire path): return the
        slot's pages and drop its drafter state."""
        if self.pages is not None:
            self._release_slot_pages(slot)
        if self.drafter is not None:
            self.drafter.release(slot.index)

    def _admit_paged(self, slot: Slot, entry, iteration: int,
                     finished: List[RequestOutput]) -> Optional[int]:
        """Scheduler admission gate: plan the request against the radix
        cache, the page pool and, when tiered, the host tier. Returns the
        cached (or restored) prefix length to skip (>= 0), None to keep
        it queued (pages short right now; the scheduler may preempt a
        lower class on this verdict and retry), or -1 after shedding it
        with a ``page_exhausted`` output."""
        request, prompt, t_submit, _deadline, trace = entry
        if request.request_id in self._resume:
            verdict = self._try_resume(slot, entry, iteration)
            if verdict == "wait":
                return None
            if verdict == "ok":
                # the whole KV image (prompt and generated) is back:
                # nothing to prefill
                return int(prompt.shape[0])
            # "restart": the image was unusable; admit afresh. Draws
            # are pure functions of (seed, t), so the recompute emits
            # the uninterrupted run's tokens
        try:
            adm = self.pages.plan_admission(
                slot.index, [int(t) for t in prompt],
                request.params.max_new_tokens)
        except PagePoolExhaustedError:
            self._drain_demotions(iteration)
            finished.append(self._shed_page_exhausted(request, prompt,
                                                      t_submit, trace))
            return -1
        # this planning call's evicted pages still hold their prefixes
        # until a copy, promote or prefill reuses them: capture first
        self._drain_demotions(iteration)
        if adm is None:
            return None
        cached = adm.cached_len
        if adm.promotes:
            cached = self._apply_promotes(adm, iteration)
        for src, dst in adm.copies:  # COW forks, before any pool call
            copy_cache_pages(self.cache, src, dst)
        return cached

    # -- host tier: demote / promote / preempt / resume ----------------
    # (serving/host_tier.py; engine thread only; lock order pool -> tier)

    def _extract_page(self, page: int) -> list:
        """One physical page as owned host tensors (per-layer leaf
        dicts): the capture side of demotion, preemption and export."""
        return extract_cache_page(self.cache, page)

    def _inject_page(self, page: int, payload) -> bool:
        """Write one host page image into physical page ``page`` (the
        promote, swap-in and import transfer), retried twice with a short
        backoff; a transfer that keeps failing returns False and the
        caller degrades to recompute, counted."""
        for attempt in range(3):
            try:
                inject_cache_page(self.cache, page, payload)
                return True
            except Exception:
                if attempt == 2:
                    return False
                time.sleep(0.005 * (attempt + 1))
        return False

    def _drain_demotions(self, iteration: int) -> None:
        """Capture the pool's pending demotions into the host tier. Runs
        right after EVERY pool planning call: the freed pages still hold
        the evicted prefixes until a later call hands them out. The
        ``page_demote_fail`` fault skips the capture: the prefixes
        degrade to recompute, counted in ``tier_fallbacks``."""
        if self._tier is None:
            return
        plans = self.pages.take_demotions()
        if not plans:
            return
        if faults.page_demote_fail_at(iteration):
            self.stats.inc("tier_fallbacks", len(plans))
            return
        for prefix, page in plans:
            if self._tier.put(prefix, self._extract_page(page)):
                self.stats.inc("tier_demotions")

    def _apply_promotes(self, adm, iteration: int) -> int:
        """Copy an admission's host-tier pages back onto the device, in
        prompt order; the first failed verify or inject truncates the
        restored prefix there and the rest prefills. The
        ``page_promote_hang`` fault stalls (``DTX_TIER_HANG_S``), then
        fails every promote."""
        ps = self.serving.kv_page_size
        ok_pages = 0
        if not faults.page_promote_hang_at(iteration):
            for dst, ent in adm.promotes:
                if not ent.verify():
                    self._tier.note_corrupt()
                    break
                if not self._inject_page(int(dst), ent.payload):
                    break
                ok_pages += 1
        if ok_pages:
            self.stats.inc("tier_promotions", ok_pages)
        if ok_pages < len(adm.promotes):
            self.stats.inc("tier_fallbacks", len(adm.promotes) - ok_pages)
        return adm.device_cached + ok_pages * ps

    def _live_pages(self, slot: Slot) -> int:
        """Pages a slot's KV has reached: after g emitted tokens the pool
        holds positions 0..P+g-2 (the last token's KV is written by its
        next step), which ceil((P+g)/ps) covers within the slot's
        allocation."""
        pos = slot.prompt_len + len(slot.generated)
        return min(-(-pos // self.serving.kv_page_size),
                   self.pages.pages_per_slot)

    def _preempt_slot(self, slot: Slot) -> None:
        """Scheduler preemption hook: stash an ACTIVE lower-priority
        slot's live pages and host state in the tier, free its pages and
        REQUEUE it with its original submit time (aging keeps accruing).
        Its later swap-in (:meth:`_try_resume`) is bit-exact."""
        rid = slot.request.request_id
        row = self.pages.table_row(slot.index)
        n_live = self._live_pages(slot)
        self._tier.stash(rid, [self._extract_page(int(row[j]))
                               for j in range(n_live)])
        self._resume[rid] = {
            "n_live": n_live,
            "generated": list(slot.generated),
            "token_times": list(slot.token_times),
            "first_token_time": slot.first_token_time,
            "filled": slot.filled,
            "cached_len": slot.cached_len,
            "spec_proposed": slot.spec_proposed,
            "spec_accepted": slot.spec_accepted,
            "prompt_ids": slot.prompt_ids,
            "penalty_counts": slot.penalty_counts,
            "token_logprobs": slot.token_logprobs,
            "top_logprobs": slot.top_logprobs,
            "fsm_state": slot.fsm_state,
        }
        self.scheduler.queue.append((slot.request, slot.prompt,
                                     slot.submit_time, slot.deadline,
                                     slot.trace))
        self.pages.release(slot.index, [], False)
        if self.drafter is not None:
            self.drafter.release(slot.index)
        self.stats.inc("preemptions")
        # reset directly: scheduler.retire would release the pages again
        slot.reset()

    def _try_resume(self, slot: Slot, entry, iteration: int) -> str:
        """Swap a preempted (or imported) request back in: reserve
        private pages for its whole KV image and inject it, CRC-verified.
        Returns "wait" (the pool cannot free enough yet), "ok" (step()
        restores the host state once plan() commits) or "restart" (the
        image was unusable: a full recompute, counted)."""
        request, prompt, _t_submit, _deadline, _trace = entry
        rid = request.request_id
        snap = self._resume[rid]
        pages = self.pages.plan_resume(
            slot.index,
            self.pages.pages_needed(int(prompt.shape[0]),
                                    request.params.max_new_tokens))
        self._drain_demotions(iteration)
        if pages is None:
            return "wait"
        # an imported snapshot carries its own (wire) page images
        migrated = "pages" in snap
        ents = snap["pages"] if migrated else self._tier.unstash(rid)
        ok = ents is not None
        if ok and faults.page_swap_corrupt_at(iteration):
            # flip one byte of the first leaf of the image in place: the
            # CRC verify below must catch it
            layer0 = ents[0].payload[0]
            leaf = layer0[next(iter(layer0))]
            leaf.reshape(-1).view(torch.uint8)[0] ^= 0xFF
        if ok:
            for pg, ent in zip(pages, ents):
                if not ent.verify():
                    if self._tier is not None:
                        self._tier.note_corrupt()
                    ok = False
                    break
                if not self._inject_page(int(pg), ent.payload):
                    ok = False
                    break
        if not ok:
            self.pages.release(slot.index, [], False)
            self._resume.pop(rid, None)
            if migrated:
                self.stats.inc("migrate_failed")
            else:
                self._tier.drop_stash(rid)
                self.stats.inc("tier_fallbacks")
            # the recompute emits every token again
            self._q_acc.pop(rid, None)
            return "restart"
        self._resumed.append((slot, snap))
        self.stats.inc("resumes")
        return "ok"

    def _restore_resumed(self) -> None:
        """Give the slots swapped in by this step's plan() their decode
        state back: the pool holds their KV again, so generation goes on
        as if never interrupted. plan() committed each as a PREFILL with
        its whole prompt filled, so no chunk was planned for it."""
        for slot, snap in self._resumed:
            for key in ("first_token_time", "filled", "cached_len",
                        "spec_proposed", "spec_accepted", "prompt_ids",
                        "penalty_counts", "token_logprobs", "top_logprobs"):
                setattr(slot, key, snap[key])
            slot.generated = list(snap["generated"])
            slot.token_times = list(snap["token_times"])
            ent = self._constraints.get(slot.request.request_id)
            if ent is not None:
                # attach the FSM here: _slot_fsm's lazy path would reset
                # the cursor to the start state
                slot.constraint = ent[1]
                slot.fsm_state = snap["fsm_state"]
            slot.state = ACTIVE
            self._resume.pop(slot.request.request_id, None)
        self._resumed = []

    def _drop_resume(self, request_id: int) -> None:
        """Forget a preempted request's swap-in state on every path that
        forgets the request (cancel, expire, shed, crash loss): a leaked
        stash would pin host-tier bytes for good."""
        self._resume.pop(request_id, None)
        if self._tier is not None:
            self._tier.drop_stash(request_id)

    # -- live migration (serving/migrate.py) ---------------------------
    # Engine thread only: the runner (serving/server.py) runs these
    # between steps.

    def _slot_for(self, request_id: int) -> Optional[Slot]:
        return next((s for s in self.scheduler.slots
                     if s.state != FREE and s.request is not None
                     and s.request.request_id == request_id), None)

    def export_slot_state(self, request_id: int, dedup_pages: int = 0) -> bytes:
        """One ACTIVE slot's whole decode state as a wire image, taken
        WITHOUT disturbing it: the slot decodes on until the destination
        acknowledges and :meth:`release_migrated` retires it.
        ``dedup_pages`` is the destination's radix probe
        (``PagePool.probe_prefix``): that many leading full prompt pages
        ship as holes the importer copies from its own pool. Raises the
        typed :class:`MigrateExportError` when there is nothing to export
        (contiguous pool; the request is queued, prefilling or done)."""
        if self.pages is None:
            raise MigrateExportError(
                "live migration needs the paged KV layout "
                "(ServingConfig.kv_page_size > 0) — fall back to replay")
        slot = self._slot_for(request_id)
        if slot is None or slot.state != ACTIVE or not slot.generated:
            raise MigrateExportError(
                f"request {request_id} holds no ACTIVE slot (queued, "
                "prefilling, or already finished) — nothing to "
                "migrate; replay or plain retry covers it",
                code="migrate_not_active")
        faults.stall("migrate_hang")
        ps = self.serving.kv_page_size
        n_live = self._live_pages(slot)
        # dedup covers only FULL pages of the PROMPT (generated tokens
        # never enter a radix tree), and a radix match stops at
        # prompt_len - 1
        dedup = max(0, min(int(dedup_pages), n_live,
                           (slot.prompt_len - 1) // ps if slot.prompt_len else 0))
        row = self.pages.table_row(slot.index)
        payloads: List[Optional[list]] = [
            None if j < dedup else self._extract_page(int(row[j]))
            for j in range(n_live)]
        now = time.perf_counter()
        meta = {
            "prompt": [int(t) for t in slot.prompt],
            "params": params_to_dict(slot.request.params),
            "generated": list(slot.generated),
            "n_live": n_live,
            "dedup_pages": dedup,
            "page_size": ps,
            "model": self.cfg.model,
            "block_size": self.cfg.block_size,
            "filled": slot.filled,
            "cached_len": slot.cached_len,
            "spec_proposed": slot.spec_proposed,
            "spec_accepted": slot.spec_accepted,
            "fsm_state": slot.fsm_state,
            "token_logprobs": slot.token_logprobs,
            "top_logprobs": slot.top_logprobs,
            "deadline_left_s": (max(0.0, slot.deadline - now)
                                if slot.deadline else 0.0),
        }
        blob = encode_slot_state(meta, payloads)
        if payloads and faults.consume("migrate_corrupt"):
            # flip one byte AFTER the page CRCs were stamped: the
            # importer's decode must convict the transfer
            torn = bytearray(blob)
            torn[-1] ^= 0xFF
            blob = bytes(torn)
        self.stats.inc("migrate_exports")
        self.stats.inc("migrate_pages_shipped", n_live - dedup)
        self.stats.inc("migrate_pages_deduped", dedup)
        self.stats.inc("migrate_bytes", len(blob))
        return blob

    def release_migrated(self, request_id: int) -> bool:
        """Retire a slot whose decode state now lives on the destination
        (the import was acknowledged). False when the request is unknown
        or finished: the local output wins."""
        slot = self._slot_for(request_id)
        if slot is None:
            return False
        self._seeds.pop(request_id, None)
        self._drop_constraint(request_id)
        self._drop_resume(request_id)
        self._q_acc.pop(request_id, None)
        self._finished_counter.inc(reason="migrated")
        if self._tracing:
            self.tracer.instant("finish", rid=request_id, reason="migrated",
                                **self._targs(slot.trace))
        # the standard retire path: the prompt's pages may go to the
        # radix cache, so the source keeps serving the prefix
        self.scheduler.retire(slot)
        return True

    def import_state(self, blob: bytes) -> int:
        """Readmit a migrated slot state: decode and CRC-verify the wire
        image (a flipped byte is convicted HERE, before the device sees
        anything), resolve dedup holes from the local radix tree, submit
        the request afresh, and register its snapshot so the paged
        admission gate injects its pages bit-exact
        (:meth:`_try_resume`). Returns the new request id. Raises
        ``MigratePayloadError`` (corrupt or torn) or
        :class:`MigrateExportError` (contiguous pool, geometry mismatch,
        dedup miss), or the submit's own errors (a constraint that does
        not compile here), leaving the engine clean."""
        if self.pages is None:
            raise MigrateExportError(
                "live migration needs the paged KV layout "
                "(ServingConfig.kv_page_size > 0)")
        meta, payloads = decode_slot_state(blob)
        if (meta.get("page_size") != self.serving.kv_page_size
                or meta.get("model") != self.cfg.model
                or meta.get("block_size") != self.cfg.block_size):
            raise MigrateExportError(
                f"geometry mismatch: wire (model={meta.get('model')}, "
                f"block={meta.get('block_size')}, "
                f"page={meta.get('page_size')}) vs engine "
                f"(model={self.cfg.model}, block={self.cfg.block_size},"
                f" page={self.serving.kv_page_size})",
                code="migrate_geometry")
        prompt = [int(t) for t in meta["prompt"]]
        dedup = int(meta.get("dedup_pages", 0))
        if dedup:
            # resolve the holes now: no planning call runs before the
            # submit below, so the chain cannot be evicted under us
            chain = self.pages.chain_pages(prompt, dedup)
            if chain is None:
                self.stats.inc("migrate_failed")
                raise MigrateExportError(
                    f"dedup chain ({dedup} pages) no longer cached — "
                    "evicted between probe and import; source retries "
                    "without dedup or falls back to replay",
                    code="migrate_dedup_miss")
            for j, pg in enumerate(chain):
                payloads[j] = self._extract_page(int(pg))
        params = params_from_dict(meta["params"])
        left = float(meta.get("deadline_left_s") or 0.0)
        rid = self.submit(prompt, params=params,
                          deadline=(time.perf_counter() + left) if left else None)
        self._resume[rid] = {
            "n_live": int(meta["n_live"]),
            "generated": [int(t) for t in meta["generated"]],
            # host timestamps do not survive the hop: token times restart
            # on this clock
            "token_times": [],
            "first_token_time": time.perf_counter(),
            "filled": int(meta["filled"]),
            "cached_len": int(meta["cached_len"]),
            "spec_proposed": int(meta.get("spec_proposed", 0)),
            "spec_accepted": int(meta.get("spec_accepted", 0)),
            "prompt_ids": None,
            "penalty_counts": None,  # _slot_counts rebuilds it lazily
            "token_logprobs": meta.get("token_logprobs"),
            "top_logprobs": (
                [[(int(i), float(v)) for i, v in alts]
                 for alts in meta["top_logprobs"]]
                if meta.get("top_logprobs") is not None else None),
            "fsm_state": int(meta.get("fsm_state", 0)),
            # wire-borne page images, injected instead of a tier stash
            "pages": [TierEntry(p) for p in payloads],
        }
        self.stats.inc("migrate_imports")
        return rid

    def progress_snapshot(self) -> List[dict]:
        """Each in-flight request's emitted tokens so far: the
        ``GET /inflight`` body a router harvests into its replay journal
        (serving/migrate.py:ReplayJournal). A journal needs only a
        PREFIX of the emitted tokens, so lagging a step is correct."""
        out = []
        for s in self.scheduler.slots:
            if s.state == FREE or s.request is None:
                continue
            out.append({"request_id": s.request.request_id,
                        "prompt_len": s.prompt_len,
                        "tokens": list(s.generated)})
        for req, prompt, _t, _dl, _tr in list(self.scheduler.queue):
            out.append({"request_id": req.request_id,
                        "prompt_len": int(prompt.shape[0]), "tokens": []})
        return out

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

    def _shed_page_exhausted(self, request, prompt, submit_time: float,
                             trace=None) -> RequestOutput:
        """A request the page pool refused (never fits now, or the
        ``page_exhaust`` fault): shed at admission with a typed output
        the server maps to HTTP 503 ``page_pool_exhausted``;
        ``retry_after`` comes from the pool's observed drain rate."""
        self._seeds.pop(request.request_id, None)
        self._drop_constraint(request.request_id)
        self._drop_resume(request.request_id)
        self._q_acc.pop(request.request_id, None)
        self.stats.inc("page_shed")
        self._finished_counter.inc(reason="page_exhausted")
        if self._tracing:
            self.tracer.instant("finish", rid=request.request_id,
                                reason="page_exhausted", **self._targs(trace))
        return RequestOutput(
            request_id=request.request_id,
            prompt=[int(t) for t in prompt],
            tokens=[],
            finish_reason="page_exhausted",
            submit_time=submit_time,
            first_token_time=0.0,
            finish_time=time.perf_counter(),
            trace_id=trace.trace_id if trace is not None else None,
            retry_after=self.pages.estimated_drain_s(self.pages.pages_needed(
                len(prompt), request.params.max_new_tokens)),
        )

    # -- fault injection (utils/faults.py) ------------------------------

    @staticmethod
    def _poison(key: str, t: torch.Tensor, idx) -> None:
        """NaN-poison rows ``idx`` of one cache leaf in place (int8 values
        go to 0 while their fp32 scale planes go NaN, so every
        dequantized read is NaN)."""
        ix = (slice(None), idx) if KV_CACHE_BATCH_AXIS[key] else idx
        t[ix] = float("nan") if t.is_floating_point() else 0

    def _poison_pages(self, pages: List[int]) -> None:
        """NaN-poison the given physical pages across every layer and
        leaf."""
        idx = torch.as_tensor(pages, device=self.device)
        for layer in self.cache:
            for key, t in layer.items():
                self._poison(key, t, idx)

    def _corrupt_one_slot(self) -> None:
        """The ``serve_corrupt@N`` fault: NaN-poison one occupied slot's
        KV rows, preferring an ACTIVE slot (whose written keys are
        visible), so the next decode's logits go NaN and the
        finite-logits guard raises the typed crash."""
        target = next(
            (s for s in self.scheduler.slots if s.state == ACTIVE), None
        ) or next(
            (s for s in self.scheduler.slots
             if s.state != FREE and s.filled > 0), None)
        if target is None:
            return
        i = target.index
        if self.pages is not None:
            # paged: the slot's KV lives in the pages its table row names
            row = [int(p) for p in self.pages.table_row(i)
                   if int(p) != PagePool.TRASH]
            if row:
                self._poison_pages(row)
            return
        for layer in self.cache:
            for key, t in layer.items():
                self._poison(key, t, i)

    def _corrupt_cached_prefix(self) -> None:
        """The ``prefix_corrupt@N`` fault: NaN-poison one radix-cached
        page, preferring one shared with an occupied slot, so the next
        decode trips the finite-logits guard; the supervised restart
        then rebuilds the pool and evicts the poisoned prefix."""
        cached = set(self.pages.cached_pages())
        if not cached:
            return
        tables = self.pages.tables()
        target = None
        for s in self.scheduler.slots:
            if s.state == FREE:
                continue
            for pg in tables[s.index]:
                if int(pg) in cached:
                    target = int(pg)
                    break
            if target is not None:
                break
        if target is None:
            target = next(iter(cached))
        self._poison_pages([target])

    # -- emission / retirement -----------------------------------------

    @staticmethod
    def _targs(trace) -> dict:
        return instant_args(trace) if trace is not None else {}

    def _emit(self, slot: Slot, token: int, now: float,
              finished: List[RequestOutput], em=None, lp=None) -> None:
        """Append one token; ``em`` is its (entropy, margin) with quality
        on, ``lp`` its (chosen logprob, [(id, logprob)]) echo when the
        request asked for one. The repetition flag compares the token
        with the one before it: the last emitted, or the last prompt
        token for the first. A slot that decodes on advances its penalty
        histogram and its FSM cursor."""
        prev_token_t = slot.token_times[-1] if slot.token_times else None
        if em is not None:
            prev = (slot.generated[-1] if slot.generated
                    else int(slot.prompt[-1]) if slot.prompt_len else -1)
            self._q_observe(slot.request.request_id, float(em[0]),
                            float(em[1]), prev >= 0 and token == prev)
        slot.generated.append(token)
        slot.token_times.append(now)
        if lp is not None:
            if slot.token_logprobs is None:
                slot.token_logprobs, slot.top_logprobs = [], []
            slot.token_logprobs.append(lp[0])
            slot.top_logprobs.append(lp[1])
        cls = slot.request.params.priority
        if len(slot.generated) == 1:
            slot.first_token_time = now
            slot.state = ACTIVE
            self._ttft_hist.observe(now - slot.submit_time)
            self._class_ttft_hist.observe(now - slot.submit_time, priority=cls)
            if self._tracing:
                self.tracer.instant("first_token", rid=slot.request.request_id,
                                    **self._targs(slot.trace))
        elif prev_token_t is not None:
            self._itl_hist.observe(now - prev_token_t)
            self._class_itl_hist.observe(now - prev_token_t, priority=cls)
        p = slot.request.params
        eos = (p.eos_token_id if p.eos_token_id is not None
               else self.serving.eos_token_id)
        hit_eos = eos is not None and token == eos
        stop_hit = False
        if not hit_eos and p.stop:
            g = slot.generated
            for seq in p.stop:
                n = len(seq)
                tail = g
                if len(g) < n and p.key_offset:
                    # a replayed continuation: a stop sequence may span
                    # the boundary (its head was emitted by the earlier
                    # attempt and rides the prompt's tail)
                    P = slot.prompt_len
                    borrow = min(n - len(g), p.key_offset, P)
                    tail = [int(t) for t in slot.prompt[P - borrow:P]] + g
                if len(tail) >= n and tuple(tail[-n:]) == seq:
                    stop_hit = True
                    break
        if hit_eos or stop_hit or len(slot.generated) >= p.max_new_tokens:
            finished.append(self._finish(
                slot,
                "eos" if hit_eos else ("stop_sequence" if stop_hit else "length"),
            ))
            return
        if slot.penalty_counts is not None:
            slot.penalty_counts[token] += 1
        if slot.constraint is not None:
            slot.fsm_state = slot.constraint.advance(slot.fsm_state, token)

    def _finish(self, slot: Slot, reason: str,
                now: Optional[float] = None) -> RequestOutput:
        rid = slot.request.request_id
        quality = None
        if self._quality:
            acc = self._q_acc.pop(rid, None)
            quality = {
                "entropy_mean": (round(acc[0] / acc[1], 6)
                                 if acc and acc[1] else None),
                "margin_mean": (round(acc[2] / acc[3], 6)
                                if acc and acc[3] else None),
                "tokens_observed": acc[1] if acc else 0,
                "rep_run_max": acc[5] if acc else 0,
            }
            if slot.spec_proposed:
                quality["spec_acceptance"] = round(
                    slot.spec_accepted / slot.spec_proposed, 4)
            if slot.request.params.constrained:
                # a dead end is the constrained path's wrong answer
                self._q_constraint_total += 1
                if reason == "constraint_dead_end":
                    self._q_constraint_bad += 1
        out = RequestOutput(
            request_id=rid,
            prompt=[int(t) for t in slot.prompt],
            tokens=list(slot.generated),
            finish_reason=reason,
            submit_time=slot.submit_time,
            first_token_time=slot.first_token_time,
            finish_time=(slot.token_times[-1] if slot.token_times
                         else (now if now is not None else time.perf_counter())),
            token_times=list(slot.token_times),
            trace_id=slot.trace.trace_id if slot.trace is not None else None,
            spec_proposed=slot.spec_proposed,
            spec_accepted=slot.spec_accepted,
            token_logprobs=(list(slot.token_logprobs)
                            if slot.token_logprobs is not None else None),
            top_logprobs=(list(slot.top_logprobs)
                          if slot.top_logprobs is not None else None),
            quality=quality,
        )
        if self._tracing:
            self.tracer.instant("finish", rid=rid, reason=reason,
                                **self._targs(slot.trace))
            # the request's submit -> finish lifetime as one span,
            # parented to the caller's traceparent hop
            self.tracer.complete(
                "request", slot.submit_time, out.finish_time, rid=rid,
                reason=reason, tokens=len(out.tokens),
                **(child_span_args(slot.trace) if slot.trace is not None
                   else {}))
        del self._seeds[rid]
        self._drop_constraint(rid)
        if reason == "deadline":
            self.stats.inc("deadline_expired")
        elif reason != "constraint_dead_end":
            # a dead end is a typed failure (HTTP 400 with the partial
            # output), counted only under its finish reason
            self.stats.inc("completed")
        self._finished_counter.inc(reason=reason)
        self.scheduler.retire(slot)
        return out

    def _expire_queued(self, request, prompt, submit_time: float,
                       now: float, trace=None) -> RequestOutput:
        """A request whose deadline passed while it waited for a slot."""
        self._seeds.pop(request.request_id, None)
        self._drop_constraint(request.request_id)
        self._drop_resume(request.request_id)
        self._q_acc.pop(request.request_id, None)
        self.stats.inc("deadline_expired")
        self._finished_counter.inc(reason="deadline")
        if self._tracing:
            self.tracer.instant("finish", rid=request.request_id,
                                reason="deadline", **self._targs(trace))
        return RequestOutput(
            request_id=request.request_id,
            prompt=[int(t) for t in prompt],
            tokens=[],
            finish_reason="deadline",
            submit_time=submit_time,
            first_token_time=0.0,
            finish_time=now,
            trace_id=trace.trace_id if trace is not None else None,
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
        radix tree start empty and the drafter forgets its maps. The
        registry and its counts survive, ``engine_restarts`` counting the
        rebuilds. Params are never written in place, so the rebuilt pool
        starts from the same weights."""
        lost: List[int] = []
        for slot in self.scheduler.slots:
            if slot.state != FREE and slot.request is not None:
                rid = slot.request.request_id
                lost.append(rid)
                self._seeds.pop(rid, None)
                self._drop_constraint(rid)
                self._drop_resume(rid)
                self._q_acc.pop(rid, None)
        preserved = list(self.scheduler.queue)
        self._resumed = []
        if self._tier is not None:
            # cached prefixes are as untrusted as the pool they came from
            # (a poisoned page demotes with a valid CRC); stashes survive,
            # their owners ride the preserved queue and resume bit-exact
            self._tier.clear_cache()
        if self.pages is not None:
            self.pages.reset()
        if self.drafter is not None:
            self.drafter.reset()
        self.cache = self._new_cache()
        self.scheduler = self._new_scheduler()
        self.scheduler.queue.extend(preserved)
        self.stats.inc("engine_restarts")
        # the crashed step never reached its gauge refresh
        self._update_gauges()
        return lost
