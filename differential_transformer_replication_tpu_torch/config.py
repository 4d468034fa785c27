"""Configuration dataclasses of the PyTorch port.

A copy of the JAX package's ``ModelConfig`` (every field, so a saved
model config carries over unchanged), of the ``ServingConfig`` fields
the serving slices read (the slot pool, the paged KV pool with its
radix prefix cache, the int8 KV cache and n-gram speculative decoding),
of ``RouterConfig`` (the fleet router's and predictive admission's
knobs), of ``AutoscalerConfig`` (the control plane's), and of
``TrainConfig``
(``differential_transformer_replication_tpu/config.py``), whose fields
of later slices must stay at their defaults. The port keeps its own
copy: it imports nothing of the JAX package.

Kernel dispatch in the port is by DEVICE, not by these fields: every
kernel wrapper (``ops/fused_norm_residual.py``, ``ops/fused_ffn.py``,
``ops/flash.py``, ``ops/decode_attention.py``) launches its hand-written
GPU kernel for a CUDA tensor and runs its plain PyTorch version only for
a CPU tensor. ``attention_impl``, ``ffn_impl`` and
``decode_attention_impl`` are kept, and validated, so that configs
round-trip between the two packages, but no value of them can put a
plain version on the card's path.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

MODEL_KINDS = ("control", "diff", "ndiff")
# what a rematerialized block may save (models/common.py:remat_block)
REMAT_POLICIES = ("none", "dots", "dots_no_batch", "nothing", "everything")


@dataclass(frozen=True)
class ModelConfig:
    """Hyperparameters shared by all three model families (the reference
    recipe's defaults: 8 layers, width 768, T=512, vocab 12000)."""

    model: str = "control"  # one of MODEL_KINDS
    vocab_size: int = 12000
    n_embd: int = 768
    n_head: int = 4  # the *diff* head count
    n_layer: int = 8
    block_size: int = 512
    dropout: float = 0.0
    n_terms: int = 4  # ndiff streams
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # Training attention backend of the JAX package ("xla" | "pallas");
    # carried for config round-trips: the port's training attention
    # (ops/flash.py) dispatches by device.
    attention_impl: str = "xla"
    # "xla" | "pallas" in the JAX package. The port validates the value
    # and otherwise ignores it: its fused add+LayerNorm and SwiGLU
    # wrappers always launch their GPU kernels on a CUDA tensor and run
    # their plain versions only on a CPU tensor.
    ffn_impl: str = "xla"
    # "xla" | "pallas" in the JAX package; same rule: the port's
    # decode-attention wrapper dispatches by device, never by this field.
    decode_attention_impl: str = "xla"
    # KV-cache storage dtype: "auto" stores compute_dtype, "bf16" forces
    # bfloat16, "int8" stores symmetric per-vector int8 values plus fp32
    # scale planes (ops/decode_attention.py:quantize_kv).
    kv_cache_dtype: str = "auto"
    sequence_impl: str = "ring"
    # Recompute each block's activations in the backward
    # (models/common.py:remat_block); remat_policy picks what a block may
    # save instead and acts only when remat is true, as in JAX.
    remat: bool = False
    remat_policy: str = "none"
    # Positions per chunk of the chunked lm-head loss
    # (ops/losses.py:fused_linear_cross_entropy); None: the dense loss.
    loss_chunk: Optional[int] = None

    def __post_init__(self):
        if self.model not in MODEL_KINDS:
            raise ValueError(f"model must be one of {MODEL_KINDS}, got {self.model!r}")
        for name in ("attention_impl", "ffn_impl", "decode_attention_impl"):
            if getattr(self, name) not in ("xla", "pallas"):
                raise ValueError(
                    f"{name} must be 'xla' or 'pallas', got "
                    f"{getattr(self, name)!r}"
                )
        if self.kv_cache_dtype not in ("auto", "bf16", "int8"):
            raise ValueError(
                "kv_cache_dtype must be one of auto|bf16|int8, got "
                f"{self.kv_cache_dtype!r}"
            )
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                "remat_policy must be one of none|dots|dots_no_batch|"
                f"nothing|everything, got {self.remat_policy!r}"
            )
        if self.sequence_impl not in ("ring", "ulysses"):
            raise ValueError(
                "sequence_impl must be 'ring' or 'ulysses', got "
                f"{self.sequence_impl!r}"
            )
        if self.loss_chunk is not None and self.loss_chunk < 1:
            raise ValueError(f"loss_chunk must be positive, got {self.loss_chunk}")
        if self.model == "ndiff" and self.n_terms < 1:
            raise ValueError("n_terms must be >= 1")

    @property
    def head_size(self) -> int:
        """Per-head query/key width; halved for the differential
        variants, whose heads carry a doubled value."""
        if self.model == "control":
            return self.n_embd // self.n_head
        return self.n_embd // (self.n_head * 2)

    @property
    def value_size(self) -> int:
        """Per-head value width: doubled for the differential variants."""
        if self.model == "control":
            return self.head_size
        return self.head_size * 2

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ServingConfig:
    """Continuous-batching engine knobs (serving/engine.py). Same names,
    defaults, meaning and validation as the JAX package's ServingConfig
    for the fields kept: the slot pool, the paged KV pool and its radix
    prefix cache, the int8 KV cache, speculative decoding and the quality
    telemetry, the host-RAM page tier, the model drafter and structured
    decoding (``max_logprobs``, ``constraint_cache_entries``). Its
    profiling fields are absent."""

    # Fixed decode batch = KV slot pool size.
    num_slots: int = 8
    # Largest single prefill chunk; prompts split into descending
    # power-of-two chunks no larger than this.
    prefill_chunk: int = 128
    # Max prompt tokens prefilled per engine iteration, across admissions.
    prefill_budget: int = 256
    # RoPE table length = cap on prompt + generated tokens for control/
    # ndiff (0 = block_size). The diff family is always capped at
    # block_size: its learned position table cannot roll.
    max_seq_len: int = 0
    eos_token_id: Optional[int] = None
    # Reject submissions past this many waiting requests (0 = unbounded).
    max_queue_len: int = 0
    default_deadline_s: float = 0.0
    drain_timeout_s: float = 30.0
    max_restarts: int = 3
    restart_backoff_s: float = 0.5
    restart_backoff_max_s: float = 30.0
    step_time_budget_s: float = 0.0
    # Anti-starvation aging for priority scheduling: a queued request's
    # effective rank improves by one class per this many seconds waited.
    priority_aging_s: float = 10.0
    # Per-class concurrent-slot bounds, "class:N,class:N" ("" = none).
    priority_max_slots: str = ""
    # Serving-side override of ModelConfig.kv_cache_dtype ("" = inherit).
    # (The JAX package's decode_attention_impl override is absent: the
    # port's kernels dispatch by device, so it would select nothing.)
    kv_cache_dtype: str = ""
    # Paged KV cache (serving/pages.py): tokens per page (must divide
    # block_size); 0 = the contiguous per-slot rings. Admission then keys
    # on free pages, not slots.
    kv_page_size: int = 0
    # Physical pages in the pool (one trash page is added on top); 0 =
    # num_slots * block_size / kv_page_size + prefix_cache_pages.
    kv_pool_pages: int = 0
    # Radix-tree shared-prefix reuse over retired prompts' pages (paged
    # pool only): a request sharing a cached prefix skips its prefill.
    prefix_cache: bool = True
    # Extra pool pages kept as cached-prefix headroom.
    prefix_cache_pages: int = 0
    # Speculative decoding (serving/spec.py): "" = off, "ngram" = the
    # prompt-lookup drafter, "model" = a small checkpoint (ModelDrafter)
    # on its own slot pool; the target verifies up to spec_draft_len
    # drafted tokens per slot in one k+1-row pool step.
    spec_mode: str = ""
    spec_draft_len: int = 4
    # Drafter checkpoint dir for spec_mode == "model", loaded beside the
    # target's params through load_params_for_inference (manifest
    # verification and int8 weights apply to it too).
    spec_drafter_ckpt: str = ""
    # Verify formulation (models/decode.py:forward_decode_spec): "exact"
    # unrolls k+1 L=1 steps (greedy output bit-identical to no spec);
    # "batched" runs all rows in one pass through the multi-row kernel.
    spec_verify: str = "exact"
    # Host-RAM KV page tier (serving/host_tier.py). 0 = off. > 0 (paged
    # pool only) = evicted full radix pages DEMOTE into host memory up to
    # this many bytes instead of vanishing, admissions matching a demoted
    # prefix PROMOTE it back with a copy, and a blocked higher-priority
    # admission may preempt a lower-priority slot (its pages stashed
    # here, swapped back in bit-exact later).
    host_tier_bytes: int = 0
    # Structured decoding (serving/constrain.py): the cap on the top-N
    # alternatives a request may ask to echo per token
    # (SamplingParams.logprobs; larger asks are truncated to it), and the
    # number of compiled constraint FSMs the cache holds (refcounted;
    # refcount-0 entries LRU-evict past the bound).
    max_logprobs: int = 5
    constraint_cache_entries: int = 32
    # Model-quality telemetry (obs/quality.py). When on, the sampler and
    # the verify's accept compute a per-token quality vector (sampled-
    # distribution entropy, top-1 logit margin, repetition flag —
    # models/decode.py:quality_vector) on the device and bring it to the
    # host with the tokens; the engine folds it into the
    # serving_token_entropy / serving_logit_margin histograms,
    # RequestOutput.quality, the serving_lambda_mean gauges and the
    # serving_quality_drift gauge against the fingerprint below. Tokens
    # are bit-identical with it on or off.
    quality_telemetry: bool = False
    # Path to a reference quality fingerprint JSON (``--quality-record``
    # of a known-good window, from either package): the PSI drift of the
    # live entropy/margin sketches against it is serving_quality_drift.
    # "" = no reference (drift 0).
    quality_fingerprint: str = ""

    def __post_init__(self):
        if self.kv_cache_dtype not in ("", "auto", "bf16", "int8"):
            raise ValueError(
                "kv_cache_dtype must be ''|auto|bf16|int8, got "
                f"{self.kv_cache_dtype!r}"
            )
        for name in ("kv_page_size", "kv_pool_pages", "prefix_cache_pages"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"{name} must be >= 0, got {getattr(self, name)}"
                )
        if self.spec_mode not in ("", "ngram", "model"):
            raise ValueError(
                "spec_mode must be ''|'ngram'|'model', got "
                f"{self.spec_mode!r}"
            )
        if self.spec_mode and self.spec_draft_len < 1:
            raise ValueError(
                f"spec_draft_len must be >= 1 with spec_mode set, got "
                f"{self.spec_draft_len}"
            )
        if self.spec_verify not in ("exact", "batched"):
            raise ValueError(
                "spec_verify must be 'exact'|'batched', got "
                f"{self.spec_verify!r}"
            )
        if self.host_tier_bytes < 0:
            raise ValueError(
                f"host_tier_bytes must be >= 0, got {self.host_tier_bytes}"
            )
        if self.max_logprobs < 1:
            raise ValueError(
                f"max_logprobs must be >= 1, got {self.max_logprobs}"
            )
        if self.constraint_cache_entries < 1:
            raise ValueError(
                "constraint_cache_entries must be >= 1, got "
                f"{self.constraint_cache_entries}"
            )
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {self.num_slots}")
        if self.max_queue_len < 0:
            raise ValueError(
                f"max_queue_len must be >= 0, got {self.max_queue_len}"
            )
        for name in ("default_deadline_s", "drain_timeout_s",
                     "restart_backoff_s", "restart_backoff_max_s",
                     "step_time_budget_s"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"{name} must be >= 0, got {getattr(self, name)}"
                )
        if self.max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {self.max_restarts}"
            )
        if self.prefill_chunk < 1 or (
            self.prefill_chunk & (self.prefill_chunk - 1)
        ):
            raise ValueError(
                f"prefill_chunk must be a positive power of two, got "
                f"{self.prefill_chunk}"
            )
        if self.prefill_budget < 1:
            raise ValueError(
                f"prefill_budget must be >= 1, got {self.prefill_budget}"
            )
        if self.max_seq_len < 0:
            raise ValueError(f"max_seq_len must be >= 0, got {self.max_seq_len}")
        if self.priority_aging_s < 0:
            raise ValueError(
                f"priority_aging_s must be >= 0, got {self.priority_aging_s}"
            )
        self.priority_slot_bounds()  # validate the spec string eagerly

    def priority_slot_bounds(self) -> dict:
        """Parsed ``priority_max_slots``: {class: max concurrent slots}.
        Raises on unknown classes or malformed entries."""
        bounds: dict = {}
        if not self.priority_max_slots:
            return bounds
        valid = ("high", "normal", "batch")
        for part in self.priority_max_slots.split(","):
            part = part.strip()
            if not part:
                continue
            cls, sep, n = part.partition(":")
            cls = cls.strip()
            if not sep or cls not in valid:
                raise ValueError(
                    "priority_max_slots entries must be 'class:N' with "
                    f"class in {valid}, got {part!r}"
                )
            try:
                bound = int(n)
            except ValueError:
                raise ValueError(
                    f"priority_max_slots bound must be an int, got {n!r}"
                )
            if bound < 1:
                raise ValueError(
                    f"priority_max_slots bound must be >= 1, got {bound}"
                )
            bounds[cls] = bound
        return bounds

    def paged(self) -> bool:
        """Whether the engine runs the paged KV pool."""
        return self.kv_page_size > 0

    def tiered(self) -> bool:
        """Whether the engine runs the host-RAM page tier (and with it
        mid-decode preemption)."""
        return self.paged() and self.host_tier_bytes > 0

    def spec_enabled(self) -> bool:
        """Whether the engine runs speculative decoding."""
        return bool(self.spec_mode)

    def resolved_pool_pages(self, model: ModelConfig) -> int:
        """Physical pages EXCLUDING the trash page: explicit
        ``kv_pool_pages`` or the contiguous-equivalent sizing, plus the
        prefix-cache headroom."""
        if not self.paged():
            return 0
        if model.block_size % self.kv_page_size:
            raise ValueError(
                f"kv_page_size ({self.kv_page_size}) must divide "
                f"block_size ({model.block_size})"
            )
        per_slot = model.block_size // self.kv_page_size
        base = self.kv_pool_pages or self.num_slots * per_slot
        return base + self.prefix_cache_pages

    def resolved_max_seq_len(self, model: ModelConfig) -> int:
        """Hard cap on prompt + generated length for this model family."""
        if model.model == "diff":
            return model.block_size
        return max(self.max_seq_len, model.block_size)

    def replace(self, **kw) -> "ServingConfig":
        return dataclasses.replace(self, **kw)


# the mesh axes the port does not run yet -> the ROADMAP item that brings it
LATER_MESH_AXES = {
    "data": "data parallelism (ROADMAP Queue A: parallelism, DDP/FSDP)",
    "fsdp": "FSDP (ROADMAP Queue A: parallelism, DDP/FSDP)",
    "tensor": "tensor parallelism (ROADMAP Queue A: parallelism)",
    "pipeline": "pipeline parallelism (ROADMAP Queue A: parallelism)",
}


@dataclass(frozen=True)
class RouterConfig:
    """Multi-replica router knobs (serving/router.py).

    A copy of the JAX package's ``RouterConfig``: every field, default
    and check, so one set of knobs means the same fleet in either
    package.

    The router is the fleet-level robustness layer over N single-engine
    replicas: it probes each replica's ``/ready`` + ``/metrics``, spreads
    ``/generate`` traffic with a power-of-two-choices picker over passive
    load scores, fails retriable replies over to a DIFFERENT replica
    under a total per-request deadline, and (optionally) hedges requests
    stuck past a p99-derived latency budget. All knobs are host-side —
    nothing here touches device code or compile caches.
    """

    # -- active health probing ----------------------------------------
    # Seconds between probes of a replica whose last probe succeeded.
    probe_interval_s: float = 0.5
    # Per-probe HTTP timeout (GET /ready, GET /metrics).
    probe_timeout_s: float = 2.0
    # A FAILING replica is probed with exponential backoff: first retry
    # after probe_backoff_s, doubling up to probe_backoff_max_s — a dead
    # host is not hammered at the healthy cadence.
    probe_backoff_s: float = 0.5
    probe_backoff_max_s: float = 10.0
    # Consecutive probe/request transport failures before the replica is
    # EJECTED (never picked, probed on the backoff schedule).
    eject_after: int = 3
    # Slow re-admission: an ejected replica must pass this many
    # consecutive probes before it takes traffic again (a flapping host
    # does not oscillate in and out of rotation on one lucky probe).
    readmit_after: int = 2

    # -- failover / retry ----------------------------------------------
    # Max failover ATTEMPTS per request (first attempt included).
    # Attempts prefer distinct replicas, but when nothing un-tried is
    # eligible a recovered already-tried replica may be re-tried — so
    # on a small fleet this bounds attempts, not distinct replicas.
    max_attempts: int = 3
    # Total per-request wall-clock budget at the router (seconds),
    # bounding first attempt + backoffs + failovers; a client deadline_s
    # tightens it further. 0 = unbounded.
    default_deadline_s: float = 120.0
    # Jittered-backoff envelope between failover attempts
    # (serving/retry.py:backoff_delay semantics).
    retry_base_s: float = 0.05
    retry_cap_s: float = 1.0
    # Honored Retry-After values are capped here — a replica asking for
    # a 30 s drain-budget wait must not stall a request that another
    # replica could serve right now (and a buggy/hostile header must
    # never park the router for minutes).
    retry_after_cap_s: float = 2.0

    # -- hedging -------------------------------------------------------
    # Fire a second (hedged) attempt on a different replica when the
    # first has been in flight longer than hedge_factor * observed-p99
    # latency (floored at hedge_min_s). First reply wins. 0 = off.
    hedge_factor: float = 0.0
    hedge_min_s: float = 0.25

    # -- load scoring (power-of-two-choices inputs) --------------------
    # score = queue_weight * queue_depth/slots
    #       + slot_weight  * slot_occupancy/slots
    #       + kv_weight    * kv_utilization
    #       + inflight/slots   (router-side, always on: the passive
    #         metrics are probe-stale; in-flight counts are not)
    queue_weight: float = 1.0
    slot_weight: float = 1.0
    kv_weight: float = 0.5

    # -- admission shedding / affinity ---------------------------------
    # Before shedding (or failing a mid-failover request), wait up to
    # this long for SOME replica to become eligible — it bridges the
    # sub-second windows where a rolling restart has one replica
    # draining and the other not yet re-admitted. Bounded additionally
    # by the request's deadline. 0 = shed immediately.
    wait_for_replica_s: float = 2.0
    # Retry-After sent when the router itself sheds (zero eligible
    # replicas, or every eligible replica already tried and failed).
    shed_retry_after_s: float = 1.0
    # Sticky session routing: requests carrying a "session_id" stick to
    # one replica (prefix-cache locality groundwork, ROADMAP item 1)
    # and fail over — with re-pinning — when it dies.
    affinity: bool = True
    # The affinity map is LRU-capped at this many sessions — a router
    # fronting months of unique session_ids must not grow without
    # bound. Evicting a quiet session only costs it its pin.
    affinity_max_sessions: int = 10_000

    # -- fleet metrics staleness ---------------------------------------
    # /fleet/metrics re-serves each replica's LAST probed /metrics body.
    # Bodies older than this are EXCLUDED from the aggregation (a
    # blackholed replica's hour-old counters must not be silently judged
    # as current); every replica's age is stamped as a
    # fleet_scrape_age_seconds gauge so downstream judges
    # (tools/slo_report.py --max-scrape-age, the autoscaler) can apply
    # their own bound. 0 = legacy unbounded behavior.
    metrics_max_age_s: float = 10.0

    # -- live migration / resume-by-replay (serving/migrate.py) --------
    # Total wall-clock budget for migrating ONE slot (destination probe
    # + export + checksummed transfer + import ACK). A migration that
    # cannot land within it falls back to replay — the request is never
    # harmed either way. 0 disables migration: drain degrades to the
    # replay/plain-retry rungs only.
    migrate_budget_s: float = 10.0
    # A migrated continuation can be migrated AGAIN while the router is
    # following it (one-at-a-time rolling restarts drain the destination
    # next); /migrate/await then answers another forwarding pointer.
    # The router follows the chain up to this many hops before falling
    # back to the replay rung — a bound, not a retry count, so a
    # pathological ping-pong can never loop forever.
    migrate_max_hops: int = 4
    # Per-request cap on journaled emitted tokens (ReplayJournal). A
    # runaway generation stops growing its entry; replay then degrades
    # gracefully to a longer — still bit-exact — re-decode of the tail.
    replay_journal_max_tokens: int = 4096
    # Finished-entry LRU size: journal ids of completed requests are
    # remembered this long so late duplicate replies resolve without
    # re-registering, bounded against months of unique requests.
    replay_journal_max_finished: int = 1024

    # -- predictive admission (serving/admission.py) -------------------
    # When on, the router's shed paths (no_replica, exhausted failover,
    # proactive admission sheds) compute an HONEST Retry-After from
    # fleet-wide capacity — backlog at-or-above the request's priority
    # class divided by the MEASURED fleet service rate — instead of the
    # static shed_retry_after_s. Falls back to the static value until
    # enough traffic has been observed to measure a rate.
    admission_predictive: bool = True
    # EWMA halflife for the measured fleet service rate (req/s).
    admission_rate_halflife_s: float = 10.0
    # Cap on the computed Retry-After (a deep backlog must answer "come
    # back in 30 s", not "come back in an hour" — clients treat large
    # values as outages).
    admission_max_retry_after_s: float = 30.0
    # Proactive shedding: reject a request whose PREDICTED wait
    # (backlog ahead of its class / service rate) exceeds this bound
    # scaled by its class multiplier (high 2x, normal 1x, batch 0.5x —
    # batch sheds first, high last). 0 = never shed proactively; the
    # honest Retry-After still applies to organic sheds.
    admission_wait_bound_s: float = 0.0

    def __post_init__(self):
        for name in ("probe_interval_s", "probe_timeout_s",
                     "probe_backoff_s", "probe_backoff_max_s",
                     "default_deadline_s", "retry_base_s", "retry_cap_s",
                     "retry_after_cap_s", "hedge_factor", "hedge_min_s",
                     "queue_weight", "slot_weight", "kv_weight",
                     "wait_for_replica_s", "shed_retry_after_s",
                     "metrics_max_age_s", "migrate_budget_s",
                     "admission_rate_halflife_s",
                     "admission_max_retry_after_s",
                     "admission_wait_bound_s"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"{name} must be >= 0, got {getattr(self, name)}"
                )
        if self.eject_after < 1:
            raise ValueError(
                f"eject_after must be >= 1, got {self.eject_after}"
            )
        if self.readmit_after < 1:
            raise ValueError(
                f"readmit_after must be >= 1, got {self.readmit_after}"
            )
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )
        if self.affinity_max_sessions < 1:
            raise ValueError(
                f"affinity_max_sessions must be >= 1, got "
                f"{self.affinity_max_sessions}"
            )
        if self.migrate_max_hops < 1:
            raise ValueError(
                f"migrate_max_hops must be >= 1, got "
                f"{self.migrate_max_hops}"
            )
        for name in ("replay_journal_max_tokens",
                     "replay_journal_max_finished"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"{name} must be >= 0, got {getattr(self, name)}"
                )

    def replace(self, **kw) -> "RouterConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class AutoscalerConfig:
    """Fleet control-plane knobs (serving/autoscaler.py).

    A copy of the JAX package's ``AutoscalerConfig``: every field,
    default and check, so one set of knobs steers the same fleet in
    either package.

    The autoscaler closes the loop over surfaces that already exist:
    it polls the router's ``/fleet/metrics``, judges windowed SLO burn
    (obs/slo.py semantics) plus queue/KV utilization, and actuates
    replica count through serving/fleet.py's chaos-proven drain/relaunch
    machinery. Hysteresis (sustain counts), per-direction cooldowns and
    hard min/max bounds make the state machine immune to a flapping
    signal by construction — tests/test_torch_autoscaler.py drives it
    with synthetic burn traces and the ``scale_flap`` fault.
    """

    # Seconds between /fleet/metrics polls (one control tick each).
    poll_interval_s: float = 1.0
    # Hard replica-count bounds. The autoscaler never drains the fleet
    # below min_replicas (even at zero load) and never grows it past
    # max_replicas (even at infinite burn).
    min_replicas: int = 1
    max_replicas: int = 4
    # Scale-up trigger: windowed burn rate above this (1.0 = the SLO
    # error budget is being spent exactly as provisioned) OR
    # utilization above util_high, sustained for scale_up_sustain
    # consecutive ticks.
    scale_up_burn: float = 1.0
    # Scale-down trigger: burn below this AND utilization below
    # util_low, sustained for scale_down_sustain consecutive ticks.
    # The asymmetry (down needs a longer streak) is deliberate: adding
    # capacity late sheds traffic, removing it late only costs money.
    scale_down_burn: float = 0.5
    scale_up_sustain: int = 3
    scale_down_sustain: int = 6
    # Per-direction cooldowns: after any scale action, no further
    # action in that direction until this much time has passed (the
    # fleet must re-equilibrate before the signal is trusted again).
    cooldown_up_s: float = 5.0
    cooldown_down_s: float = 15.0
    # Utilization score thresholds: the score is the max of fleet
    # queue-pressure (queued / total slots), mean KV utilization and
    # mean host-tier utilization over FRESH replicas.
    util_high: float = 0.85
    util_low: float = 0.30
    # Metrics bodies older than this (per-replica scrape_age_seconds)
    # are treated as MISSING, not current — a blackholed replica must
    # not feed the control loop hour-old numbers.
    stale_after_s: float = 5.0
    # SLO objective bounds used for the windowed burn computation
    # (same semantics as slo_report's --ttft/--itl/--target).
    ttft_threshold_s: float = 1.0
    itl_threshold_s: float = 0.25
    slo_target: float = 0.99

    # -- canaried rollout ----------------------------------------------
    # Traffic fraction the router splits to a designated canary
    # replica while its window runs.
    canary_fraction: float = 0.25
    # Canary observation window (seconds) before the judge rules.
    canary_window_s: float = 15.0
    # Judge: the canary must hold windowed burn at or under this...
    canary_max_burn: float = 1.0
    # ...and its TTFT p95 must not exceed the control replicas' pooled
    # p95 by more than this fraction (0.5 = +50%).
    canary_max_regress: float = 0.5
    # A verdict needs at least this many canary-served requests in the
    # window; fewer is "inconclusive" and the controller ROLLS BACK
    # (never promote on no evidence).
    canary_min_requests: int = 8
    # Quality axis (obs/quality.py): a canary whose
    # serving_quality_drift (PSI vs the fleet's reference fingerprint)
    # exceeds this rolls back even when latency is flat — the knee of
    # the conventional PSI reading ("> 0.25 = shifted"). 0 = quality
    # drift never gates (e.g. a fleet without quality telemetry).
    canary_max_drift: float = 0.25
    # ...and a canary whose constraint-validity rate falls more than
    # this far below the control replicas' rate rolls back too (a
    # checkpoint that stops satisfying its FSMs is broken regardless
    # of its latency). 0 = validity delta never gates.
    canary_max_validity_delta: float = 0.05

    def __post_init__(self):
        for name in ("poll_interval_s", "scale_up_burn",
                     "scale_down_burn", "cooldown_up_s",
                     "cooldown_down_s", "util_high", "util_low",
                     "stale_after_s", "ttft_threshold_s",
                     "itl_threshold_s", "canary_window_s",
                     "canary_max_burn", "canary_max_regress",
                     "canary_max_drift", "canary_max_validity_delta"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"{name} must be >= 0, got {getattr(self, name)}"
                )
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}"
            )
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})"
            )
        if self.scale_up_sustain < 1 or self.scale_down_sustain < 1:
            raise ValueError("sustain counts must be >= 1")
        if not 0.0 < self.slo_target < 1.0:
            raise ValueError(
                f"slo_target must be in (0, 1), got {self.slo_target}"
            )
        if not 0.0 < self.canary_fraction < 1.0:
            raise ValueError(
                f"canary_fraction must be in (0, 1), got "
                f"{self.canary_fraction}"
            )
        if self.canary_min_requests < 1:
            raise ValueError(
                f"canary_min_requests must be >= 1, got "
                f"{self.canary_min_requests}"
            )

    def replace(self, **kw) -> "AutoscalerConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class MeshConfig:
    """A copy of the JAX package's MeshConfig (the same axes, defaults and
    order). The port runs the ``sequence`` axis (ring attention over
    ``torch.distributed`` ranks, ``parallel/``); every other axis must
    stay 1 and names the ROADMAP item that brings it."""

    pipeline: int = 1
    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    sequence: int = 1

    def __post_init__(self):
        for name in ("pipeline", "data", "fsdp", "tensor", "sequence"):
            if getattr(self, name) < 1:
                raise ValueError(f"mesh axis {name} must be >= 1, got "
                                 f"{getattr(self, name)}")
        for name, item in LATER_MESH_AXES.items():
            if getattr(self, name) != 1:
                raise NotImplementedError(
                    f"MeshConfig.{name}={getattr(self, name)}: the port does "
                    f"not run {item} yet; only the sequence axis may be > 1"
                )

    @property
    def n_devices(self) -> int:
        return self.data * self.fsdp * self.tensor * self.sequence * self.pipeline


# TrainConfig fields the training slice keeps (so a JAX recipe's config
# carries over) but does not run yet: each must stay at its default, and
# the ROADMAP item that brings it is named when it does not.
LATER_SLICE_FIELDS = {
    "profile_every": "the continuous device profile (ROADMAP Queue A: "
                     "tooling and analysis, obs/device_profile.py)",
    "profile_spool_dir": "the continuous device profile (ROADMAP Queue A: "
                         "tooling and analysis, obs/device_profile.py)",
    "dp_overlap": "parallelism (ROADMAP Queue A: parallelism)",
    "dp_bucket_layers": "parallelism (ROADMAP Queue A: parallelism)",
}


@dataclass(frozen=True)
class TrainConfig:
    """The training recipe: a copy of the JAX package's TrainConfig
    (same names, defaults and meaning). The fields in
    :data:`LATER_SLICE_FIELDS` are kept for config round-trips and must
    stay at their defaults. ``mesh.sequence`` > 1 is the sequence-parallel
    ring over that many ranks (the other mesh axes are refused)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    # Optimization
    grad_acc_steps: int = 1
    micro_batch_size: int = 32
    max_iters: int = 40_000
    eval_interval: int = 500
    eval_iters: int = 200
    learning_rate: float = 3.2e-4
    min_lr: float = 6e-5
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    warmup_iters: int = 1000
    grad_clip: float = 1.0

    # The reference's quirk: training the control model doubles its head
    # count so that it roughly param-matches diff (resolved_model()).
    control_head_multiplier: int = 2

    # Data. "epoch": every window once per epoch in a fresh seeded
    # permutation (data/native.py), the JAX default; "replacement": windows
    # drawn uniformly with replacement.
    dataset: str = "tinystories"
    sampler: str = "epoch"
    num_train_samples: int = 1_000_000
    vocab_size: int = 12000
    min_frequency: int = 2
    val_fraction: float = 0.1
    tokenizer_dir: str = "tokenizer"

    profile_dir: Optional[str] = None
    profile_every: int = 0
    profile_spool_dir: str = "auto"
    metrics_port: int = 0
    trace_path: Optional[str] = None

    # Logging
    log_interval: int = 10
    wandb_project: str = "diff-transformer"
    wandb_run_name: Optional[str] = None
    use_wandb: bool = False
    metrics_path: Optional[str] = "metrics.jsonl"

    checkpoint_path: str = "best_model.ckpt"
    last_checkpoint_path: Optional[str] = "auto"
    resume_from: Optional[str] = None
    checkpoint_min_interval_s: float = 0.0
    ckpt_interval: int = 0
    ckpt_dir: str = "auto"
    ckpt_async: bool = True
    ckpt_keep_last: int = 3
    ckpt_keep_every: int = 0

    # Anomaly guard: a step whose loss or grad norm is non-finite, or
    # whose grad norm exceeds spike_factor x the EMA of good steps' norms
    # (armed after warmup_steps good steps), skips its update; every
    # check_interval steps the trainer reads the bad streak, rolls back
    # to a snapshot (taken every snapshot_interval good steps) after
    # rollback_after bad steps in a row, and aborts past max_rollbacks.
    anomaly_guard: bool = True
    anomaly_spike_factor: float = 4.0
    anomaly_ema_beta: float = 0.99
    anomaly_warmup_steps: int = 50
    anomaly_rollback_after: int = 20
    anomaly_max_rollbacks: int = 3
    anomaly_snapshot_interval: int = 200
    anomaly_check_interval: int = 10

    dp_overlap: bool = True
    dp_bucket_layers: int = 2
    # The step watchdog (train/watchdog.py): an iteration hung past
    # step_deadline_s (0 = off) writes the hang report and exits 113;
    # heartbeats (parallel/heartbeat.py) every heartbeat_interval_s in
    # heartbeat_dir, a peer silent past heartbeat_timeout_s trips it.
    step_deadline_s: float = 0.0
    hang_report_path: str = "auto"
    heartbeat_dir: Optional[str] = None
    heartbeat_interval_s: float = 1.0
    heartbeat_timeout_s: float = 10.0
    allow_inexact_resume: bool = False
    faults: Optional[str] = None

    seed: int = 1337

    def __post_init__(self):
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        for name, item in LATER_SLICE_FIELDS.items():
            if getattr(self, name) != defaults[name]:
                raise NotImplementedError(
                    f"TrainConfig.{name}={getattr(self, name)!r}: the port "
                    f"does not run {item} yet; leave it at its default "
                    f"{defaults[name]!r}"
                )
        if self.sampler not in ("epoch", "replacement"):
            raise ValueError(f"unknown sampler {self.sampler!r}")
        if self.grad_acc_steps < 1 or self.micro_batch_size < 1:
            raise ValueError("grad_acc_steps and micro_batch_size must be >= 1")
        if self.mesh.sequence > 1:
            if self.model.sequence_impl != "ring":
                raise NotImplementedError(
                    f"sequence_impl={self.model.sequence_impl!r}: the port "
                    "runs the ring only; Ulysses sequence parallelism is a "
                    "later slice (ROADMAP Queue A: parallelism)"
                )
            P, T = self.mesh.sequence, self.model.block_size
            if T % P:
                # any shard length: the chunk kernels mask rows and keys
                # past it and causal offsets off their 32-row tile grid
                raise ValueError(f"block_size {T} must split into {P} equal "
                                 "sequence shards")

    def resolved_last_checkpoint_path(self) -> Optional[str]:
        if self.last_checkpoint_path != "auto":
            return self.last_checkpoint_path
        import os

        root, ext = os.path.splitext(self.checkpoint_path)
        return f"{root}.last{ext or '.ckpt'}"

    def resolved_hang_report_path(self) -> str:
        """The watchdog's hang report (train/watchdog.py); "auto" keys it
        off checkpoint_path like the rotation tree, so concurrent runs in
        one directory never clobber each other's post-mortem."""
        if self.hang_report_path != "auto":
            return self.hang_report_path
        import os

        root, _ = os.path.splitext(self.checkpoint_path)
        return f"{root}.hang_report.json"

    def resolved_ckpt_dir(self) -> str:
        """Root of the rotating step-checkpoint tree
        (train/ckpt_writer.py); "auto" keys it off checkpoint_path like
        the rescue checkpoint, so runs never share a rotation tree."""
        if self.ckpt_dir != "auto":
            return self.ckpt_dir
        import os

        root, _ = os.path.splitext(self.checkpoint_path)
        return f"{root}.steps"

    def resolved_model(self) -> ModelConfig:
        """Apply trainer-level switches to the model config: the
        control-head-doubling quirk and the trainer's vocab_size as the
        single source of truth."""
        m = self.model
        if m.vocab_size != self.vocab_size:
            m = m.replace(vocab_size=self.vocab_size)
        if m.model == "control" and self.control_head_multiplier != 1:
            m = m.replace(n_head=m.n_head * self.control_head_multiplier)
        return m

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
