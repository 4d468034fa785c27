"""Configuration dataclasses of the PyTorch port.

A copy of the JAX package's ``ModelConfig`` (every field, so a saved
model config carries over unchanged), of the ``ServingConfig`` fields
the serving slices read (the slot pool, the paged KV pool with its
radix prefix cache, the int8 KV cache and n-gram speculative decoding),
and of ``TrainConfig``
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
    telemetry, the host-RAM page tier. Its structured-decoding and
    profiling fields are absent; the model drafter (``spec_mode="model"``)
    is refused with the ROADMAP item that brings it."""

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
    # prompt-lookup drafter; the target verifies up to spec_draft_len
    # drafted tokens per slot in one k+1-row pool step. "model" (a
    # drafter checkpoint, ModelDrafter) is refused until it is ported.
    spec_mode: str = ""
    spec_draft_len: int = 4
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
        if self.spec_mode == "model":
            raise NotImplementedError(
                "spec_mode='model' is not served by the port yet: "
                "ModelDrafter (ROADMAP Queue A: serving subsystems); use "
                "spec_mode='ngram'"
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
