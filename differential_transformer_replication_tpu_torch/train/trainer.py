"""The training loop of the port: data, steps, eval and metrics.

Counterpart of the core of ``differential_transformer_replication_tpu/
train/trainer.py``: the same recipe, eval protocol (``estimate_loss``),
log cadence and metrics.jsonl keys, on one card. Data comes from a
corpus (``cfg.dataset``: synthetic, a text file, or TinyStories where
it loads), a byte-level BPE trained on it and the encoded stream,
cached together under ``tokenizer_dir/cache-<key>/`` (the JAX
package's ``build_data`` and cache key, so either package reads the
other's cache); or from a token stream already encoded
(``train(cfg, tokens_path)``, no tokenizer).
The stream is split 90/10 and training windows are drawn in a seeded
epoch permutation (``sampler="epoch"``, data/native.py: the JAX
package's window order, step for step) or with replacement
(``sampler="replacement"``).

Checkpoints (train/checkpoint.py, the JAX package's format): the best
state at each eval whose val loss improves (``checkpoint_path``, at most
one write per ``checkpoint_min_interval_s``, a deferred one kept as a
device copy and written at exit), rotating ``step-*`` checkpoints every
``ckpt_interval`` steps (from a background writer when ``ckpt_async``),
and the last state on every exit, SIGTERM included
(``last_checkpoint_path``), each recording the tokenizer's fingerprint.
``resume_from`` (a directory, or ``auto``: the newest that verifies)
continues a run: its state, its best val loss and the epoch sampler's
position, recorded in consumed windows so a resume under another global
batch stays exact where it can (``elastic_resume_info``); a tokenizer
whose fingerprint differs from the checkpoint's is refused.

Resilience and observability, in the JAX trainer's order and under its
names: the anomaly guard's rollback to an on-device snapshot and its
abort (train/anomaly.py; a non-finite state never replaces the last
checkpoint), the fault plan (utils/faults.py: ``cfg.faults`` or
``DTX_FAULTS``), the step watchdog (train/watchdog.py: a hung iteration
writes its report and exits 113) and heartbeats (parallel/heartbeat.py:
a silent ring rank trips every other rank's watchdog), the metrics
registry and its Prometheus sidecar, the host span trace (obs/), the
per-layer lambda records at each eval (obs/introspect.py) and a 5-step
``torch.profiler`` window (utils/profiling.py).

A mesh of more than one rank (``cfg.mesh``: ``data``, ``fsdp``,
``tensor``, ``sequence``, ``pipeline``) trains on JAX's sharded path: the process is
one of the ranks started by ``torchrun``, joins the world
(``parallel/multihost.py:initialize``) and the mesh over the backend the
caller names (``parallel/mesh.py``), draws the same offsets from the same
seeds as every other rank and builds only its own rows and T-shard of
each batch (``multihost.local_batch``), and trains on them
(``parallel/dp_step.py:make_sharded_train_step``); eval runs through
the mesh. Under tensor and fsdp the state at rest is this rank's shards
(``dp_step.shard_train_state``): eval gathers the fsdp shards (its
forward takes the tensor shard), the introspection records gather the
full params, and a checkpoint gathers the full state in JAX's layout
(every rank joins the gather, rank 0 writes); a resume loads the full
state, at any mesh, and keeps this rank's shards. With ``pipeline`` > 1
the run takes JAX's pipeline path (``parallel/pipeline.py``): each rank
holds its stage's layers, eval streams its ``eval_iters`` batches
through the stages as one microbatch stream, the anomaly guard, NaN
injection and the lambda records are off (as in JAX), and ``train``
returns the gathered canonical state. Only rank 0
(``multihost.is_primary``) prints and writes; the mesh is left on exit
and on error.
"""

from __future__ import annotations

import dataclasses
import math
import os
import signal
import time
from typing import Optional

import numpy as np
import torch

from differential_transformer_replication_tpu_torch.config import TrainConfig
from differential_transformer_replication_tpu_torch.data.native import EpochPermutation
from differential_transformer_replication_tpu_torch.data.sampler import (
    TokenWindows,
    split_tokens,
)
from differential_transformer_replication_tpu_torch.data.corpus import (
    load_corpus_resolved,
)
from differential_transformer_replication_tpu_torch.data.tokenizer import (
    check_tokenizer_matches,
    encode_corpus,
    load_tokenizer,
    tokenizer_fingerprint,
    train_bpe_tokenizer,
)
from differential_transformer_replication_tpu_torch.models import check_card_envelope
from differential_transformer_replication_tpu_torch.obs import (
    NOOP_TRACER,
    Registry,
    SpanTracer,
    set_build_info,
    start_metrics_server,
)
from differential_transformer_replication_tpu_torch.obs.introspect import (
    lambda_record,
    make_param_summary,
)
from differential_transformer_replication_tpu_torch.ops.dropout import fold_seed
from differential_transformer_replication_tpu_torch.parallel.heartbeat import (
    FileHeartbeatTransport,
    Heartbeat,
)
from differential_transformer_replication_tpu_torch.parallel.dp_step import (
    full_params,
    full_train_state,
    make_sharded_train_step,
    model_params,
    shard_train_state,
)
from differential_transformer_replication_tpu_torch.parallel import multihost
from differential_transformer_replication_tpu_torch.parallel.mesh import (
    all_reduce_sum_,
    create_mesh,
    destroy_mesh,
)
from differential_transformer_replication_tpu_torch.parallel.pipeline import (
    make_pipeline_eval_many,
    make_pipeline_train_step,
)
from differential_transformer_replication_tpu_torch.train.anomaly import (
    TrainingDivergedError,
    restore_state,
    snapshot_state,
)
from differential_transformer_replication_tpu_torch.train.checkpoint import (
    AsyncCheckpointWriter,
    elastic_resume_info,
    load_checkpoint,
    read_meta,
    resolve_resume_auto,
    save_checkpoint,
    save_step_checkpoint,
)
from differential_transformer_replication_tpu_torch.train.metrics import (
    MetricLogger,
    config_hash,
    device_memory_mb,
)
from differential_transformer_replication_tpu_torch.train.optim import leaves
from differential_transformer_replication_tpu_torch.train.step import (
    create_train_state,
    make_eval_many,
    make_train_step,
)
from differential_transformer_replication_tpu_torch.train.watchdog import StepWatchdog
from differential_transformer_replication_tpu_torch.utils import faults
from differential_transformer_replication_tpu_torch.utils.profiling import (
    ProfilerWindow,
    Throughput,
)


def resolve_device(device) -> torch.device:
    """The entry points' device: CUDA unless the caller asks for the CPU,
    and never a silent fallback when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but CUDA is not "
                           "available; pass device='cpu' for a CPU run")
    return device


def estimate_loss(eval_many, params: dict, train_ds: TokenWindows,
                  val_ds: TokenWindows, cfg: TrainConfig,
                  rng: np.random.Generator, materialize) -> dict:
    """Mean loss over eval_iters batches of each split: train batches
    shuffled (one ``integers(size=B)`` draw per batch), val batches
    sequential from the start. ``materialize(ds, offsets)`` builds a
    batch (on a mesh this rank's share, ``multihost.local_batch``)."""
    out = {}
    for split, ds in (("train", train_ds), ("val", val_ds)):
        if split == "train":
            offs = np.stack([
                rng.integers(0, len(ds), size=cfg.micro_batch_size, dtype=np.int64)
                for _ in range(cfg.eval_iters)
            ])
        else:
            offs = np.stack([ds.sequential_offsets(k, cfg.micro_batch_size)
                             for k in range(cfg.eval_iters)])
        batch = materialize(ds, offs)
        losses = eval_many(params, batch["x"], batch["y"])
        out[split] = float(losses.to(torch.float64).mean())
    return out


def _cache_key(cfg: TrainConfig, source: str) -> str:
    """Key of the (token stream, tokenizer) cache pair: the JAX
    package's parts, over the corpus source actually used (the
    tinystories -> synthetic fallback must not poison the tinystories
    key); file datasets also key on mtime and size."""
    import hashlib

    key_parts = [
        source, str(cfg.num_train_samples), str(cfg.vocab_size),
        str(cfg.min_frequency), str(cfg.seed), "v1",
    ]
    if os.path.exists(source):
        st = os.stat(source)
        key_parts += [str(st.st_mtime_ns), str(st.st_size)]
    return hashlib.sha1("|".join(key_parts).encode()).hexdigest()[:16]


def corpus_tokens(cfg: TrainConfig, say=print) -> tuple:
    """Corpus -> tokenizer -> token stream, cached: (tokenizer, tokens).

    The encoded stream and its tokenizer live TOGETHER under
    ``tokenizer_dir/cache-<key>/``, so a cache hit can never pair a
    stream with another config's tokenizer. A miss trains the BPE,
    encodes, saves the tokenizer to ``tokenizer_dir`` itself too, and
    builds the whole entry in a scratch directory renamed into place (a
    crash or a concurrent builder never leaves a half-written entry; the
    loser of a rename race adopts the winner's). The seconds of each part
    go out in one ``[data] cache hit`` or ``[data] cache miss`` line."""
    # only "tinystories" is ambiguous (its fallback depends on the HF
    # cache and the network): probe it with a 1-document load
    if cfg.dataset == "tinystories":
        _, source = load_corpus_resolved(cfg.dataset, 1, cfg.seed)
    else:
        source = cfg.dataset

    def cache_paths(src):
        d = os.path.join(cfg.tokenizer_dir, f"cache-{_cache_key(cfg, src)}")
        return d, os.path.join(d, "tokens.npy")

    cache_dir, tokens_path = cache_paths(source)
    if os.path.exists(tokens_path):
        t0 = time.perf_counter()
        tokenizer = load_tokenizer(cache_dir)
        tokens = np.load(tokens_path)
        say(f"Loaded {len(tokens)} cached tokens from {tokens_path}")
        say(f"Vocabulary size: {tokenizer.get_vocab_size()}")
        say(f"[data] cache hit: tokenizer and stream loaded in "
            f"{time.perf_counter() - t0:.3f} s")
        return tokenizer, tokens
    t0 = time.perf_counter()
    texts, source = load_corpus_resolved(cfg.dataset, cfg.num_train_samples,
                                         cfg.seed)
    corpus_s = time.perf_counter() - t0
    # the full load may resolve differently than the probe: key on what
    # was used
    cache_dir, tokens_path = cache_paths(source)
    t0 = time.perf_counter()
    tokenizer = train_bpe_tokenizer(texts, cfg.vocab_size, cfg.min_frequency,
                                    cfg.tokenizer_dir)
    bpe_s = time.perf_counter() - t0
    say(f"Vocabulary size: {tokenizer.get_vocab_size()}")
    t0 = time.perf_counter()
    tokens = encode_corpus(tokenizer, texts)
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tmp_dir = f"{cache_dir}.tmp.{os.getpid()}"
    os.makedirs(tmp_dir, exist_ok=True)
    tokenizer.save_model(tmp_dir)
    with open(os.path.join(tmp_dir, "tokens.npy"), "wb") as f:
        np.save(f, tokens)
    try:
        os.rename(tmp_dir, cache_dir)
    except OSError:
        import shutil

        shutil.rmtree(tmp_dir, ignore_errors=True)
    say(f"[data] cache miss: {len(texts)} documents from {source} in "
        f"{corpus_s:.3f} s; BPE trained in {bpe_s:.3f} s; "
        f"{len(tokens)} tokens encoded in {encode_s:.3f} s "
        f"({len(tokens) / max(encode_s, 1e-9):.0f} tokens/s); entry written "
        f"in {time.perf_counter() - t0:.3f} s")
    return tokenizer, tokens


def ring_corpus_tokens(cfg: TrainConfig, say, group) -> tuple:
    """:func:`corpus_tokens` on a mesh of ranks (``group``: its world):
    rank 0 builds or loads the cache entry while the other ranks wait on
    one all-reduce, then they load it. So a host trains the BPE once, and
    one process writes ``tokenizer_dir``. A failure on rank 0 is raised
    on every rank."""
    if group.rank == 0:
        built = None
        try:
            built = corpus_tokens(cfg, say)
        finally:
            all_reduce_sum_(torch.tensor([0.0 if built else 1.0],
                                         device=group.device), group)
        return built
    failed = all_reduce_sum_(torch.zeros(1, device=group.device), group)
    if failed.item() > 0:
        raise RuntimeError("rank 0 could not build the corpus cache entry")
    return corpus_tokens(cfg, say)


def build_data(cfg: TrainConfig, tokens_path: Optional[str], device, say=print,
               group=None):
    """The run's data: (tokenizer or None, vocab size, train windows, val
    windows). With ``tokens_path`` the encoded stream is loaded and held
    against ``cfg.vocab_size`` (no tokenizer); without it the corpus is
    built or loaded from the cache (:func:`corpus_tokens`, through rank 0
    first on a mesh ``group``) and the vocab size is the tokenizer's. The
    stream is split 90/10."""
    tokenizer = None
    if tokens_path is None:
        tokenizer, tokens = (corpus_tokens(cfg, say) if group is None
                             else ring_corpus_tokens(cfg, say, group))
        vocab_size = tokenizer.get_vocab_size()
    else:
        tokens = np.load(tokens_path)
        say(f"Loaded {len(tokens)} cached tokens from {tokens_path}")
        if tokens.ndim != 1 or not np.issubdtype(tokens.dtype, np.integer):
            raise ValueError(f"{tokens_path}: expected a 1-D integer token stream")
        if len(tokens) and (tokens.min() < 0 or tokens.max() >= cfg.vocab_size):
            raise ValueError(f"{tokens_path}: token ids outside [0, "
                             f"{cfg.vocab_size})")
        vocab_size = cfg.vocab_size
    say(f"Total tokens: {len(tokens)}")
    train_tokens, val_tokens = split_tokens(tokens, cfg.val_fraction)
    block = cfg.model.block_size
    return (tokenizer, vocab_size, TokenWindows(train_tokens, block, device),
            TokenWindows(val_tokens, block, device))


def resolve_resume(cfg: TrainConfig, say=print, tokenizer=None) -> tuple:
    """The resume half of the JAX trainer's start: ``resume_from="auto"``
    becomes the newest checkpoint that verifies (or None: a fresh start),
    and a checkpoint's meta is held against this run
    (:func:`elastic_resume_info`; the run's tokenizer against the
    recorded vocabulary and fingerprint, or, for a pre-encoded stream,
    ``cfg.vocab_size`` against the recorded vocabulary). Returns (cfg
    with the resolved ``resume_from``, whether the load must still
    verify the digests, the elastic-resume facts or None, the number of
    checkpoints ``auto`` skipped because they failed verification)."""
    verify = True
    skipped = ()
    if cfg.resume_from == "auto":
        resolved, skipped = resolve_resume_auto(cfg)
        for p, why in skipped:
            say(f"[ckpt] skipping unverified checkpoint {p}: {why}")
        if resolved is None:
            say("[ckpt] --resume-from auto: no verified checkpoint found; "
                "starting fresh")
        else:
            say(f"[ckpt] --resume-from auto: resuming from {resolved}")
        cfg = cfg.replace(resume_from=resolved)
        verify = resolved is None  # auto-resolution verified its winner
    info = None
    if cfg.resume_from and os.path.exists(os.path.join(cfg.resume_from,
                                                       "meta.json")):
        meta = read_meta(cfg.resume_from)
        info = elastic_resume_info(meta, cfg)
        if info["elastic"]:
            say(f"[elastic] resuming a checkpoint trained on mesh "
                f"{info['saved_mesh']} onto {dataclasses.asdict(cfg.mesh)} "
                f"({'exact' if info['exact'] else 'INEXACT'} sampler "
                f"fast-forward from {info['consumed_windows']} consumed "
                "windows)")
        saved_cfg = meta.get("config") or {}
        recorded_vocab = (saved_cfg.get("vocab_size")
                          or (saved_cfg.get("model") or {}).get("vocab_size")
                          or cfg.vocab_size)
        if tokenizer is not None:
            check_tokenizer_matches(tokenizer, recorded_vocab,
                                    meta.get("tokenizer_fingerprint"),
                                    context=cfg.resume_from)
        elif recorded_vocab != cfg.vocab_size:
            raise SystemExit(
                f"token vocab {cfg.vocab_size} != the checkpoint's vocab "
                f"{recorded_vocab} for {cfg.resume_from} — resume with the "
                "token stream and vocab_size the checkpoint was trained with"
            )
    return cfg, verify, info, len(skipped)


def train(cfg: TrainConfig, tokens_path: Optional[str] = None, device="cuda",
          dist_backend: Optional[str] = None) -> tuple:
    """Run the recipe for ``cfg.max_iters`` steps on ``device``, on the
    pre-encoded stream at ``tokens_path`` or, when it is None, on
    ``cfg.dataset`` through the BPE (:func:`build_data`). Returns
    (final train state, per-step metrics list: the steps of the state's
    own history, rolled-back steps left out; under fsdp the state holds
    this rank's shards; under pipeline the gathered full state). With a
    mesh of more than one rank (``cfg.mesh.n_devices`` > 1) this process
    is one of its ranks: ``dist_backend`` (``nccl`` or ``gloo``) must be
    named, and ``device`` picks cuda or cpu (gloo)."""
    # chaos-test fault injection (utils/faults.py); inert unless armed
    # by cfg.faults or the DTX_FAULTS variable
    faults.arm(cfg.faults)
    group = None
    joined = False
    if cfg.mesh.n_devices > 1:
        if dist_backend is None:
            raise ValueError("a mesh of more than one rank needs a named dist "
                             "backend: 'nccl' (one card per rank) or 'gloo'")
        joined = multihost.initialize(backend=dist_backend)
        try:
            group = create_mesh(cfg.mesh, dist_backend, str(torch.device(device).type))
        except BaseException:
            if joined:
                torch.distributed.destroy_process_group()
            raise
    elif dist_backend is not None:
        raise ValueError(f"dist backend {dist_backend!r} without a mesh of "
                         "ranks: set a mesh axis > 1")
    logger = None
    try:
        device = resolve_device(device) if group is None else group.device
        primary = multihost.is_primary()
        say = (lambda m: print(m, flush=True)) if primary else (lambda m: None)
        tokenizer, vocab_size, train_ds, val_ds = build_data(
            cfg, tokens_path, device, say, group)
        cfg = cfg.replace(vocab_size=vocab_size)
        tok_fp = (None if tokenizer is None
                  else tokenizer_fingerprint(tokenizer))
        cfg, verify, info, n_skipped = resolve_resume(cfg, say, tokenizer)
        logger = MetricLogger(cfg, device, primary)
        out = _train_loop(cfg, (train_ds, val_ds), tok_fp, device, group,
                          logger, verify, info, n_skipped)
        if group is not None:
            # rank 0 wrote the exit's checkpoints: the ranks leave together,
            # so a run that follows in the same processes can resume them
            all_reduce_sum_(torch.zeros(1, device=group.device), group)
        return out
    finally:
        if logger is not None:
            logger.finish()  # a no-op when the loop's closers ran
        if group is not None:
            destroy_mesh(group)
            if joined:
                torch.distributed.destroy_process_group()


def _instruments(registry: Registry) -> dict:
    """The trainer's metric families, under the JAX trainer's names and
    help texts (one fleet scrape reads both packages). The JAX trainer's
    ``train_compile_events_total`` has no counterpart: eager PyTorch has no
    compile cache."""
    return {
        "step": registry.histogram(
            "train_step_seconds",
            "Wall time of one train-loop iteration, host-observed "
            "(data wait + dispatch + any blocking).",
        ),
        "data": registry.histogram(
            "train_data_wait_seconds",
            "Host time assembling the next batch before dispatch.",
        ),
        "stall": registry.gauge(
            "train_data_stall_ratio",
            "Fraction of recent loop wall time spent waiting on data.",
        ),
        "mem": registry.gauge(
            "train_device_memory_peak_mb",
            "High-water mark of allocated device memory (MB).",
        ),
        "iters": registry.counter(
            "train_iterations_total", "Optimizer steps completed."
        ),
        "anomaly": registry.counter(
            "train_anomaly_events_total",
            "Anomaly-guard interventions (train/anomaly.py).",
            labelnames=("kind",),
        ),
        "ckpt_save": registry.histogram(
            "ckpt_save_seconds",
            "Wall time of one checkpoint save job (serialize + write + "
            "certify + GC), wherever it ran (writer thread or inline).",
        ),
        "ckpt_blocked": registry.histogram(
            "ckpt_blocked_seconds",
            "Train-loop wall time blocked on checkpointing per periodic "
            "snapshot: back-pressure waiting for a still-in-flight async "
            "save (steady state ~0; growing = the disk cannot keep up "
            "with ckpt_interval).",
        ),
        "ckpt_verify_failures": registry.counter(
            "ckpt_verify_failures_total",
            "Checkpoints that failed integrity verification (digest "
            "mismatch, truncation, missing manifest) and were skipped "
            "during resume resolution.",
        ),
        "ckpt_save_failures": registry.counter(
            "ckpt_save_failures_total",
            "Periodic step-checkpoint saves that failed (the run continues "
            "but is less protected; a growing count means the checkpoint "
            "storage is broken).",
        ),
        "watchdog_fires": registry.counter(
            "train_watchdog_fires_total",
            "Step-deadline watchdog fires (train/watchdog.py): a training "
            "iteration hung past step_deadline_s, or a peer's heartbeat "
            "silence coordinated an abort. The process exits with the "
            "hang code right after incrementing, so any scrape showing "
            ">0 is the post-mortem of a dying incarnation.",
        ),
        "heartbeat_age": registry.gauge(
            "train_heartbeat_age_seconds",
            "Seconds since each peer process's heartbeat record last "
            "changed, judged by this host's monotonic clock "
            "(parallel/heartbeat.py). Healthy: ~heartbeat_interval_s; "
            "growing toward heartbeat_timeout_s: that peer is dying.",
            labelnames=("peer",),
        ),
    }


def _hang_report_path(cfg: TrainConfig, group) -> str:
    """The watchdog's report: ``cfg.resolved_hang_report_path()`` on rank
    0; the other ranks of a ring (which share the host and its paths)
    write ``<stem>.rank<r><ext>`` beside it."""
    path = cfg.resolved_hang_report_path()
    if group is None or group.rank == 0:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.rank{group.rank}{ext}"


def _train_loop(cfg: TrainConfig, data: tuple, tok_fp: Optional[str],
                device: torch.device, group, logger: MetricLogger,
                resume_verify: bool = True,
                resume_info: Optional[dict] = None,
                ckpt_auto_skipped: int = 0) -> tuple:
    model_cfg = cfg.resolved_model()
    if device.type == "cuda":
        check_card_envelope(model_cfg, "train")
    train_ds, val_ds = data
    primary = multihost.is_primary()
    rank = 0 if group is None else group.rank
    pipelined = cfg.mesh.pipeline > 1

    # -- observability (obs/): the registry always exists; the sidecar
    # exporter and the Chrome span trace are opt-in (primary rank only)
    registry = Registry()
    set_build_info(registry, role="trainer", config_hash=config_hash(cfg),
                   version=torch.__version__)
    obs = _instruments(registry)
    if ckpt_auto_skipped:
        obs["ckpt_verify_failures"].inc(ckpt_auto_skipped)
    tracer = (SpanTracer(cfg.trace_path, process_name="trainer")
              if cfg.trace_path and primary else NOOP_TRACER)
    metrics_server = None
    watchdog = heartbeat = ckpt_writer = None
    profiler = ProfilerWindow(None, 0)
    prev_handler = None
    state = metrics = layout = None
    iter_num = start_iter = 0
    history = []
    best_val_loss = float("inf")
    best_snapshot = None  # a deferred best state not yet on disk
    best_snapshot_iter = 0
    in_step = False  # an exception inside a step may leave it half-applied
    crashed = False
    batch_windows = cfg.grad_acc_steps * cfg.micro_batch_size
    consumed_base = 0
    last_ckpt_path = cfg.resolved_last_checkpoint_path()

    def consumed_at(it: int) -> int:
        """Windows consumed once iteration ``it`` of this run is done."""
        return consumed_base + (it - start_iter) * batch_windows

    try:
        if cfg.metrics_port > 0 and primary:
            metrics_server = start_metrics_server(registry, cfg.metrics_port)
            logger.say(f"[obs] Prometheus sidecar: http://0.0.0.0:"
                       f"{metrics_server.server_address[1]}/metrics")
        gen = torch.Generator(device=device)
        gen.manual_seed(cfg.seed)
        state = create_train_state(gen, cfg, device)
        if cfg.resume_from:
            state, best_val_loss = load_checkpoint(cfg.resume_from, cfg, state,
                                                   verify=resume_verify)
            logger.say(f"Resumed from {cfg.resume_from} at iter {state['step']}")
        layout = None
        if group is None:
            train_step = make_train_step(cfg)
            eval_many = make_eval_many(cfg)
        else:
            # under tensor and fsdp every rank keeps its shards of the
            # full state, under pipeline its stage's layers; each batch is
            # built as this rank's share (multihost.local_batch)
            state, layout = shard_train_state(cfg, group, state)
            if pipelined:
                # eval streams all eval_iters batches through the stages
                # as ONE microbatch stream: the bubble amortized
                train_step = make_pipeline_train_step(cfg, group, batch_is_local=True)
                eval_many = make_pipeline_eval_many(cfg, group, batch_is_local=True)
            else:
                train_step = make_sharded_train_step(cfg, group, layout,
                                                     batch_is_local=True)
                eval_many = make_eval_many(cfg, group, batch_is_local=True)

        def materialize(ds, offs):
            return multihost.local_batch(ds, offs, group)

        # the epoch sampler's position is kept in WINDOWS CONSUMED, from
        # the checkpoint's record, so a resume under another global batch
        # size fast-forwards the permutation to the right place
        iter_num = start_iter = state["step"]
        if resume_info is not None and resume_info["consumed_windows"] is not None:
            consumed_base = resume_info["consumed_windows"]
        else:
            consumed_base = start_iter * batch_windows

        if cfg.sampler == "epoch":
            # every window once per epoch; on a mesh every rank draws the
            # same offsets
            perm = EpochPermutation(len(train_ds), cfg.seed)
            perm.epoch, perm.cursor = divmod(consumed_at(start_iter),
                                             len(train_ds))

            def draw_batch():
                offs = perm.take(batch_windows)
                return materialize(train_ds, offs.reshape(cfg.grad_acc_steps,
                                                          cfg.micro_batch_size))
        else:
            data_rng = np.random.default_rng(cfg.seed)

            def draw_batch():
                # train_ds.random_batches's draw, built as this rank's share
                offs = data_rng.integers(0, len(train_ds),
                                         size=(cfg.grad_acc_steps,
                                               cfg.micro_batch_size),
                                         dtype=np.int64)
                return materialize(train_ds, offs)
        eval_rng = np.random.default_rng(cfg.seed + 1)
        # the dropout seed of step i is fold_seed(seed + 2, i): JAX folds
        # the iteration into PRNGKey(seed + 2); eval runs without one
        dropout_seed = cfg.seed + 2 if model_cfg.dropout > 0.0 else None
        tokens_per_step = batch_windows * model_cfg.block_size
        # the lambda-evolution + per-group-norm record at every eval
        # (obs/introspect.py; tools/lambda_report.py); not on the
        # pipeline path, as in JAX
        param_summary = None if pipelined else make_param_summary(model_cfg)

        # -- resilience (train/watchdog.py, parallel/heartbeat.py): host
        # daemon threads. The watchdog also exists when only the
        # heartbeat is configured: a dead peer trips it directly.
        wd_warm = False  # True once this process's first iteration ran
        hb_iter = {"i": start_iter}  # the host iteration the beats carry
        if cfg.step_deadline_s > 0 or cfg.heartbeat_dir:
            watchdog = StepWatchdog(
                cfg.step_deadline_s,
                report_path=_hang_report_path(cfg, group),
                sink=logger.log_record,
                fires_counter=obs["watchdog_fires"],
                context={"process_index": lambda: rank},
            )
        if cfg.heartbeat_dir:
            def _peer_dead(peer: int, age: float) -> None:
                # a silent peer means the next collective wedges every
                # surviving rank: fire the watchdog now
                watchdog.trip(
                    f"peer process {peer} heartbeat silent for {age:.1f}s "
                    f"(timeout {cfg.heartbeat_timeout_s:.1f}s): "
                    "coordinated abort"
                )

            heartbeat = Heartbeat(
                FileHeartbeatTransport(cfg.heartbeat_dir),
                process_index=rank,
                num_processes=1 if group is None else group.size,
                interval_s=cfg.heartbeat_interval_s,
                timeout_s=cfg.heartbeat_timeout_s,
                iter_supplier=lambda: hb_iter["i"],
                on_dead=_peer_dead,
                age_gauge=obs["heartbeat_age"],
            )
            watchdog.add_context(heartbeat_ages=heartbeat.peer_ages)
            # no beat may be mid-write when the watchdog exits 113
            watchdog.add_exit_hook(heartbeat.close)

        # the guard's rollback target: seeded at loop entry so one always
        # exists, refreshed every anomaly_snapshot_interval good
        # iterations; it pins one more train state in device memory
        # the pipeline step carries no guard and no poison, as JAX's
        guard_on = cfg.anomaly_guard and not pipelined
        if cfg.anomaly_guard and pipelined:
            logger.say("[anomaly] guard is unsupported on the pipeline path; disabled")
        nan_fault_armed = faults.nan_armed() and not pipelined
        if faults.nan_armed() and pipelined:
            logger.say("[faults] nan injection is unsupported on the pipeline "
                       "path; disabled")
        rollbacks = 0
        good_snapshot = snapshot_state(state) if guard_on else None
        snapshot_iter = iter_num

        # rotating step checkpoints (train/ckpt_writer.py): the host
        # snapshot on the loop, serialization, I/O, certification and GC
        # on the writer's thread when ckpt_async; only the primary writes
        ckpt_root = cfg.resolved_ckpt_dir()
        ckpt_last_save_s = None  # the sync path's last save
        if cfg.ckpt_interval > 0:
            if cfg.ckpt_keep_last < 1:
                raise ValueError("ckpt_keep_last must be >= 1 when "
                                 f"ckpt_interval > 0, got {cfg.ckpt_keep_last}")
            if cfg.ckpt_async and primary:
                ckpt_writer = AsyncCheckpointWriter(
                    save_hist=obs["ckpt_save"],
                    blocked_hist=obs["ckpt_blocked"])

        # a short steady-state window past the first steps, relative to
        # wherever this run starts (fresh or resumed)
        if primary:
            profiler = ProfilerWindow(cfg.profile_dir, start=start_iter + 10,
                                      device=device)

        # SIGTERM asks for a graceful stop; the last checkpoint is written
        # on every exit. A ring's ranks agree at log boundaries (one
        # all-reduce of the flags) so they all leave the loop at the same
        # step.
        stop_requested = {"flag": False}

        def _on_sigterm(signum, frame):
            del signum, frame
            stop_requested["flag"] = True

        def _agreed_stop(it: int) -> bool:
            if group is None:
                return stop_requested["flag"]
            if it % cfg.log_interval:
                return False
            flag = torch.tensor([1.0 if stop_requested["flag"] else 0.0],
                                device=device)
            return bool(all_reduce_sum_(flag, group).item() > 0)

        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            pass  # not the main thread: SIGTERM keeps its handler

        where = (f"{device}" if group is None else
                 f"{group.size} ranks (mesh data {cfg.mesh.data}, fsdp "
                 f"{cfg.mesh.fsdp}, tensor {cfg.mesh.tensor}, sequence "
                 f"{cfg.mesh.sequence}, pipeline {cfg.mesh.pipeline}) over "
                 f"{group.backend} (rank 0 on {device})")
        logger.say(f"Starting training on {where} ({model_cfg.model}, "
                   f"{model_cfg.n_layer} layers, width {model_cfg.n_embd}, "
                   f"{model_cfg.n_head} heads, {cfg.sampler} sampler)")
        t0 = time.time()
        throughput = Throughput()
        tokens_seen = 0
        # wall time of each iteration (batch draw included) and the batch
        # draw's share of it, summed since the last log, as the JAX
        # trainer keeps them; the loop's time in periodic saves likewise
        acc_step = acc_data = 0.0
        acc_n = 0
        ckpt_acc_blocked = ckpt_acc_loop = 0.0
        # the last skip total seen: the exported counter moves only by
        # positive deltas (a rollback rewinds the guard's total)
        prev_skipped = 0
        last_best_write = time.monotonic() - cfg.checkpoint_min_interval_s
        while iter_num < cfg.max_iters:
            if _agreed_stop(iter_num):
                logger.say(f"SIGTERM received: stopping at iter {iter_num}")
                break
            faults.fire(iter_num)  # injected raise/SIGTERM/SIGKILL points
            if watchdog is not None and wd_warm:
                # armed across the step and the syncs that follow it; the
                # first iteration of this process runs unarmed (its first
                # launches build and load the kernels: slow, not hung)
                watchdog.arm(iter_num)
            # chaos stalls land inside the armed window
            faults.train_stall(iter_num)
            if faults.corrupt_params_at(iter_num):
                # simulated state corruption: NaN the first param leaf;
                # skipping batches cannot cure it, only a rollback can
                with torch.no_grad():
                    leaves(state["params"])[0].mul_(float("nan"))
            t_iter = time.perf_counter()
            with tracer.span("data_wait", iter=iter_num):
                batch = draw_batch()
            data_wait = time.perf_counter() - t_iter
            if nan_fault_armed:
                # in every batch while armed, as the JAX trainer does
                scale = np.nan if faults.poison_at(iter_num) else 1.0
                batch["poison"] = np.full((cfg.grad_acc_steps,), scale,
                                          np.float32)
            seed = (None if dropout_seed is None
                    else fold_seed(dropout_seed, iter_num))
            in_step = True
            with tracer.span("dispatch", iter=iter_num):
                state, metrics = train_step(state, batch, seed)
            in_step = False
            iter_num += 1
            hb_iter["i"] = iter_num
            profiler.step(iter_num)
            tokens_seen += tokens_per_step

            if guard_on and iter_num % cfg.anomaly_check_interval == 0:
                # every rank holds the same streak (the guard's inputs are
                # all-reduced), so the ranks agree with no collective
                with tracer.span("block", what="anomaly_streak"):
                    streak = metrics["bad_streak"]
                if streak == 0:
                    if iter_num - snapshot_iter >= cfg.anomaly_snapshot_interval:
                        good_snapshot = snapshot_state(state)
                        snapshot_iter = iter_num
                elif streak >= cfg.anomaly_rollback_after:
                    rollbacks += 1
                    if rollbacks > cfg.anomaly_max_rollbacks:
                        raise TrainingDivergedError(
                            f"{rollbacks - 1} rollback(s) did not recover "
                            f"the run: still {streak} consecutive bad "
                            f"steps at iter {iter_num}. Aborting without "
                            "overwriting the last good checkpoint."
                        )
                    logger.say(
                        f"[anomaly] {streak} consecutive bad steps at iter "
                        f"{iter_num}: rolling back to iter {snapshot_iter} "
                        f"(rollback {rollbacks}/{cfg.anomaly_max_rollbacks})"
                    )
                    if watchdog is not None:
                        # the restore is a legitimate slow section
                        watchdog.disarm()
                        wd_warm = True
                    # an in-memory resume: copy the snapshot back (it is
                    # kept for a later rollback) and rewind the epoch
                    # sampler; the replacement sampler simply continues
                    state = restore_state(state, good_snapshot)
                    del history[snapshot_iter - start_iter:]
                    iter_num = snapshot_iter
                    hb_iter["i"] = iter_num
                    metrics = None
                    if cfg.sampler == "epoch":
                        perm.epoch, perm.cursor = divmod(
                            consumed_at(iter_num), len(train_ds))
                    continue

            if watchdog is not None:
                # the slow tails below (checkpoint write, eval) run
                # disarmed; only the step and its syncs are deadlined
                watchdog.disarm()
                wd_warm = True

            # host-observed accounting of the iterations that stand (a
            # rolled-back one was discarded with its state)
            step_wall = time.perf_counter() - t_iter
            metrics["step_time_ms"] = 1e3 * step_wall
            history.append(metrics)
            obs["step"].observe(step_wall)
            obs["data"].observe(data_wait)
            obs["iters"].inc()
            acc_step += step_wall
            acc_data += data_wait
            acc_n += 1
            ckpt_due = cfg.ckpt_interval > 0 and iter_num % cfg.ckpt_interval == 0
            ckpt_state = _full_state(state, group, layout) if ckpt_due else state
            if ckpt_due and primary:
                # a failed periodic save does not stop a healthy run: it
                # is printed and counted on the step's record
                with tracer.span("ckpt_snapshot", iter=iter_num):
                    t_ck = time.perf_counter()
                    try:
                        blocked = save_step_checkpoint(
                            ckpt_root, ckpt_state, best_val_loss, cfg, tok_fp,
                            writer=ckpt_writer, keep_last=cfg.ckpt_keep_last,
                            keep_every=cfg.ckpt_keep_every,
                            consumed_windows=consumed_at(iter_num))
                    except Exception as e:  # noqa: BLE001
                        obs["ckpt_save_failures"].inc()
                        metrics["ckpt_save_failed"] = 1
                        logger.say(f"[ckpt] step-checkpoint save failed at "
                                   f"iter {iter_num} (continuing): {e!r}")
                    else:
                        loop_s = time.perf_counter() - t_ck
                        if ckpt_writer is None:
                            ckpt_last_save_s = loop_s
                            obs["ckpt_save"].observe(loop_s)
                        ckpt_acc_blocked += blocked
                        ckpt_acc_loop += loop_s
                        metrics["ckpt_blocked_ms"] = 1e3 * blocked
                        metrics["ckpt_loop_ms"] = 1e3 * loop_s
            if iter_num % cfg.log_interval == 0:
                extra = {}
                if watchdog is not None:
                    watchdog.arm(iter_num)
                with tracer.span("block", what="log_metrics"):
                    if guard_on:
                        skipped = metrics["skipped"]
                        extra["skipped_steps"] = skipped
                        extra["rollbacks"] = rollbacks
                        if skipped > prev_skipped:
                            obs["anomaly"].inc(skipped - prev_skipped,
                                               kind="skip")
                        # after a rollback the guard's total rewinds;
                        # re-base so replayed skips count as new events
                        prev_skipped = skipped
                        obs["anomaly"].set(rollbacks, kind="rollback")
                if watchdog is not None:
                    watchdog.disarm()
                extra["step_time_ms"] = round(1e3 * acc_step / max(acc_n, 1), 3)
                extra["data_wait_frac"] = round(acc_data / max(acc_step, 1e-9), 4)
                obs["stall"].set(extra["data_wait_frac"])
                if cfg.ckpt_interval > 0:
                    # the loop's back-pressure waits and its whole time in
                    # periodic saves since the last log (snapshot
                    # included), and the last completed save's duration
                    extra["ckpt_blocked_ms"] = round(1e3 * ckpt_acc_blocked, 3)
                    extra["ckpt_loop_ms"] = round(1e3 * ckpt_acc_loop, 3)
                    last_save_s = (ckpt_writer.last_save_s if ckpt_writer
                                   is not None else ckpt_last_save_s)
                    if last_save_s is not None:
                        extra["ckpt_save_ms"] = round(1e3 * last_save_s, 3)
                    ckpt_acc_blocked = ckpt_acc_loop = 0.0
                mem = device_memory_mb(device)  # one query: gauge + record
                if mem is not None:
                    obs["mem"].set_max(mem)
                acc_step = acc_data = 0.0
                acc_n = 0
                logger.log_step(iter_num, metrics["loss"],
                                metrics["learning_rate"],
                                throughput.update(tokens_seen), extra,
                                gpu_memory_mb=mem)
            if iter_num % cfg.eval_interval == 0:
                with tracer.span("eval", iter=iter_num):
                    params = model_params(state["params"], layout)
                    losses = estimate_loss(eval_many, params,
                                           train_ds, val_ds, cfg, eval_rng,
                                           materialize)
                logger.log_eval(iter_num, losses["train"], losses["val"])
                del params
                if param_summary is not None:
                    with tracer.span("block", what="introspection"):
                        # the full lambdas and norms: a tensor shard gathered
                        summ = param_summary(full_params(state["params"], group, layout))
                        record = {"record": "introspection", "iter": iter_num,
                                  **lambda_record(summ, model_cfg,
                                                  metrics.get("grad_norm_groups"))}
                    logger.log_record(record)
                if losses["val"] < best_val_loss:
                    # every rank sees the same val loss: under fsdp they
                    # all join the gather here
                    best_state = _full_state(state, group, layout)
                    best_val_loss = losses["val"]
                    logger.say(f"Saving best model with val loss: "
                               f"{best_val_loss:.4f}")
                    # at most one best write per checkpoint_min_interval_s
                    # (0: every improvement); a deferred one is a device
                    # copy written at exit. Rank 0's clock decides.
                    if time.monotonic() - last_best_write \
                            >= cfg.checkpoint_min_interval_s:
                        if primary:
                            t_b = time.perf_counter()
                            save_checkpoint(
                                cfg.checkpoint_path, best_state, best_val_loss,
                                cfg, tok_fp,
                                consumed_windows=consumed_at(iter_num))
                            logger.say(f"[ckpt] best checkpoint written to "
                                       f"{cfg.checkpoint_path} in "
                                       f"{time.perf_counter() - t_b:.3f} s")
                        best_snapshot = None
                        last_best_write = time.monotonic()
                    else:
                        best_snapshot = snapshot_state(best_state)
                        best_snapshot_iter = iter_num
                    del best_state
        dt = time.time() - t0
        logger.say(f"Training done: {tokens_seen} tokens in {dt:.1f}s "
                   f"({tokens_seen / max(dt, 1e-9):.0f} tokens/sec)")
    except BaseException:
        crashed = True
        raise
    finally:
        try:
            errors = _close_all(
                crashed, logger,
                ("the watchdog", watchdog and watchdog.close),
                ("the heartbeat", heartbeat and heartbeat.close),
                ("draining the checkpoint writer",
                 ckpt_writer and (lambda: ckpt_writer.close(600.0))),
                ("the profiler window", profiler.close),
                ("the metrics log", logger.finish),
                ("the span trace", lambda: _close_tracer(tracer, logger)),
                ("the metrics sidecar",
                 metrics_server and (lambda: _stop_server(metrics_server))),
            )
            last_state, last_path = state, (
                None if ckpt_writer is not None and not ckpt_writer.drained
                else last_ckpt_path)
            sharded = group is not None and (layout is not None
                                             or group.axis_size("tensor") > 1
                                             or pipelined)
            if sharded and state is not None:
                if crashed:
                    # the gather needs every rank, and after a failure one
                    # may be gone: the last checkpoint stays as it was
                    last_path = None
                    logger.say("[ckpt] skipping last-checkpoint save: a tensor, "
                               "fsdp or pipeline run that failed cannot gather "
                               "its shards")
                else:
                    last_state = _full_state(state, group, layout)
            if primary and state is not None:
                _finish_checkpoints(
                    cfg, last_state, metrics, best_val_loss, in_step, last_path,
                    consumed_at(iter_num), best_snapshot,
                    consumed_at(best_snapshot_iter), crashed, logger, tok_fp)
            if errors:
                raise errors[0]
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
    if pipelined:
        # the canonical list-of-blocks layout, as every other path returns
        # (the exit's gather above made it)
        state = last_state
    return state, history


def _full_state(state: dict, group, layout) -> dict:
    """The full train state: ``state`` itself, or under tensor or fsdp
    the gather of its shards, which every rank must join."""
    return state if group is None else full_train_state(state, group, layout)


def _close_tracer(tracer, logger: MetricLogger) -> None:
    tracer.close()
    if tracer.path:
        logger.say(f"[obs] span trace written to {tracer.path}")


def _stop_server(server) -> None:
    server.shutdown()
    server.server_close()


def _close_all(crashed: bool, logger: MetricLogger, *closers) -> list:
    """Run each ``(what, fn)`` closer in order (a None ``fn`` is skipped),
    every one whatever the others did, in the JAX trainer's order: the
    watchdog first (the saves after it are legitimately slow), then the
    heartbeat, the checkpoint writer's drain, the profiler, the logger,
    the tracer, the sidecar. A failure is printed; the failures are
    returned, for the caller to raise once the saves are done, unless the
    run is already failing with its own exception."""
    errors = []
    for what, fn in closers:
        if fn is None:
            continue
        try:
            fn()
        except Exception as e:  # noqa: BLE001
            print(f"shutdown: {what} failed: {e!r}", flush=True)
            if not crashed:
                errors.append(e)
    return errors


def _finish_checkpoints(cfg: TrainConfig, state: dict, metrics,
                        best_val_loss: float, in_step: bool,
                        last_path: Optional[str], consumed: int, best_snapshot,
                        best_consumed: int, crashed: bool,
                        logger: MetricLogger,
                        tok_fp: Optional[str] = None) -> None:
    """The exit's saves, in the JAX trainer's order, after the checkpoint
    writer drained (an in-flight step checkpoint lands and certifies
    first; a writer that would not drain leaves ``last_path`` None): the
    last checkpoint, then a deferred best checkpoint. A failure raises,
    except while another exception is already unwinding the run: it is
    then printed, and the run's own exception goes on."""
    def run(what: str, fn, *args) -> None:
        try:
            fn(*args)
        except Exception as e:  # noqa: BLE001
            if not crashed:
                raise
            logger.say(f"[ckpt] {what} failed while the run was failing: "
                       f"{e!r}")

    run("the last-checkpoint save", _save_last, cfg, state, metrics,
        best_val_loss, in_step, last_path, consumed, logger, tok_fp)
    if best_snapshot is not None:
        logger.say(f"writing pending best checkpoint (val loss "
                   f"{best_val_loss:.4f})")
        run("the pending best-checkpoint save", save_checkpoint,
            cfg.checkpoint_path, best_snapshot, best_val_loss, cfg, tok_fp,
            best_consumed)


def _save_last(cfg: TrainConfig, state: dict, metrics, best_val_loss: float,
               in_step: bool, path: Optional[str], consumed: int,
               logger: MetricLogger, tok_fp: Optional[str] = None) -> None:
    """The last checkpoint, written whatever the exit (a normal end,
    SIGTERM, an exception between steps), so ``--resume-from`` continues
    from the latest step. Not written when there is no path, when the
    last loss is not finite (a diverged state must not replace a good
    one: the guard's abort leaves the previous checkpoint as it was), or
    when an exception left a step half-applied: the port updates params
    in place, so that state is no step's."""
    if not path:
        return
    if in_step:
        logger.say(f"skipping last-checkpoint save: a step was interrupted "
                   f"mid-update (the checkpoint at {path!r} is left intact)")
        return
    if metrics is not None and not math.isfinite(metrics["loss"]):
        logger.say(f"skipping last-checkpoint save: non-finite loss at iter "
                   f"{state['step']} (previous checkpoint at {path!r} left "
                   "intact)")
        return
    t0 = time.perf_counter()
    save_checkpoint(path, state, best_val_loss, cfg, tok_fp,
                    consumed_windows=consumed)
    logger.say(f"[ckpt] last checkpoint written to {path} in "
               f"{time.perf_counter() - t0:.3f} s")
