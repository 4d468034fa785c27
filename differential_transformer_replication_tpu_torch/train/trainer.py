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
whose fingerprint differs from the checkpoint's is refused. Rollback,
the watchdog and the obs sidecar belong to later slices (ROADMAP Queue
A).

``cfg.mesh.sequence`` = P > 1 trains sequence-parallel (JAX's sharded
path on a ``sequence`` mesh): the process is one of P ranks started by
``torchrun``, joins the ring over the backend the caller names
(``parallel/mesh.py``), draws the same batches from the same seeds as
every other rank and trains on its T-shard of them
(``train/step.py``). Only rank 0 prints and writes metrics; the group is
left on exit and on error.
"""

from __future__ import annotations

import dataclasses
import json
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
from differential_transformer_replication_tpu_torch.ops.dropout import fold_seed
from differential_transformer_replication_tpu_torch.parallel.mesh import (
    all_reduce_sum_,
    destroy_sequence_group,
    init_sequence_group,
)
from differential_transformer_replication_tpu_torch.train.checkpoint import (
    AsyncCheckpointWriter,
    config_hash,
    elastic_resume_info,
    load_checkpoint,
    read_meta,
    resolve_resume_auto,
    save_checkpoint,
    save_step_checkpoint,
)
from differential_transformer_replication_tpu_torch.train.step import (
    create_train_state,
    make_eval_many,
    make_train_step,
)


def resolve_device(device) -> torch.device:
    """The entry points' device: CUDA unless the caller asks for the CPU,
    and never a silent fallback when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but CUDA is not "
                           "available; pass device='cpu' for a CPU run")
    return device


class Throughput:
    """Rolling tokens/sec between ``update`` calls (a copy of the JAX
    package's ``utils/profiling.py`` ``Throughput``): ``update`` takes the
    cumulative token count and returns the rate since the previous call,
    None on the first call, when there is no interval yet."""

    def __init__(self) -> None:
        self._last_t: Optional[float] = None
        self._last_tokens = 0

    def update(self, total_tokens: int) -> Optional[float]:
        now = time.perf_counter()
        rate = None
        if self._last_t is not None and now > self._last_t:
            rate = (total_tokens - self._last_tokens) / (now - self._last_t)
        self._last_t = now
        self._last_tokens = total_tokens
        return rate


def estimate_loss(eval_many, params: dict, train_ds: TokenWindows,
                  val_ds: TokenWindows, cfg: TrainConfig,
                  rng: np.random.Generator) -> dict:
    """Mean loss over eval_iters batches of each split: train batches
    shuffled (one ``integers(size=B)`` draw per batch), val batches
    sequential from the start."""
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
        batch = ds.batches(offs)
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
    """:func:`corpus_tokens` on a ring: rank 0 builds or loads the cache
    entry while the other ranks wait on one all-reduce, then they load
    it. So a host trains the BPE once, and one process writes
    ``tokenizer_dir``. A failure on rank 0 is raised on every rank."""
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
    first on a ring ``group``) and the vocab size is the tokenizer's. The
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


class MetricLogger:
    """stdout + metrics.jsonl with the JAX trainer's record keys: a
    ``run_header``, per-log ``iter``/``loss``/``learning_rate``/
    ``gpu_memory``/``tokens_per_sec`` (none on the first log) + extras
    (``step_time_ms``, the mean iteration wall since the last log;
    ``data_wait_frac``, the batch draw's share of it; ``skipped_steps``),
    per-eval ``train_loss``/``val_loss``; every record carries ``ts``."""

    def __init__(self, cfg: TrainConfig, device: torch.device,
                 primary: bool = True):
        self._jsonl = None
        self._cuda = device.type == "cuda"
        self._primary = primary  # only the primary rank prints and writes
        if cfg.metrics_path and primary:
            self._jsonl = open(cfg.metrics_path, "a", buffering=1)
            self._emit({
                "record": "run_header",
                "config_hash": config_hash(cfg.to_dict()),
                "torch_version": torch.__version__,
                "device_kind": (torch.cuda.get_device_name(device)
                                if self._cuda else "cpu"),
                "device_count": torch.cuda.device_count() if self._cuda else 1,
                "process_count": cfg.mesh.n_devices,
                "model": cfg.resolved_model().model,
            })

    def _emit(self, payload: dict) -> None:
        payload.setdefault("ts", round(time.time(), 3))
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(payload) + "\n")

    def say(self, msg: str) -> None:
        if self._primary:
            print(msg, flush=True)

    def log_step(self, iter_num: int, loss: float, lr: float,
                 tokens_per_sec: Optional[float], extra: dict) -> None:
        self.say(f"iter {iter_num}: loss {loss:.4f}, lr {lr:.2e}")
        payload = {"iter": iter_num, "loss": loss, "learning_rate": lr}
        if self._cuda:  # omitted on the CPU, never a fake 0.0
            payload["gpu_memory"] = torch.cuda.memory_allocated() / 1024 ** 2
        if tokens_per_sec is not None:
            payload["tokens_per_sec"] = round(tokens_per_sec, 1)
        payload.update(extra)
        self._emit(payload)

    def log_eval(self, iter_num: int, train_loss: float, val_loss: float) -> None:
        self.say(f"step {iter_num}: train loss {train_loss:.4f}, val loss "
                 f"{val_loss:.4f}")
        self._emit({"iter": iter_num, "train_loss": train_loss,
                    "val_loss": val_loss})

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()


def resolve_resume(cfg: TrainConfig, say=print, tokenizer=None) -> tuple:
    """The resume half of the JAX trainer's start: ``resume_from="auto"``
    becomes the newest checkpoint that verifies (or None: a fresh start),
    and a checkpoint's meta is held against this run
    (:func:`elastic_resume_info`; the run's tokenizer against the
    recorded vocabulary and fingerprint, or, for a pre-encoded stream,
    ``cfg.vocab_size`` against the recorded vocabulary). Returns (cfg
    with the resolved ``resume_from``, whether the load must still
    verify the digests, the elastic-resume facts or None)."""
    verify = True
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
    return cfg, verify, info


def train(cfg: TrainConfig, tokens_path: Optional[str] = None, device="cuda",
          dist_backend: Optional[str] = None) -> tuple:
    """Run the recipe for ``cfg.max_iters`` steps on ``device``, on the
    pre-encoded stream at ``tokens_path`` or, when it is None, on
    ``cfg.dataset`` through the BPE (:func:`build_data`). Returns
    (final train state, per-step metrics list). With ``cfg.mesh.sequence``
    > 1 this process is one rank of the ring: ``dist_backend`` (``nccl``
    or ``gloo``) must be named, and ``device`` picks cuda or cpu (gloo)."""
    group = None
    if cfg.mesh.sequence > 1:
        if dist_backend is None:
            raise ValueError("sequence parallelism needs a named dist "
                             "backend: 'nccl' (one card per rank) or 'gloo'")
        group = init_sequence_group(dist_backend, str(torch.device(device).type))
    elif dist_backend is not None:
        raise ValueError(f"dist backend {dist_backend!r} without sequence "
                         "parallelism: set mesh.sequence > 1")
    try:
        if group is not None and group.size != cfg.mesh.sequence:
            raise ValueError(f"{group.size} ranks joined, mesh.sequence is "
                             f"{cfg.mesh.sequence}")
        device = resolve_device(device) if group is None else group.device
        primary = group is None or group.rank == 0
        say = (lambda m: print(m, flush=True)) if primary else (lambda m: None)
        tokenizer, vocab_size, train_ds, val_ds = build_data(
            cfg, tokens_path, device, say, group)
        cfg = cfg.replace(vocab_size=vocab_size)
        tok_fp = (None if tokenizer is None
                  else tokenizer_fingerprint(tokenizer))
        cfg, verify, info = resolve_resume(cfg, say, tokenizer)
        logger = MetricLogger(cfg, device, primary)
        try:
            return _train_loop(cfg, (train_ds, val_ds), tok_fp, device, group,
                               logger, verify, info)
        finally:
            logger.close()
    finally:
        if group is not None:
            destroy_sequence_group(group)


def _snapshot(tree):
    """A device copy of a train state (the deferred best checkpoint): the
    optimizer updates the live tensors in place."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_snapshot(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


def _train_loop(cfg: TrainConfig, data: tuple, tok_fp: Optional[str],
                device: torch.device, group, logger: MetricLogger,
                resume_verify: bool = True,
                resume_info: Optional[dict] = None) -> tuple:
    model_cfg = cfg.resolved_model()
    if device.type == "cuda":
        check_card_envelope(model_cfg, "train")
    train_ds, val_ds = data
    primary = group is None or group.rank == 0
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    state = create_train_state(gen, cfg, device)
    best_val_loss = float("inf")
    if cfg.resume_from:
        state, best_val_loss = load_checkpoint(cfg.resume_from, cfg, state,
                                               verify=resume_verify)
        logger.say(f"Resumed from {cfg.resume_from} at iter {state['step']}")
    train_step = make_train_step(cfg, group)
    eval_many = make_eval_many(cfg, group)
    batch_windows = cfg.grad_acc_steps * cfg.micro_batch_size

    # the epoch sampler's position is kept in WINDOWS CONSUMED, from the
    # checkpoint's record, so a resume under another global batch size
    # fast-forwards the permutation to the right place
    start_iter = state["step"]
    if resume_info is not None and resume_info["consumed_windows"] is not None:
        consumed_base = resume_info["consumed_windows"]
    else:
        consumed_base = start_iter * batch_windows

    def consumed_at(it: int) -> int:
        """Windows consumed once iteration ``it`` of this run is done."""
        return consumed_base + (it - start_iter) * batch_windows

    if cfg.sampler == "epoch":
        # every window once per epoch; with a sequence group every rank
        # draws the same offsets
        perm = EpochPermutation(len(train_ds), cfg.seed)
        perm.epoch, perm.cursor = divmod(consumed_at(start_iter), len(train_ds))

        def draw_batch():
            offs = perm.take(batch_windows)
            return train_ds.batches(offs.reshape(cfg.grad_acc_steps,
                                                 cfg.micro_batch_size))
    else:
        data_rng = np.random.default_rng(cfg.seed)

        def draw_batch():
            return train_ds.random_batches(data_rng, cfg.micro_batch_size,
                                           cfg.grad_acc_steps)
    eval_rng = np.random.default_rng(cfg.seed + 1)
    # the dropout seed of step i is fold_seed(seed + 2, i): JAX folds the
    # iteration into PRNGKey(seed + 2); eval runs without one
    dropout_seed = cfg.seed + 2 if model_cfg.dropout > 0.0 else None
    tokens_per_step = batch_windows * model_cfg.block_size

    # rotating step checkpoints (train/ckpt_writer.py): the host snapshot
    # on the loop, serialization, I/O, certification and GC on the
    # writer's thread when ckpt_async; only the primary rank writes
    ckpt_root = cfg.resolved_ckpt_dir()
    ckpt_writer = None
    ckpt_last_save_s = None  # the sync path's last save, as writer.last_save_s
    if cfg.ckpt_interval > 0:
        if cfg.ckpt_keep_last < 1:
            raise ValueError("ckpt_keep_last must be >= 1 when ckpt_interval "
                             f"> 0, got {cfg.ckpt_keep_last}")
        if cfg.ckpt_async and primary:
            ckpt_writer = AsyncCheckpointWriter()
    last_ckpt_path = cfg.resolved_last_checkpoint_path()

    # SIGTERM asks for a graceful stop; the last checkpoint is written on
    # every exit. A ring's ranks agree at log boundaries (one all-reduce
    # of the flags) so they all leave the loop at the same step.
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

    prev_handler = None
    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass  # not the main thread: SIGTERM keeps its handler

    history = []
    where = (f"{device}" if group is None else
             f"{group.size} ranks over {group.backend} (rank 0 on {device})")
    logger.say(f"Starting training on {where} ({model_cfg.model}, "
               f"{model_cfg.n_layer} layers, width {model_cfg.n_embd}, "
               f"{model_cfg.n_head} heads, {cfg.sampler} sampler)")
    t0 = time.time()
    throughput = Throughput()
    tokens_seen = 0
    # wall time of each iteration (batch draw included) and the batch
    # draw's share of it, summed since the last log, as the JAX trainer
    # keeps them; the loop's time in periodic saves likewise
    acc_step = acc_data = 0.0
    acc_n = 0
    ckpt_acc_blocked = ckpt_acc_loop = 0.0
    iter_num = state["step"]
    metrics = None  # the last step's; gates the rescue save
    best_snapshot = None  # a deferred best state not yet on disk
    best_snapshot_iter = 0
    last_best_write = time.monotonic() - cfg.checkpoint_min_interval_s
    in_step = False  # an exception inside a step may leave it half-applied
    crashed = False
    try:
        while iter_num < cfg.max_iters:
            if _agreed_stop(iter_num):
                logger.say(f"SIGTERM received: stopping at iter {iter_num}")
                break
            t_iter = time.perf_counter()
            batch = draw_batch()
            data_wait = time.perf_counter() - t_iter
            seed = (None if dropout_seed is None
                    else fold_seed(dropout_seed, iter_num))
            in_step = True
            state, metrics = train_step(state, batch, seed)
            in_step = False
            step_wall = time.perf_counter() - t_iter
            metrics["step_time_ms"] = 1e3 * step_wall
            history.append(metrics)
            iter_num += 1
            tokens_seen += tokens_per_step
            acc_step += step_wall
            acc_data += data_wait
            acc_n += 1
            if cfg.ckpt_interval > 0 and iter_num % cfg.ckpt_interval == 0 \
                    and primary:
                # a failed periodic save does not stop a healthy run: it
                # is printed and counted on the step's record
                t_ck = time.perf_counter()
                try:
                    blocked = save_step_checkpoint(
                        ckpt_root, state, best_val_loss, cfg, tok_fp,
                        writer=ckpt_writer, keep_last=cfg.ckpt_keep_last,
                        keep_every=cfg.ckpt_keep_every,
                        consumed_windows=consumed_at(iter_num))
                except Exception as e:  # noqa: BLE001
                    metrics["ckpt_save_failed"] = 1
                    logger.say(f"[ckpt] step-checkpoint save failed at iter "
                               f"{iter_num} (continuing): {e!r}")
                else:
                    loop_s = time.perf_counter() - t_ck
                    if ckpt_writer is None:
                        ckpt_last_save_s = loop_s
                    ckpt_acc_blocked += blocked
                    ckpt_acc_loop += loop_s
                    metrics["ckpt_blocked_ms"] = 1e3 * blocked
                    metrics["ckpt_loop_ms"] = 1e3 * loop_s
            if iter_num % cfg.log_interval == 0:
                extra = {}
                if cfg.anomaly_guard:
                    extra["skipped_steps"] = metrics["skipped"]
                extra["step_time_ms"] = round(1e3 * acc_step / max(acc_n, 1), 3)
                extra["data_wait_frac"] = round(acc_data / max(acc_step, 1e-9), 4)
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
                acc_step = acc_data = 0.0
                acc_n = 0
                logger.log_step(iter_num, metrics["loss"],
                                metrics["learning_rate"],
                                throughput.update(tokens_seen), extra)
            if iter_num % cfg.eval_interval == 0:
                losses = estimate_loss(eval_many, state["params"], train_ds,
                                       val_ds, cfg, eval_rng)
                logger.log_eval(iter_num, losses["train"], losses["val"])
                if losses["val"] < best_val_loss:
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
                                cfg.checkpoint_path, state, best_val_loss,
                                cfg, tok_fp,
                                consumed_windows=consumed_at(iter_num))
                            logger.say(f"[ckpt] best checkpoint written to "
                                       f"{cfg.checkpoint_path} in "
                                       f"{time.perf_counter() - t_b:.3f} s")
                        best_snapshot = None
                        last_best_write = time.monotonic()
                    else:
                        best_snapshot = _snapshot(state)
                        best_snapshot_iter = iter_num
        dt = time.time() - t0
        seen = len(history) * tokens_per_step
        logger.say(f"Training done: {seen} tokens in {dt:.1f}s "
                   f"({seen / max(dt, 1e-9):.0f} tokens/sec)")
    except BaseException:
        crashed = True
        raise
    finally:
        try:
            if primary:
                _finish_checkpoints(
                    cfg, ckpt_writer, state, metrics, best_val_loss, in_step,
                    last_ckpt_path, consumed_at(iter_num), best_snapshot,
                    consumed_at(best_snapshot_iter), crashed, logger, tok_fp)
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
    return state, history


def _finish_checkpoints(cfg: TrainConfig, writer, state: dict, metrics,
                        best_val_loss: float, in_step: bool,
                        last_path: Optional[str], consumed: int, best_snapshot,
                        best_consumed: int, crashed: bool,
                        logger: MetricLogger,
                        tok_fp: Optional[str] = None) -> None:
    """The exit's saves, in the JAX trainer's order: drain the async
    writer (an in-flight step checkpoint lands and certifies first), the
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

    if writer is not None:
        run("draining the checkpoint writer", writer.close, 600.0)
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
    one), or when an exception left a step half-applied: the port updates
    params in place, so that state is no step's."""
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
