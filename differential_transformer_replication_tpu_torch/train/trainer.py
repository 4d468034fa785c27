"""The training loop of the port: data, steps, eval and metrics.

Counterpart of the core of ``differential_transformer_replication_tpu/
train/trainer.py``: the same recipe, eval protocol (``estimate_loss``),
log cadence and metrics.jsonl keys, on one card. Data comes from a
token stream already encoded, the JAX trainer's ``tokens.npy`` cache-hit
branch: ``train(cfg, tokens_path)`` loads it, splits it 90/10 and draws
training windows with replacement (``sampler="replacement"``). The
corpus/BPE branch, the epoch sampler, checkpoints, rollback, the
watchdog and the obs sidecar belong to later slices (ROADMAP Queue A).

``cfg.mesh.sequence`` = P > 1 trains sequence-parallel (JAX's sharded
path on a ``sequence`` mesh): the process is one of P ranks started by
``torchrun``, joins the ring over the backend the caller names
(``parallel/mesh.py``), draws the same batches from the same seeds as
every other rank and trains on its T-shard of them
(``train/step.py``). Only rank 0 prints and writes metrics; the group is
left on exit and on error.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Optional

import numpy as np
import torch

from differential_transformer_replication_tpu_torch.config import TrainConfig
from differential_transformer_replication_tpu_torch.data.sampler import (
    TokenWindows,
    split_tokens,
)
from differential_transformer_replication_tpu_torch.models import check_card_envelope
from differential_transformer_replication_tpu_torch.ops.dropout import fold_seed
from differential_transformer_replication_tpu_torch.parallel.mesh import (
    destroy_sequence_group,
    init_sequence_group,
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


def build_data(cfg: TrainConfig, tokens_path: str, device, say=print):
    """The ``tokens.npy`` cache-hit branch: load the encoded stream, check
    it against the vocabulary, split it 90/10 into window datasets."""
    tokens = np.load(tokens_path)
    say(f"Loaded {len(tokens)} cached tokens from {tokens_path}")
    if tokens.ndim != 1 or not np.issubdtype(tokens.dtype, np.integer):
        raise ValueError(f"{tokens_path}: expected a 1-D integer token stream")
    if len(tokens) and (tokens.min() < 0 or tokens.max() >= cfg.vocab_size):
        raise ValueError(f"{tokens_path}: token ids outside [0, "
                         f"{cfg.vocab_size})")
    say(f"Total tokens: {len(tokens)}")
    train_tokens, val_tokens = split_tokens(tokens, cfg.val_fraction)
    block = cfg.model.block_size
    return (TokenWindows(train_tokens, block, device),
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
            blob = json.dumps(cfg.to_dict(), sort_keys=True, default=str)
            self._emit({
                "record": "run_header",
                "config_hash": hashlib.sha1(blob.encode()).hexdigest()[:12],
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


def train(cfg: TrainConfig, tokens_path: str, device="cuda",
          dist_backend: Optional[str] = None) -> tuple:
    """Run the recipe for ``cfg.max_iters`` steps on ``device``. Returns
    (final train state, per-step metrics list). With ``cfg.mesh.sequence``
    > 1 this process is one rank of the ring: ``dist_backend`` (``nccl``
    or ``gloo``) must be named, and ``device`` picks cuda or cpu (gloo)."""
    if cfg.sampler != "replacement":
        raise NotImplementedError(
            f"sampler {cfg.sampler!r}: the epoch sampler (the exact epoch "
            "permutation) is not ported yet (ROADMAP Queue A: data); pass "
            "sampler='replacement'"
        )
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
        logger = MetricLogger(cfg, device, group is None or group.rank == 0)
        try:
            return _train_loop(cfg, tokens_path, device, group, logger)
        finally:
            logger.close()
    finally:
        if group is not None:
            destroy_sequence_group(group)


def _train_loop(cfg: TrainConfig, tokens_path: str, device: torch.device,
                group, logger: MetricLogger) -> tuple:
    model_cfg = cfg.resolved_model()
    if device.type == "cuda":
        check_card_envelope(model_cfg, "train")
    train_ds, val_ds = build_data(cfg, tokens_path, device, logger.say)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    state = create_train_state(gen, cfg, device)
    train_step = make_train_step(cfg, group)
    eval_many = make_eval_many(cfg, group)
    data_rng = np.random.default_rng(cfg.seed)
    eval_rng = np.random.default_rng(cfg.seed + 1)
    # the dropout seed of step i is fold_seed(seed + 2, i): JAX folds the
    # iteration into PRNGKey(seed + 2); eval runs without one
    dropout_seed = cfg.seed + 2 if model_cfg.dropout > 0.0 else None
    tokens_per_step = cfg.micro_batch_size * cfg.grad_acc_steps * model_cfg.block_size
    history = []
    where = (f"{device}" if group is None else
             f"{group.size} ranks over {group.backend} (rank 0 on {device})")
    logger.say(f"Starting training on {where} ({model_cfg.model}, "
               f"{model_cfg.n_layer} layers, width {model_cfg.n_embd}, "
               f"{model_cfg.n_head} heads)")
    t0 = time.time()
    throughput = Throughput()
    tokens_seen = 0
    # wall time of each iteration (batch draw included) and the batch
    # draw's share of it, summed since the last log, as the JAX trainer
    # keeps them
    acc_step = acc_data = 0.0
    acc_n = 0
    iter_num = state["step"]
    while iter_num < cfg.max_iters:
        t_iter = time.perf_counter()
        batch = train_ds.random_batches(data_rng, cfg.micro_batch_size,
                                        cfg.grad_acc_steps)
        data_wait = time.perf_counter() - t_iter
        seed = (None if dropout_seed is None
                else fold_seed(dropout_seed, iter_num))
        state, metrics = train_step(state, batch, seed)
        step_wall = time.perf_counter() - t_iter
        metrics["step_time_ms"] = 1e3 * step_wall
        history.append(metrics)
        iter_num += 1
        tokens_seen += tokens_per_step
        acc_step += step_wall
        acc_data += data_wait
        acc_n += 1
        if iter_num % cfg.log_interval == 0:
            extra = {}
            if cfg.anomaly_guard:
                extra["skipped_steps"] = metrics["skipped"]
            extra["step_time_ms"] = round(1e3 * acc_step / max(acc_n, 1), 3)
            extra["data_wait_frac"] = round(acc_data / max(acc_step, 1e-9), 4)
            acc_step = acc_data = 0.0
            acc_n = 0
            logger.log_step(iter_num, metrics["loss"],
                            metrics["learning_rate"],
                            throughput.update(tokens_seen), extra)
        if iter_num % cfg.eval_interval == 0:
            losses = estimate_loss(eval_many, state["params"], train_ds,
                                   val_ds, cfg, eval_rng)
            logger.log_eval(iter_num, losses["train"], losses["val"])
    dt = time.time() - t0
    seen = len(history) * tokens_per_step
    logger.say(f"Training done: {seen} tokens in {dt:.1f}s "
               f"({seen / max(dt, 1e-9):.0f} tokens/sec)")
    return state, history
