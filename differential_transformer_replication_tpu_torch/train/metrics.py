"""Metric logging with pluggable sinks.

Counterpart of the JAX package's ``train/metrics.py``: stdout prints in
the reference's format and ``metrics.jsonl`` records with the JAX
trainer's keys and cadence (``iter``/``loss``/``learning_rate``/
``gpu_memory`` every log_interval; ``train_loss``/``val_loss`` every
eval_interval), with sinks:
  - stdout (always, primary rank only),
  - JSONL append (unless ``metrics_path`` is empty),
  - wandb (optional, only if installed and enabled; a missing wandb is
    a printed line, never an error).

Every record carries ``ts``; each logger writes one ``run_header``
record (config hash, torch version, device kind and count, process
count); ``gpu_memory`` is ``torch.cuda.memory_allocated`` in MB and is
OMITTED on the CPU, never logged as 0.0; :meth:`MetricLogger.log_record`
appends typed records (the introspection rows, the watchdog's ``hang``
row).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

import torch

from differential_transformer_replication_tpu_torch.config import TrainConfig
from differential_transformer_replication_tpu_torch.train import checkpoint


def device_memory_mb(device) -> Optional[float]:
    """Allocated device memory in MB on a CUDA ``device`` (the reference's
    ``torch.cuda.memory_allocated / 1024**2``), or None on the CPU:
    callers OMIT the metric rather than log a misleading zero."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.memory_allocated(device) / 1024 ** 2


def config_hash(cfg: TrainConfig) -> str:
    """Stable short hash of the full recipe (the JAX package's): two
    streams with the same hash are the same experiment."""
    return checkpoint.config_hash(cfg.to_dict())


class MetricLogger:
    """stdout + metrics.jsonl (+ wandb) for one process; only the primary
    rank prints and writes. Records arrive from the train loop and from
    the watchdog's thread, so writes hold a lock."""

    # sentinel: "the caller did not sample memory — query it here";
    # distinct from None, which means "sampled and unavailable"
    _QUERY_MEMORY = object()

    def __init__(self, cfg: TrainConfig, device, primary: bool = True):
        self.cfg = cfg
        self.device = torch.device(device)
        self._jsonl = None
        self._wandb = None
        self._emit_lock = threading.Lock()
        self._primary = primary
        if not primary:
            return
        if cfg.metrics_path:
            self._jsonl = open(cfg.metrics_path, "a", buffering=1)
            cuda = self.device.type == "cuda"
            self._emit({
                "record": "run_header",
                "config_hash": config_hash(cfg),
                "torch_version": torch.__version__,
                "device_kind": (torch.cuda.get_device_name(self.device)
                                if cuda else "cpu"),
                "device_count": torch.cuda.device_count() if cuda else 1,
                "process_count": cfg.mesh.n_devices,
                "model": cfg.resolved_model().model,
            })
        if cfg.use_wandb:
            try:
                import wandb

                wandb.init(project=cfg.wandb_project, name=cfg.wandb_run_name,
                           config=cfg.to_dict())
                self._wandb = wandb
            except Exception as e:  # noqa: BLE001
                print(f"[metrics] wandb unavailable ({type(e).__name__}); "
                      "continuing without")

    def _emit(self, payload: dict) -> None:
        payload.setdefault("ts", round(time.time(), 3))
        with self._emit_lock:
            if self._jsonl is not None:
                self._jsonl.write(json.dumps(payload) + "\n")
            if self._wandb is not None:
                self._wandb.log(payload)

    def say(self, msg: str) -> None:
        if self._primary:
            print(msg, flush=True)

    def log_step(self, iter_num: int, loss: float, lr: float,
                 tokens_per_sec: Optional[float] = None,
                 extra: Optional[dict] = None,
                 gpu_memory_mb=_QUERY_MEMORY) -> None:
        """Per-log_interval metrics, plus tokens/sec (none on the first
        log) and ``extra`` (the guard's ``skipped_steps``/``rollbacks``,
        ``step_time_ms``, ``data_wait_frac``, checkpoint costs).
        ``gpu_memory_mb`` lets a caller that already sampled
        :func:`device_memory_mb` pass the same value."""
        if not self._primary:
            return
        self.say(f"iter {iter_num}: loss {loss:.4f}, lr {lr:.2e}")
        payload = {"iter": iter_num, "loss": loss, "learning_rate": lr}
        mem = (device_memory_mb(self.device)
               if gpu_memory_mb is MetricLogger._QUERY_MEMORY else gpu_memory_mb)
        if mem is not None:  # omitted, never a fake 0.0
            payload["gpu_memory"] = mem
        if tokens_per_sec is not None:
            payload["tokens_per_sec"] = round(tokens_per_sec, 1)
        if extra:
            payload.update(extra)
        self._emit(payload)

    def log_eval(self, iter_num: int, train_loss: float, val_loss: float) -> None:
        if not self._primary:
            return
        self.say(f"step {iter_num}: train loss {train_loss:.4f}, val loss "
                 f"{val_loss:.4f}")
        self._emit({"iter": iter_num, "train_loss": train_loss,
                    "val_loss": val_loss})

    def log_record(self, payload: dict) -> None:
        """Append one typed record (``{"record": "introspection", ...}``,
        the watchdog's ``hang``); primary rank only, ``ts`` added."""
        if not self._primary:
            return
        self._emit(dict(payload))

    def finish(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
