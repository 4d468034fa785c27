"""Model-select switch: ``ModelConfig.model`` picks the family's init
and training forward. All three families share the serving forward in
models/decode.py."""

from __future__ import annotations

import torch

from differential_transformer_replication_tpu_torch.config import ModelConfig
from differential_transformer_replication_tpu_torch.models import control, diff, ndiff
from differential_transformer_replication_tpu_torch.models.decode import n_streams
from differential_transformer_replication_tpu_torch.ops import decode_attention, flash

_MODULES = {"control": control, "diff": diff, "ndiff": ndiff}


def init_model(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random params in the JAX layout, drawn from ``gen`` on its device."""
    return _MODULES[cfg.model].init(gen, cfg)


def model_forward(params: dict, idx: torch.Tensor, cfg: ModelConfig,
                  targets=None, seed=None, group=None):
    """(B, T) int64 tokens -> (logits (B, T, V), loss or None). ``seed``
    (an int) turns on the ``cfg.dropout`` sites, the counterpart of the
    JAX ``rng``; None is eval. ``group`` (a ``parallel.SequenceGroup``,
    the counterpart of the JAX ``mesh``) runs the sequence-parallel ring:
    ``idx``/``targets`` are then this rank's T-shards and the loss its
    share of the global mean."""
    return _MODULES[cfg.model].forward(params, idx, cfg, targets=targets,
                                       seed=seed, group=group)


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, list):
        return sum(param_count(v) for v in params)
    return params.numel()


def check_card_envelope(cfg: ModelConfig, use: str) -> None:
    """Hold a model's stream count and head widths against the kernels
    that ``use`` launches on the card: ``"train"`` the training attention
    (d <= 128, dv <= 256, any number of streams), ``"serve"`` the decode
    attention (S <= 8, d <= 256, dv <= 512). The trainer and the serving
    engine call it before their first launch on a CUDA device; the CPU's
    plain versions take any width, as JAX does."""
    if use == "train":
        limits = {"d": flash.MAX_D, "dv": flash.MAX_DV}
        kernels = "the training attention kernels"
    elif use == "serve":
        limits = {"S": decode_attention.MAX_S, "d": decode_attention.MAX_D,
                  "dv": decode_attention.MAX_DV}
        kernels = "the decode attention kernel"
    else:
        raise ValueError(f"use must be 'train' or 'serve', got {use!r}")
    got = {"S": n_streams(cfg), "d": cfg.head_size, "dv": cfg.value_size}
    over = [f"{k} = {got[k]} > {lim}" for k, lim in limits.items()
            if got[k] > lim]
    if over:
        raise ValueError(
            f"{cfg.model} (n_embd {cfg.n_embd}, n_head {cfg.n_head}): "
            f"{', '.join(over)}, past what {kernels} take on the card "
            "(ROADMAP Queue C: head widths)"
        )
