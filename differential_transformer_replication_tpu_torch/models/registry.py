"""Model-select switch: ``ModelConfig.model`` picks the family's init
and training forward. All three families share the serving forward in
models/decode.py."""

from __future__ import annotations

import torch

from differential_transformer_replication_tpu_torch.config import ModelConfig
from differential_transformer_replication_tpu_torch.models import control, diff, ndiff

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
