"""Models of the PyTorch port: per-family param init (JAX layout), the
training forward (registry.model_forward) and the cached serving
forward (models/decode.py)."""

from differential_transformer_replication_tpu_torch.models.registry import (  # noqa: F401
    check_card_envelope,
    init_model,
    model_forward,
    param_count,
)
