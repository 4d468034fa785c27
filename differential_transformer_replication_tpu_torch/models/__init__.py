"""Models of the PyTorch port: per-family param init (JAX layout), the
training forward (registry.model_forward), the cached serving forward
(models/decode.py) and the two generators: ``generate`` (windowed, on
the training forward) and ``generate_cached`` (prefill, then one decode
step a token)."""

from differential_transformer_replication_tpu_torch.models.registry import (  # noqa: F401
    check_card_envelope,
    init_model,
    model_forward,
    param_count,
)
from differential_transformer_replication_tpu_torch.models.decode import (  # noqa: F401,E402
    generate_cached,
)
from differential_transformer_replication_tpu_torch.models.generate import (  # noqa: F401,E402
    generate,
    sample_token,
)
