"""AlternatingDiffTransformer (N-term differential attention): param
init in the JAX package's layout. RoPE positions, n_terms Q/K
projections stacked on a leading term axis, one doubled value, per-term
zero-init lambda vectors and a full-width GroupLayerNorm."""

from __future__ import annotations

import torch

from differential_transformer_replication_tpu_torch.config import ModelConfig
from differential_transformer_replication_tpu_torch.models import common

USES_ROPE = True


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    H, d, E, n = cfg.n_head, cfg.head_size, cfg.n_embd, cfg.n_terms
    dev = gen.device
    blocks = []
    for _ in range(cfg.n_layer):
        blocks.append({
            "ln1": common.layer_norm_params(E, dev),
            "attn": {
                "wq": common.normal_init(gen, (n, E, H, d)),
                "wk": common.normal_init(gen, (n, E, H, d)),
                "wv": common.normal_init(gen, (E, H, 2 * d)),
                "lambda_q": torch.zeros((n, H, d), dtype=torch.float32, device=dev),
                "lambda_k": torch.zeros((n, H, d), dtype=torch.float32, device=dev),
                "gn": common.layer_norm_params(H * 2 * d, dev),
                "out": common.linear_params(gen, H * 2 * d, E),
            },
            "ln2": common.layer_norm_params(E, dev),
            "ffn": common.ffn_params(gen, E),
        })
    return {
        "tok_emb": common.normal_init(gen, (cfg.vocab_size, E)),
        "blocks": blocks,
        "ln_f": common.layer_norm_params(E, dev),
        "lm_head": common.linear_params(gen, E, cfg.vocab_size),
    }
