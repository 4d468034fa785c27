"""StandardTransformer (the vanilla-attention control model): param
init in the JAX package's layout. RoPE is its only position encoding;
no position table. Its forward on the serving path is
models/decode.py's shared multi-stream form with S = 1."""

from __future__ import annotations

import torch

from differential_transformer_replication_tpu_torch.config import ModelConfig
from differential_transformer_replication_tpu_torch.models import common

USES_ROPE = True


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    H, d, E = cfg.n_head, cfg.head_size, cfg.n_embd
    dev = gen.device
    blocks = []
    for _ in range(cfg.n_layer):
        blocks.append({
            "ln1": common.layer_norm_params(E, dev),
            "attn": {
                # merged per-head Q/K/V projections, no bias
                "wq": common.normal_init(gen, (E, H, d)),
                "wk": common.normal_init(gen, (E, H, d)),
                "wv": common.normal_init(gen, (E, H, d)),
                "out": common.linear_params(gen, H * d, E),
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
