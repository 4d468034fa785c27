"""DiffTransformer (2-term differential attention): param init in the
JAX package's layout. Learned ABSOLUTE position embeddings (the only
family with a position table, so it cannot roll past block_size), two
Q/K streams stacked on a leading axis, a doubled value projection, zero-
init lambda vectors and a full-width GroupLayerNorm."""

from __future__ import annotations

import torch

from differential_transformer_replication_tpu_torch.config import ModelConfig
from differential_transformer_replication_tpu_torch.models import common

USES_ROPE = False


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    H, d, E = cfg.n_head, cfg.head_size, cfg.n_embd
    dev = gen.device
    blocks = []
    for _ in range(cfg.n_layer):
        blocks.append({
            "ln1": common.layer_norm_params(E, dev),
            "attn": {
                "wq": common.normal_init(gen, (2, E, H, d)),
                "wk": common.normal_init(gen, (2, E, H, d)),
                "wv": common.normal_init(gen, (E, H, 2 * d)),
                "lambda_q": torch.zeros((2, H, d), dtype=torch.float32, device=dev),
                "lambda_k": torch.zeros((2, H, d), dtype=torch.float32, device=dev),
                "gn": common.layer_norm_params(H * 2 * d, dev),
                "out": common.linear_params(gen, H * 2 * d, E),
            },
            "ln2": common.layer_norm_params(E, dev),
            "ffn": common.ffn_params(gen, E),
        })
    return {
        "tok_emb": common.normal_init(gen, (cfg.vocab_size, E)),
        "pos_emb": common.normal_init(gen, (cfg.block_size, E)),
        "blocks": blocks,
        "ln_f": common.layer_norm_params(E, dev),
        "lm_head": common.linear_params(gen, E, cfg.vocab_size),
    }
