"""AlternatingDiffTransformer (N-term differential attention): param
init in the JAX package's layout and the training forward. RoPE
positions, n_terms Q/K projections stacked on a leading term axis, one
doubled value, per-term zero-init lambda vectors (the chain where term
i subtracts term i-1's exponential, the first map scaled by lambda_0),
1-based layer indices, a full-width GroupLayerNorm and the constant 0.2
output scale. Its attention takes the per-array token-major route, or
the head-major one with attention dropout or past T = 512."""

from __future__ import annotations

import torch

from differential_transformer_replication_tpu_torch.config import ModelConfig
from differential_transformer_replication_tpu_torch.models import common
from differential_transformer_replication_tpu_torch.ops.lambdas import OUTPUT_SCALE
from differential_transformer_replication_tpu_torch.ops.rope import rope_cos_sin

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


def _attn(x: torch.Tensor, p: dict, layer_idx: int, cfg: ModelConfig, cos,
          sin, seed=None, group=None) -> torch.Tensor:
    B, T, _ = x.shape
    s_att, s_out = common.split_seed(seed, 2)
    out = common.flash_attention(x, p["wq"], p["wk"], p["wv"],
                                 common.layer_coeffs(cfg, p, layer_idx), cos, sin,
                                 rate=cfg.dropout, seed=s_att, group=group,
                                 seq_impl=cfg.sequence_impl)
    tp = common.tensor_line(group)
    out = common.apply_group_norm(out.reshape(B, T, -1), p["gn"], tp)
    out = common.row_linear(out * OUTPUT_SCALE, p["out"], tp)
    return common.apply_dropout(out, cfg.dropout, s_out)


def embed(params: dict, idx: torch.Tensor, cfg: ModelConfig,
          group=None) -> torch.Tensor:
    """Token embedding only (RoPE positions); on a tensor
    line the table's rows are sharded and the lookups' sum reduced."""
    tp = common.tensor_line(group)
    x = common.reduce_from_region(common.embed_rows(params["tok_emb"], idx, tp), tp)
    return x.to(common.compute_dtype(cfg))


def block_forward(x: torch.Tensor, blk: dict, layer_idx: int,
                  cfg: ModelConfig, cos=None, sin=None, seed=None,
                  group=None) -> torch.Tensor:
    """One pre-LN residual block; ``layer_idx`` is 1-based."""
    s_attn, s_ffn = common.split_seed(seed, 2)
    a = _attn(common.apply_pre_norm(x, blk["ln1"]), blk["attn"], layer_idx,
              cfg, cos, sin, s_attn, group)
    return common.apply_block_ffn(x, a, blk, cfg.dropout, s_ffn,
                                  common.tensor_line(group))


def forward(params: dict, idx: torch.Tensor, cfg: ModelConfig, targets=None,
            seed=None, group=None):
    """(B, T) int64 tokens -> (logits (B, T, V), loss or None); ``seed``
    turns dropout on (None: eval); ``group`` the sequence ring, whose rank
    holds the T-shard ``idx`` (RoPE at its global positions)."""
    x = embed(params, idx, cfg, group)
    T = idx.shape[-1]
    t0 = common.shard_start(T, group)
    cos, sin = (t[t0:] for t in rope_cos_sin(cfg.head_size, t0 + T, device=x.device))
    seeds = common.split_seed(common.rank_seed(seed, group), cfg.n_layer)
    fn = common.remat_block(block_forward, cfg) if cfg.remat else block_forward
    for li, (blk, s) in enumerate(zip(params["blocks"], seeds), 1):
        x = fn(x, blk, li, cfg, cos, sin, s, group)
    return common.tail_and_loss(x, params, cfg, targets, group)
