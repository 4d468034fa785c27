"""StandardTransformer (the vanilla-attention control model): param
init in the JAX package's layout and the training forward. RoPE is its
only position encoding; no position table. Its attention is the
multi-stream form with S = 1 and coefficient 1, on the per-array
token-major route or, with attention dropout or past T = 512, the
head-major one (models/common.py:flash_attention); its serving forward
is models/decode.py's."""

from __future__ import annotations

import torch

from differential_transformer_replication_tpu_torch.config import ModelConfig
from differential_transformer_replication_tpu_torch.models import common
from differential_transformer_replication_tpu_torch.ops.rope import rope_cos_sin

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


def _attn(x: torch.Tensor, p: dict, cfg: ModelConfig, cos, sin,
          seed=None, group=None) -> torch.Tensor:
    B, T, _ = x.shape
    s_att, s_out = common.split_seed(seed, 2)
    out = common.flash_attention(x, p["wq"][None], p["wk"][None], p["wv"],
                                 common.layer_coeffs(cfg, p, 1), cos, sin,
                                 rate=cfg.dropout, seed=s_att, group=group,
                                 seq_impl=cfg.sequence_impl)
    out = common.row_linear(out.reshape(B, T, -1), p["out"], common.tensor_line(group))
    return common.apply_dropout(out, cfg.dropout, s_out)


def embed(params: dict, idx: torch.Tensor, cfg: ModelConfig,
          group=None) -> torch.Tensor:
    """Token embedding only (RoPE is the position encoding); on a tensor
    line the table's rows are sharded and the lookups' sum reduced."""
    tp = common.tensor_line(group)
    x = common.reduce_from_region(common.embed_rows(params["tok_emb"], idx, tp), tp)
    return x.to(common.compute_dtype(cfg))


def block_forward(x: torch.Tensor, blk: dict, layer_idx: int,
                  cfg: ModelConfig, cos=None, sin=None, seed=None,
                  group=None) -> torch.Tensor:
    """One pre-LN residual block (``layer_idx`` unused: no schedule)."""
    del layer_idx
    s_attn, s_ffn = common.split_seed(seed, 2)
    a = _attn(common.apply_pre_norm(x, blk["ln1"]), blk["attn"], cfg, cos, sin,
              s_attn, group)
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
