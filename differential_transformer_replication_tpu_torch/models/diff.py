"""DiffTransformer (2-term differential attention): param init in the
JAX package's layout and the training forward. Learned ABSOLUTE
position embeddings (the only family with a position table, so it
cannot roll past block_size), two Q/K streams stacked on a leading
axis, a doubled value projection, zero-init lambda vectors, the
per-layer lambda schedule with 1-BASED layer indices, a full-width
GroupLayerNorm and the constant 0.2 output scale. Its attention takes
the packed token-major route, or the head-major one with attention
dropout or past T = 512 (models/common.py:flash_attention)."""

from __future__ import annotations

import torch

import torch.nn.functional as F

from differential_transformer_replication_tpu_torch.config import ModelConfig
from differential_transformer_replication_tpu_torch.models import common
from differential_transformer_replication_tpu_torch.ops.lambdas import OUTPUT_SCALE

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


def _attn(x: torch.Tensor, p: dict, layer_idx: int, cfg: ModelConfig,
          seed=None, group=None) -> torch.Tensor:
    B, T, _ = x.shape
    s_att, s_out = common.split_seed(seed, 2)
    out = common.flash_attention(x, p["wq"], p["wk"], p["wv"],
                                 common.layer_coeffs(cfg, p, layer_idx),
                                 rate=cfg.dropout, seed=s_att, group=group,
                                 seq_impl=cfg.sequence_impl)
    tp = common.tensor_line(group)
    out = common.apply_group_norm(out.reshape(B, T, -1), p["gn"], tp)
    out = common.row_linear(out * OUTPUT_SCALE, p["out"], tp)
    return common.apply_dropout(out, cfg.dropout, s_out)


def embed(params: dict, idx: torch.Tensor, cfg: ModelConfig,
          group=None) -> torch.Tensor:
    """Token embedding PLUS the learned absolute position table (added in
    fp32, then cast to the compute dtype); on the ring, the rows of this
    rank's global positions. On a tensor line both tables are row shards:
    each rank looks up the rows it holds and the sum is reduced."""
    T = idx.shape[-1]
    t0 = common.shard_start(T, group)
    if t0 + T > cfg.block_size:
        raise ValueError(f"sequence length {t0 + T} exceeds block_size {cfg.block_size}")
    tp = common.tensor_line(group)
    if tp is None:
        x = F.embedding(idx, params["tok_emb"]) + params["pos_emb"][t0:t0 + T]
    else:
        pos = torch.arange(t0, t0 + T, device=idx.device)
        x = common.reduce_from_region(common.embed_rows(params["tok_emb"], idx, tp)
                                      + common.embed_rows(params["pos_emb"], pos, tp), tp)
    return x.to(common.compute_dtype(cfg))


def block_forward(x: torch.Tensor, blk: dict, layer_idx: int,
                  cfg: ModelConfig, cos=None, sin=None, seed=None,
                  group=None) -> torch.Tensor:
    """One pre-LN residual block; ``layer_idx`` is 1-based; ``seed`` the
    block's dropout seed (None: no dropout); ``group`` the sequence ring."""
    del cos, sin  # no RoPE in this family
    s_attn, s_ffn = common.split_seed(seed, 2)
    a = _attn(common.apply_pre_norm(x, blk["ln1"]), blk["attn"], layer_idx,
              cfg, s_attn, group)
    return common.apply_block_ffn(x, a, blk, cfg.dropout, s_ffn,
                                  common.tensor_line(group))


def forward(params: dict, idx: torch.Tensor, cfg: ModelConfig, targets=None,
            seed=None, group=None):
    """(B, T) int64 tokens -> (logits (B, T, V), loss or None); ``seed``
    turns dropout on (None: eval); ``group`` the sequence ring, whose rank
    holds the T-shard ``idx``."""
    x = embed(params, idx, cfg, group)
    seeds = common.split_seed(common.rank_seed(seed, group), cfg.n_layer)
    fn = common.remat_block(block_forward, cfg) if cfg.remat else block_forward
    for li, (blk, s) in enumerate(zip(params["blocks"], seeds), 1):
        x = fn(x, blk, li, cfg, None, None, s, group)
    return common.tail_and_loss(x, params, cfg, targets, group)
