"""KV-cache incremental decoding: the serving forward of the port
(contiguous float cache).

Counterpart of ``differential_transformer_replication_tpu/models/decode.py``
with the same layouts and semantics. The per-layer cache is a RING over
``block_size`` slots, HEAD-MAJOR: K is per-stream (S, B, H, M, d), V is
shared across streams (B, H, M, dv). ``forward_chunk`` runs L tokens
starting at absolute position ``pos`` against one or more cache rows
(prefill), and ``forward_decode_pool`` advances a whole slot pool by one
token with every row at its own position (decode), its attention running
through the decode-attention kernel. All three families run the shared
multi-stream form (ops/streams.py): per-stream K, per-stream softmax,
coefficient combine, then plain concat (control) or GroupLayerNorm and
the constant 0.2 scale (diff/ndiff). Control and ndiff rotate q/k with
RoPE at absolute positions and may roll the ring past block_size
(sliding-window attention); diff adds its learned position table and is
capped at block_size.

Where the port differs from the JAX functions, by design:

- Caches are updated IN PLACE. ``forward_chunk`` writes the chunk's K/V
  into the cache tensors it is given (views of a pool row work, so a
  prefill writes straight into the pool), and ``forward_decode_pool``
  writes only the ACTIVE rows' K/V (``active`` row indices) instead of
  computing every row and discarding inactive rows with a masked merge
  (the JAX ``merge_cache_update``). Both return the same cache list.
- Prefill attention is plain PyTorch, as it is plain XLA in the JAX
  package; the norms, the SwiGLU chain and the decode attention go
  through the kernel wrappers, which dispatch by device.
- The int8 KV cache belongs to a later slice: ``kv_cache_dtype="int8"``
  raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from differential_transformer_replication_tpu_torch.config import ModelConfig
from differential_transformer_replication_tpu_torch.models import common
from differential_transformer_replication_tpu_torch.ops.decode_attention import (
    decode_attention,
)
from differential_transformer_replication_tpu_torch.ops.lambdas import OUTPUT_SCALE
from differential_transformer_replication_tpu_torch.ops.rope import (
    apply_rope,
    rope_cos_sin,
    rope_rows,
)
from differential_transformer_replication_tpu_torch.ops.streams import NEG_INF

DTYPES = common.DTYPES
compute_dtype = common.compute_dtype


def _n_streams(cfg: ModelConfig) -> int:
    return {"control": 1, "diff": 2, "ndiff": cfg.n_terms}[cfg.model]


def _uses_rope(cfg: ModelConfig) -> bool:
    return cfg.model in ("control", "ndiff")


def kv_store_dtype(cfg: ModelConfig) -> torch.dtype:
    """Resolved KV-cache storage dtype ("auto" stores compute_dtype)."""
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            "kv_cache_dtype='int8' is not ported yet (float KV only)"
        )
    if cfg.kv_cache_dtype == "bf16":
        return torch.bfloat16
    return compute_dtype(cfg)


def init_cache(cfg: ModelConfig, batch_size: int, device=None) -> list:
    """Per-layer zeroed K (S, B, H, M, d) / V (B, H, M, dv) buffers."""
    S = _n_streams(cfg)
    H, d, dv, M = cfg.n_head, cfg.head_size, cfg.value_size, cfg.block_size
    dt = kv_store_dtype(cfg)
    return [
        {"k": torch.zeros((S, batch_size, H, M, d), dtype=dt, device=device),
         "v": torch.zeros((batch_size, H, M, dv), dtype=dt, device=device)}
        for _ in range(cfg.n_layer)
    ]


def _write_chunk(layer_cache: dict, ks: torch.Tensor, v: torch.Tensor,
                 slot: int) -> None:
    """Write one chunk's K/V — ks (S, B, L, H, d), v (B, L, H, dv) — into
    the ring at ``slot`` (in place)."""
    L = v.shape[1]
    k, vc = layer_cache["k"], layer_cache["v"]
    k[:, :, :, slot:slot + L] = ks.permute(0, 1, 3, 2, 4).to(k.dtype)
    vc[:, :, slot:slot + L] = v.permute(0, 2, 1, 3).to(vc.dtype)


def _stacked_wq(p_attn: dict):
    """Normalize the per-family weight layouts to stacked (S, E, H, d)."""
    wq, wk = p_attn["wq"], p_attn["wk"]
    if wq.dim() == 3:  # control: (E, H, d)
        wq, wk = wq[None], wk[None]
    return wq, wk


def _post_attention(out: torch.Tensor, p_attn: dict, cfg: ModelConfig):
    """Head concat -> (diff/ndiff: GroupLayerNorm, x0.2) -> out-proj."""
    if cfg.model in ("diff", "ndiff"):
        out = common.apply_group_norm(out, p_attn["gn"]) * OUTPUT_SCALE
    return common.linear(out, p_attn["out"])


def _attn_chunk(x: torch.Tensor, p_attn: dict, layer_cache: dict, pos: int,
                layer_idx: int, cfg: ModelConfig, cos, sin,
                window: int = 0) -> torch.Tensor:
    """One layer's attention for a chunk: x (B, L, E) normed input,
    update-then-attend over the ring (plain PyTorch)."""
    B, L, E = x.shape
    M = cfg.block_size
    W = int(window) if window else M
    wq, wk = _stacked_wq(p_attn)
    qs = torch.einsum("ble,sehd->sblhd", x, wq.to(x.dtype))
    ks = torch.einsum("ble,sehd->sblhd", x, wk.to(x.dtype))
    v = torch.einsum("ble,ehd->blhd", x, p_attn["wv"].to(x.dtype))
    if _uses_rope(cfg):
        qs = apply_rope(qs, cos, sin)
        ks = apply_rope(ks, cos, sin)
    _write_chunk(layer_cache, ks, v, pos % M)
    k_cache, v_cache = layer_cache["k"], layer_cache["v"]

    scale = 1.0 / (cfg.head_size ** 0.5)
    scores = torch.einsum("sblhd,sbhmd->sbhlm", qs, k_cache).to(torch.float32) * scale
    # Ring-aware causal mask over absolute positions: after this chunk's
    # write the latest position is ``last``; slot m holds position
    # ``last - ((last - m) rem M)`` (negative = never written). Row l at
    # pos+l sees a slot iff its held position is in [row - W + 1, row].
    dev = x.device
    rows = pos + torch.arange(L, device=dev)[:, None]
    slots = torch.arange(M, device=dev)[None, :]
    last = pos + L - 1
    held = last - torch.fmod(last - slots, M)
    visible = (held <= rows) & (held >= 0) & (held > rows - W)
    scores = torch.where(visible[None, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)  # per stream, fp32

    coeffs = common.layer_coeffs(cfg, p_attn, layer_idx)
    combined = torch.einsum("sh,sbhlm->bhlm", coeffs, probs)
    out = torch.einsum("bhlm,bhme->blhe", combined.to(v.dtype), v_cache)
    return _post_attention(out.reshape(B, L, -1), p_attn, cfg)


def forward_chunk(params: dict, tokens: torch.Tensor, pos: int, cache: list,
                  cfg: ModelConfig, rope_len: int = 0,
                  window: int = 0) -> Tuple[torch.Tensor, list]:
    """Process ``tokens`` (B, L) at absolute positions [pos, pos+L)
    against ``cache`` (written in place). Returns ((B, L, V) logits,
    cache). Chunks that cannot be represented fail loudly: the diff
    family past block_size, RoPE positions past the table (pass a bigger
    ``rope_len``), multi-token chunks at rolled positions, and writes
    wrapping the ring boundary."""
    B, L = tokens.shape
    M = cfg.block_size
    pos = int(pos)
    if cfg.model == "diff" and pos + L > M:
        raise ValueError(
            f"chunk [{pos}, {pos + L}) exceeds block_size {M}: the diff "
            "family's learned absolute position table cannot roll (each "
            "slide would re-embed every cached position)"
        )
    if cfg.model != "diff" and pos + L > max(int(rope_len), M):
        raise ValueError(
            f"chunk [{pos}, {pos + L}) exceeds the RoPE table length "
            f"{max(int(rope_len), M)}: pass rope_len >= the final position"
        )
    if pos >= M and L > 1:
        raise ValueError(
            f"multi-token chunk at rolled position {pos} >= block_size "
            f"{M}: its in-chunk writes would evict keys still inside "
            "earlier rows' sliding windows; feed rolled positions one "
            "token at a time"
        )
    if (pos % M) + L > M:
        raise ValueError(
            f"chunk [{pos}, {pos + L}) wraps the ring boundary (slot "
            f"{pos % M} + {L} > {M}): split it at the boundary"
        )
    compute = compute_dtype(cfg)
    x = params["tok_emb"][tokens].to(compute)
    cos = sin = None
    if cfg.model == "diff":
        x = x + params["pos_emb"][pos:pos + L].to(compute)
    else:
        cos_full, sin_full = rope_cos_sin(cfg.head_size, max(int(rope_len), M),
                                          device=x.device)
        cos, sin = cos_full[pos:pos + L], sin_full[pos:pos + L]
    for li, blk in enumerate(params["blocks"], 1):  # 1-based schedule
        a = _attn_chunk(common.apply_pre_norm(x, blk["ln1"]), blk["attn"],
                        cache[li - 1], pos, li, cfg, cos, sin, window=window)
        x = common.apply_block_ffn(x, a, blk)
    x = common.apply_pre_norm(x, params["ln_f"])
    return common.linear(x, params["lm_head"]), cache


def _update_cache_rows(layer_cache: dict, ks: torch.Tensor, v: torch.Tensor,
                       pos: torch.Tensor, M: int,
                       rows: Optional[torch.Tensor] = None) -> None:
    """Write each given row's new K/V — ks (S, B, H, d), v (B, H, dv) —
    into its own ring slot ``pos[b] % M``, in place; ``rows`` (int64
    indices) limits the write to the active rows (all rows when None)."""
    k, vc = layer_cache["k"], layer_cache["v"]
    if rows is None:
        rows = torch.arange(v.shape[0], device=v.device)
    slot = torch.remainder(pos.to(torch.int64), M)[rows]
    # advanced indices split by a slice put the row axis first
    k[:, rows, :, slot] = ks[:, rows].permute(1, 0, 2, 3).to(k.dtype)
    vc[rows, :, slot] = v[rows].to(vc.dtype)


def _pool_attn(x: torch.Tensor, p_attn: dict, layer_cache: dict,
               pos: torch.Tensor, layer_idx: int, cfg: ModelConfig, cos, sin,
               rows: Optional[torch.Tensor]) -> torch.Tensor:
    """The batched L=1 twin of :func:`_attn_chunk`: x (B, E) normed,
    update-then-attend over every slot row through the decode-attention
    kernel wrapper."""
    B = x.shape[0]
    wq, wk = _stacked_wq(p_attn)
    qs = torch.einsum("be,sehd->sbhd", x, wq.to(x.dtype))
    ks = torch.einsum("be,sehd->sbhd", x, wk.to(x.dtype))
    v = torch.einsum("be,ehd->bhd", x, p_attn["wv"].to(x.dtype))
    if _uses_rope(cfg):
        qs = rope_rows(qs, cos, sin)
        ks = rope_rows(ks, cos, sin)
    _update_cache_rows(layer_cache, ks, v, pos, cfg.block_size, rows)
    coeffs = common.layer_coeffs(cfg, p_attn, layer_idx)
    out = decode_attention(qs.contiguous(), layer_cache["k"], layer_cache["v"],
                           pos, coeffs)
    return _post_attention(out.reshape(B, -1), p_attn, cfg)


def forward_decode_pool(params: dict, tokens: torch.Tensor, pos: torch.Tensor,
                        cache: list, cfg: ModelConfig, rope_len: int = 0,
                        active: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, list]:
    """Advance the whole slot pool by one token: ``tokens`` (B,) int64,
    ``pos`` (B,) int32 absolute positions. Returns ((B, V) logits,
    cache). ``active`` (int64 row indices) selects the rows whose K/V
    are written; other rows compute throwaway logits and leave the pool
    untouched. Position validity is the caller's (the engine's submit
    guards)."""
    M = cfg.block_size
    compute = compute_dtype(cfg)
    x = params["tok_emb"][tokens].to(compute)
    cos = sin = None
    if cfg.model == "diff":
        x = x + params["pos_emb"][pos.to(torch.int64)].to(compute)
    else:
        cos_full, sin_full = rope_cos_sin(cfg.head_size, max(int(rope_len), M),
                                          device=x.device)
        idx = pos.to(torch.int64)
        cos, sin = cos_full[idx], sin_full[idx]
    for li, blk in enumerate(params["blocks"], 1):
        a = _pool_attn(common.apply_pre_norm(x, blk["ln1"]), blk["attn"],
                       cache[li - 1], pos, li, cfg, cos, sin, active)
        x = common.apply_block_ffn(x, a, blk)
    x = common.apply_pre_norm(x, params["ln_f"])
    return common.linear(x, params["lm_head"]), cache
