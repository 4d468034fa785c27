"""KV-cache incremental decoding: the serving forward of the port.

Counterpart of ``differential_transformer_replication_tpu/models/decode.py``
with the same layouts and semantics. The per-layer cache is a RING over
``block_size`` slots, HEAD-MAJOR: K is per-stream (S, B, H, M, d), V is
shared across streams (B, H, M, dv); the int8 cache adds fp32 scale
planes ``k_scale`` (S, B, H, M) and ``v_scale`` (B, H, M)
(ops/decode_attention.py:quantize_kv). ``forward_chunk`` runs L tokens
starting at absolute position ``pos`` against one or more cache rows
(prefill), and ``forward_decode_pool`` advances a whole slot pool by one
token with every row at its own position (decode), its attention
running through the decode-attention kernel. All three families run the
shared multi-stream form (ops/streams.py): per-stream K, per-stream
softmax, coefficient combine, then plain concat (control) or
GroupLayerNorm and the constant 0.2 scale (diff/ndiff). Control and
ndiff rotate q/k with RoPE at absolute positions and may roll the ring
past block_size (sliding-window attention); diff adds its learned
position table and is capped at block_size.

The paged cache (``init_cache_paged``) replaces the (batch, block_size)
axes of every leaf by (pages, page_size); a slot's ring maps onto pages
through its row of a runtime int32 page table, and physical page 0 is
the trash page that unallocated logical pages and inactive rows' writes
land on (never attended). Prefill gathers a slot's ring view through its
table (``gather_slot_cache``), runs ``forward_chunk`` on it and scatters
it back; decode runs ``forward_decode_pool_paged``. The speculative
verify step (``forward_decode_spec`` and its paged twin) advances the
pool by L = k + 1 rows per slot: EXACT as L unrolled L=1 steps, or
BATCHED in one pass through the multi-row decode-attention kernel;
rows past a slot's draft length write to the trash row (contiguous: the
pool carries R = num_slots + 1 rows) or the trash page.

Where the port differs from the JAX functions, by design:

- Caches are updated IN PLACE. ``forward_chunk`` writes the chunk's K/V
  into the cache tensors it is given (views of a pool row work, so a
  prefill writes straight into the pool), and ``forward_decode_pool``
  writes only the ACTIVE rows' K/V (``active`` row indices) instead of
  computing every row and discarding inactive rows with a masked merge
  (the JAX ``merge_cache_update``). Every function returns the same
  cache list it was given.
- Prefill attention is plain PyTorch, as it is plain XLA in the JAX
  package; the norms, the SwiGLU chain and the decode attention go
  through the kernel wrappers, which dispatch by device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from differential_transformer_replication_tpu_torch.config import ModelConfig
from differential_transformer_replication_tpu_torch.models import common
from differential_transformer_replication_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_multi,
    decode_attention_multi_paged,
    decode_attention_paged,
    dequantize_kv,
    quantize_kv,
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

# Pool-batch (or page) axis of each cache leaf: K and its scales carry
# the stream axis first, V does not.
KV_CACHE_BATCH_AXIS = {"k": 1, "v": 0, "k_scale": 1, "v_scale": 0}


def n_streams(cfg: ModelConfig) -> int:
    return {"control": 1, "diff": 2, "ndiff": cfg.n_terms}[cfg.model]


def _uses_rope(cfg: ModelConfig) -> bool:
    return cfg.model in ("control", "ndiff")


def kv_store_dtype(cfg: ModelConfig) -> torch.dtype:
    """Resolved KV-cache storage dtype ("auto" stores compute_dtype)."""
    if cfg.kv_cache_dtype == "int8":
        return torch.int8
    if cfg.kv_cache_dtype == "bf16":
        return torch.bfloat16
    return compute_dtype(cfg)


def entropy_margin(lp: torch.Tensor, proc: torch.Tensor,
                   top2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The first two columns of :func:`quality_vector`, (..., 2) fp32:
    the entropy over ``lp`` and the top-1 margin on ``proc`` (``top2``
    its two largest values, when the caller has them)."""
    plogp = torch.where(torch.isfinite(lp), torch.exp(lp) * lp,
                        torch.zeros_like(lp))
    entropy = -plogp.sum(dim=-1)
    if top2 is None and proc.shape[-1] >= 2:
        top2 = torch.topk(proc, 2, dim=-1).values
    if top2 is not None:
        margin = top2[..., 0] - top2[..., 1]
    else:  # degenerate single-token vocab: no runner-up to compare
        margin = torch.zeros(proc.shape[:-1], dtype=proc.dtype,
                             device=proc.device)
    return torch.stack([entropy.float(), margin.float()], dim=-1)


def quality_vector(lp: torch.Tensor, proc: torch.Tensor, tokens: torch.Tensor,
                   prev: torch.Tensor,
                   top2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-token quality vector (the JAX ``quality_vector``), (..., 3) fp32:

      [..., 0] entropy in nats of the distribution actually drawn from,
               over ``lp``, its log-softmax (top-k and temperature
               applied);
      [..., 1] top-1 logit margin on the processed surface ``proc``
               (before top-k and temperature);
      [..., 2] repetition flag: ``tokens`` equals ``prev`` (``prev < 0``
               = no previous token).

    ``lp``/``proc`` (..., V), ``tokens``/``prev`` (...). ``top2``, when
    given, is the two largest values of ``proc`` (a sampler that ranked
    ``proc`` for its top-k threshold has them). A fully masked row gives
    entropy 0 (``where`` keeps exp(-inf) * -inf out of the sum);
    non-finite logits propagate as non-finite values, which the host
    reads as "no signal" (obs/quality.py). The serving engine computes
    the first two columns on the device (:func:`entropy_margin`) and the
    flag on the host, where the emitted tokens are decided."""
    em = entropy_margin(lp, proc, top2)
    repeat = (tokens == prev) & (prev >= 0)
    return torch.cat([em, repeat.float()[..., None]], dim=-1)


def init_cache(cfg: ModelConfig, batch_size: int, device=None) -> list:
    """Per-layer zeroed K (S, B, H, M, d) / V (B, H, M, dv) buffers, plus
    the fp32 scale planes k_scale (S, B, H, M) / v_scale (B, H, M) on the
    int8 path."""
    S = n_streams(cfg)
    H, d, dv, M = cfg.n_head, cfg.head_size, cfg.value_size, cfg.block_size
    dt = kv_store_dtype(cfg)
    cache = []
    for _ in range(cfg.n_layer):
        layer = {"k": torch.zeros((S, batch_size, H, M, d), dtype=dt, device=device),
                 "v": torch.zeros((batch_size, H, M, dv), dtype=dt, device=device)}
        if dt == torch.int8:
            layer["k_scale"] = torch.zeros((S, batch_size, H, M), device=device)
            layer["v_scale"] = torch.zeros((batch_size, H, M), device=device)
        cache.append(layer)
    return cache


def _dequant_layer(layer_cache: dict, dtype: torch.dtype):
    """The layer's (K, V) as float tensors: the stored tensors on the
    float path, ``float(q) * scale`` rounded to ``dtype`` on the int8
    path (the kernel instead dequantizes inside its tile loads)."""
    if "k_scale" in layer_cache:
        return (dequantize_kv(layer_cache["k"], layer_cache["k_scale"], dtype),
                dequantize_kv(layer_cache["v"], layer_cache["v_scale"], dtype))
    return layer_cache["k"], layer_cache["v"]


def _store(layer_cache: dict, k_idx, k_val: torch.Tensor, v_idx,
           v_val: torch.Tensor) -> None:
    """Write K vectors ``k_val`` at ``k[k_idx]`` and V vectors ``v_val``
    at ``v[v_idx]`` in place, quantizing on the int8 path (the scale
    planes take the same index without the vector axis), so every later
    read sees exactly what the cache holds."""
    k, v = layer_cache["k"], layer_cache["v"]
    if "k_scale" in layer_cache:
        kq, ksc = quantize_kv(k_val)
        vq, vsc = quantize_kv(v_val)
        k[k_idx] = kq
        layer_cache["k_scale"][k_idx] = ksc
        v[v_idx] = vq
        layer_cache["v_scale"][v_idx] = vsc
    else:
        k[k_idx] = k_val.to(k.dtype)
        v[v_idx] = v_val.to(v.dtype)


def _write_chunk(layer_cache: dict, ks: torch.Tensor, v: torch.Tensor,
                 slot: int) -> None:
    """Write one chunk's K/V — ks (S, B, L, H, d), v (B, L, H, dv) — into
    the ring at ``slot`` (in place)."""
    L = v.shape[1]
    _store(layer_cache, (slice(None),) * 3 + (slice(slot, slot + L),),
           ks.permute(0, 1, 3, 2, 4), (slice(None),) * 2 + (slice(slot, slot + L),),
           v.permute(0, 2, 1, 3))


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
    k_cache, v_cache = _dequant_layer(layer_cache, x.dtype)

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


# ---------------------------------------------------------------------------
# pool-native batched decode: the whole pool advances one token (L=1) or
# one verify block (L rows per slot), every row at its own position
# ---------------------------------------------------------------------------


def _embed_rows(params: dict, tokens: torch.Tensor, pos: torch.Tensor,
                cfg: ModelConfig, rope_len: int):
    """Token (+ learned position) embeddings of rows at per-row
    positions, and the per-row RoPE tables (None for diff). ``tokens``
    and ``pos`` share one shape, (B,) or (B, L)."""
    compute = compute_dtype(cfg)
    idx = pos.to(torch.int64)
    x = params["tok_emb"][tokens].to(compute)
    if cfg.model == "diff":
        return x + params["pos_emb"][idx].to(compute), None, None
    cos_full, sin_full = rope_cos_sin(cfg.head_size,
                                      max(int(rope_len), cfg.block_size),
                                      device=x.device)
    return x, cos_full[idx], sin_full[idx]


def _pool_qkv(x: torch.Tensor, p_attn: dict, cfg: ModelConfig, cos, sin):
    """Per-row projections of x (N, E), RoPE-rotated at each row's own
    position: qs/ks (S, N, H, d), v (N, H, dv)."""
    wq, wk = _stacked_wq(p_attn)
    qs = torch.einsum("be,sehd->sbhd", x, wq.to(x.dtype))
    ks = torch.einsum("be,sehd->sbhd", x, wk.to(x.dtype))
    v = torch.einsum("be,ehd->bhd", x, p_attn["wv"].to(x.dtype))
    if _uses_rope(cfg):
        qs = rope_rows(qs, cos, sin)
        ks = rope_rows(ks, cos, sin)
    return qs, ks, v


def _scales(layer_cache: dict) -> dict:
    return {"k_scale": layer_cache.get("k_scale"),
            "v_scale": layer_cache.get("v_scale")}


def _update_cache_rows(layer_cache: dict, ks: torch.Tensor, v: torch.Tensor,
                       pos: torch.Tensor, M: int,
                       rows: Optional[torch.Tensor] = None) -> None:
    """Write each given row's new K/V — ks (S, B, H, d), v (B, H, dv) —
    into its own ring slot ``pos[b] % M``, in place; ``rows`` (int64
    indices) limits the write to the active rows (all rows when None)."""
    if rows is None:
        rows = torch.arange(v.shape[0], device=v.device)
    slot = torch.remainder(pos.to(torch.int64), M)[rows]
    # advanced indices split by a slice put the row axis first
    _store(layer_cache, (slice(None), rows, slice(None), slot),
           ks[:, rows].permute(1, 0, 2, 3), (rows, slice(None), slot), v[rows])


def _pool_attn(x: torch.Tensor, p_attn: dict, layer_cache: dict,
               pos: torch.Tensor, layer_idx: int, cfg: ModelConfig, cos, sin,
               rows: Optional[torch.Tensor]) -> torch.Tensor:
    """The batched L=1 twin of :func:`_attn_chunk`: x (B, E) normed,
    update-then-attend over every slot row through the decode-attention
    kernel wrapper."""
    B = x.shape[0]
    qs, ks, v = _pool_qkv(x, p_attn, cfg, cos, sin)
    _update_cache_rows(layer_cache, ks, v, pos, cfg.block_size, rows)
    coeffs = common.layer_coeffs(cfg, p_attn, layer_idx)
    out = decode_attention(qs.contiguous(), layer_cache["k"], layer_cache["v"],
                           pos, coeffs, **_scales(layer_cache))
    return _post_attention(out.reshape(B, -1), p_attn, cfg)


def _run_blocks(params: dict, x: torch.Tensor, attn) -> torch.Tensor:
    """The layer stack around a per-layer attention ``attn(normed x,
    p_attn, layer index (0-based), 1-based layer number)``; returns the
    logits."""
    for li, blk in enumerate(params["blocks"], 1):  # 1-based schedule
        a = attn(common.apply_pre_norm(x, blk["ln1"]), blk["attn"], li - 1, li)
        x = common.apply_block_ffn(x, a, blk)
    x = common.apply_pre_norm(x, params["ln_f"])
    return common.linear(x, params["lm_head"])


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
    x, cos, sin = _embed_rows(params, tokens, pos, cfg, rope_len)
    logits = _run_blocks(params, x, lambda h, p, i, li: _pool_attn(
        h, p, cache[i], pos, li, cfg, cos, sin, active))
    return logits, cache


# ---------------------------------------------------------------------------
# the paged cache (serving/pages.py): the batch axis of every leaf indexes
# physical pages of page_size tokens; page 0 is the trash page
# ---------------------------------------------------------------------------


def init_cache_paged(cfg: ModelConfig, num_pages: int, page_size: int,
                     device=None) -> list:
    """Per-layer paged pools: the :func:`init_cache` layout with
    ``(num_pages, page_size)`` in place of ``(batch, block_size)`` on
    each leaf — K (S, P, H, ps, d), V (P, H, ps, dv), plus the scale
    planes on the int8 path. ``num_pages`` includes the trash page 0."""
    if cfg.block_size % page_size:
        raise ValueError(
            f"page_size ({page_size}) must divide block_size "
            f"({cfg.block_size}): the ring mask assumes whole pages"
        )
    return init_cache(cfg.replace(block_size=page_size), num_pages, device)


def gather_slot_cache(cache: list, page_row: torch.Tensor) -> list:
    """A slot's per-layer batch-1 ring view (a copy) through its
    page-table row — what the prefill chunk path runs against."""
    row = page_row.to(torch.int64)
    out = []
    for c in cache:
        layer = {}
        for key, leaf in c.items():
            axis = KV_CACHE_BATCH_AXIS[key]
            g = torch.index_select(leaf, axis, row).movedim(axis, axis + 1)
            layer[key] = g.flatten(axis + 1, axis + 2).unsqueeze(axis)
        out.append(layer)
    return out


def scatter_slot_cache(cache: list, new_row: list,
                       page_row: torch.Tensor) -> list:
    """Write a ring view back through the page table, in place. Trash
    entries of the row collide harmlessly (page 0 is write-only garbage);
    shared prefix pages receive their own unchanged values."""
    row = page_row.to(torch.int64)
    pp = row.shape[0]
    for c, nr in zip(cache, new_row):
        for key, leaf in c.items():
            axis = KV_CACHE_BATCH_AXIS[key]
            r = nr[key].squeeze(axis)
            r = r.unflatten(axis + 1, (pp, r.shape[axis + 1] // pp))
            leaf.index_copy_(axis, row, r.movedim(axis + 1, axis))
    return cache


def copy_cache_pages(cache: list, src: int, dst: int) -> list:
    """Copy physical page ``src`` onto ``dst`` across every layer and
    leaf, in place: the device half of a copy-on-write fork."""
    for c in cache:
        for key, leaf in c.items():
            axis = KV_CACHE_BATCH_AXIS[key]
            leaf.select(axis, int(dst)).copy_(leaf.select(axis, int(src)))
    return cache


def _page_leaves(cache: list, page: int):
    """(layer, key, view of physical page ``page``) of every leaf, widest
    element first: packed back to back in that order, every leaf's byte
    offset is a multiple of its element size."""
    views = [(i, key, leaf.select(KV_CACHE_BATCH_AXIS[key], int(page)))
             for i, c in enumerate(cache) for key, leaf in c.items()]
    return sorted(views, key=lambda e: -e[2].element_size())


def extract_cache_page(cache: list, page: int) -> list:
    """Physical page ``page`` of every layer and leaf as OWNED host
    tensors — K (S, H, ps, d), V (H, ps, dv), and the fp32 ``k_scale`` /
    ``v_scale`` planes on the int8 path: the capture side of the host
    tier's demotion and preemption and of a migration export (the JAX
    engine's ``_page_extract`` and its host copy). The leaves are packed
    on the device into one byte buffer and brought over in ONE copy;
    the result never aliases the pool (a fault that flips a byte of the
    image must not reach the live cache)."""
    views = _page_leaves(cache, page)
    flat = torch.cat([v.contiguous().reshape(-1).view(torch.uint8)
                      for _, _, v in views]).to("cpu")
    out = [dict.fromkeys(c) for c in cache]  # the pool's key order
    off = 0
    for i, key, v in views:
        n = v.numel() * v.element_size()
        out[i][key] = flat[off:off + n].view(v.dtype).reshape(v.shape)
        off += n
    return out


def inject_cache_page(cache: list, page: int, payload: list) -> list:
    """Write one host page image (:func:`extract_cache_page`'s layout)
    into physical page ``page``, in place: the promote / swap-in /
    migration-import transfer (the JAX engine's ``_page_inject``). The
    leaves go over in ONE copy. A leaf whose dtype or shape differs from
    the pool's raises ValueError before anything is written: an image is
    never cast into the cache."""
    views = _page_leaves(cache, page)
    for i, key, v in views:
        src = payload[i][key]
        if src.dtype != v.dtype or tuple(src.shape) != tuple(v.shape):
            raise ValueError(
                f"page image leaf {key!r} of layer {i} is {src.dtype} "
                f"{tuple(src.shape)}; the pool's is {v.dtype} "
                f"{tuple(v.shape)}"
            )
    flat = torch.cat([payload[i][key].contiguous().reshape(-1)
                      .view(torch.uint8) for i, key, _ in views])
    flat = flat.to(views[0][2].device)
    off = 0
    for _, _, v in views:
        n = v.numel() * v.element_size()
        v.copy_(flat[off:off + n].view(v.dtype).reshape(v.shape))
        off += n
    return cache


def _update_pages_rows(layer_cache: dict, ks: torch.Tensor, v: torch.Tensor,
                       pos: torch.Tensor, write_pages: torch.Tensor,
                       M: int) -> None:
    """Write each row's new K/V — ks (S, N, H, d), v (N, H, dv) — into
    physical page ``write_pages[n]`` at offset ``(pos[n] % M) % ps``, in
    place. Inactive rows name the trash page (the paged replacement of
    the contiguous path's active-row write)."""
    ps = layer_cache["v"].shape[-2]
    off = torch.remainder(torch.remainder(pos.to(torch.int64), M), ps)
    wp = write_pages.to(torch.int64)
    _store(layer_cache, (slice(None), wp, slice(None), off),
           ks.permute(1, 0, 2, 3), (wp, slice(None), off), v)


def _pool_attn_paged(x: torch.Tensor, p_attn: dict, layer_cache: dict,
                     pos: torch.Tensor, page_tables: torch.Tensor,
                     write_pages: torch.Tensor, layer_idx: int,
                     cfg: ModelConfig, cos, sin) -> torch.Tensor:
    """The paged twin of :func:`_pool_attn`: write each row's K/V into
    its physical page, then attend through the page table."""
    B = x.shape[0]
    qs, ks, v = _pool_qkv(x, p_attn, cfg, cos, sin)
    _update_pages_rows(layer_cache, ks, v, pos, write_pages, cfg.block_size)
    coeffs = common.layer_coeffs(cfg, p_attn, layer_idx)
    out = decode_attention_paged(qs.contiguous(), layer_cache["k"],
                                 layer_cache["v"], page_tables, pos, coeffs,
                                 **_scales(layer_cache))
    return _post_attention(out.reshape(B, -1), p_attn, cfg)


def forward_decode_pool_paged(params: dict, tokens: torch.Tensor,
                              pos: torch.Tensor, cache: list,
                              page_tables: torch.Tensor,
                              write_pages: torch.Tensor, cfg: ModelConfig,
                              rope_len: int = 0) -> Tuple[torch.Tensor, list]:
    """Advance the whole slot pool by one token THROUGH the page tables:
    ``page_tables`` (B, pages_per_slot) int32, ``write_pages`` (B,) int32
    physical page of each row's write (the trash page for inactive
    rows). Same ring semantics as :func:`forward_decode_pool`."""
    x, cos, sin = _embed_rows(params, tokens, pos, cfg, rope_len)
    logits = _run_blocks(params, x, lambda h, p, i, li: _pool_attn_paged(
        h, p, cache[i], pos, page_tables, write_pages, li, cfg, cos, sin))
    return logits, cache


# ---------------------------------------------------------------------------
# the speculative verify step (serving/spec.py): L = k + 1 rows per slot,
# row 0 the slot's last emitted token, rows 1.. its drafts, each at its
# own position with row-causal visibility (all L rows' K/V are written
# first). Rows past a slot's draft length write to the trash row/page.
# ---------------------------------------------------------------------------


def _update_cache_rows_spec(layer_cache: dict, ks: torch.Tensor,
                            v: torch.Tensor, slot: torch.Tensor,
                            row: torch.Tensor) -> None:
    """Write N flattened verify rows' K/V — ks (S, N, H, d), v (N, H, dv)
    — into cache row ``row[n]`` at ring slot ``slot[n]``, in place
    (collisions inside the trash row are harmless)."""
    row, slot = row.to(torch.int64), slot.to(torch.int64)
    _store(layer_cache, (slice(None), row, slice(None), slot),
           ks.permute(1, 0, 2, 3), (row, slice(None), slot), v)


def _pool_attn_spec(x: torch.Tensor, p_attn: dict, layer_cache: dict,
                    pos: torch.Tensor, targets: torch.Tensor, page_tables,
                    layer_idx: int, cfg: ModelConfig, cos, sin) -> torch.Tensor:
    """The L-row twin of :func:`_pool_attn` / :func:`_pool_attn_paged`:
    x (B, L, E); write all rows' K/V (``targets`` (B, L): cache row, or
    physical page when ``page_tables`` is given), then attend every row
    with row-causal visibility through the multi-row kernel."""
    B, L, E = x.shape
    M = cfg.block_size
    flat = pos.reshape(-1)
    qs_f, ks_f, v_f = _pool_qkv(
        x.reshape(B * L, E), p_attn, cfg,
        None if cos is None else cos.reshape(B * L, -1),
        None if sin is None else sin.reshape(B * L, -1))
    if page_tables is None:
        _update_cache_rows_spec(layer_cache, ks_f, v_f,
                                torch.remainder(flat.to(torch.int64), M),
                                targets.reshape(-1))
    else:
        _update_pages_rows(layer_cache, ks_f, v_f, flat, targets.reshape(-1), M)
    S = qs_f.shape[0]
    qs = qs_f.reshape(S, B, L, cfg.n_head, -1).contiguous()
    coeffs = common.layer_coeffs(cfg, p_attn, layer_idx)
    if page_tables is None:
        out = decode_attention_multi(qs, layer_cache["k"], layer_cache["v"],
                                     pos, coeffs, **_scales(layer_cache))
    else:
        out = decode_attention_multi_paged(qs, layer_cache["k"], layer_cache["v"],
                                           page_tables, pos, coeffs,
                                           **_scales(layer_cache))
    return _post_attention(out.reshape(B, L, -1), p_attn, cfg)


def _forward_spec_batched(params, tokens, pos, cache, targets, page_tables,
                          cfg: ModelConfig, rope_len: int):
    x, cos, sin = _embed_rows(params, tokens, pos, cfg, rope_len)
    logits = _run_blocks(params, x, lambda h, p, i, li: _pool_attn_spec(
        h, p, cache[i], pos, targets, page_tables, li, cfg, cos, sin))
    return logits.to(torch.float32), cache


def forward_decode_spec(params: dict, tokens: torch.Tensor, pos: torch.Tensor,
                        cache: list, cfg: ModelConfig, row_target: torch.Tensor,
                        rope_len: int = 0, batched: bool = False
                        ) -> Tuple[torch.Tensor, list]:
    """Advance the contiguous pool (R >= B rows) by an L-row verify
    block: ``tokens``/``pos`` (B, L), ``row_target`` (B, L) int32 cache
    row of each verify row (B, the trash row, for rows past the slot's
    draft length). Returns ((B, L, V) fp32 logits, cache).

    ``batched=False`` (EXACT): L unrolled :func:`forward_decode_pool`
    steps over all R rows, each writing only its valid rows — every op
    at the L=1 step's shapes, so greedy spec output is bit-identical to
    plain decoding. ``batched=True``: all rows in one pass through
    :func:`decode_attention_multi` and (B*L)-row projections, whose
    larger products may round differently from the L=1 step's."""
    B, L = tokens.shape
    if batched:
        return _forward_spec_batched(params, tokens, pos, cache, row_target,
                                     None, cfg, rope_len)
    R = cache[0]["v"].shape[0]
    dev = tokens.device
    pad = torch.zeros((R - B,), dtype=tokens.dtype, device=dev)
    pad_pos = torch.zeros((R - B,), dtype=pos.dtype, device=dev)
    rows = []
    for l in range(L):
        active = torch.nonzero(row_target[:, l] < B).flatten()
        lg, cache = forward_decode_pool(
            params, torch.cat([tokens[:, l], pad]), torch.cat([pos[:, l], pad_pos]),
            cache, cfg, rope_len=rope_len, active=active)
        rows.append(lg[:B].to(torch.float32))
    return torch.stack(rows, dim=1), cache


def forward_decode_spec_paged(params: dict, tokens: torch.Tensor,
                              pos: torch.Tensor, cache: list,
                              page_tables: torch.Tensor,
                              write_pages: torch.Tensor, cfg: ModelConfig,
                              rope_len: int = 0, batched: bool = False
                              ) -> Tuple[torch.Tensor, list]:
    """Paged twin of :func:`forward_decode_spec`: ``write_pages`` (B, L)
    int32 physical page of each verify row's write (the trash page past
    the draft length). EXACT unrolls L :func:`forward_decode_pool_paged`
    steps; batched runs :func:`decode_attention_multi_paged`."""
    if batched:
        return _forward_spec_batched(params, tokens, pos, cache, write_pages,
                                     page_tables, cfg, rope_len)
    rows = []
    for l in range(tokens.shape[1]):
        # column l of pos is strided; the kernel takes contiguous operands
        lg, cache = forward_decode_pool_paged(
            params, tokens[:, l], pos[:, l].contiguous(), cache, page_tables,
            write_pages[:, l], cfg, rope_len=rope_len)
        rows.append(lg.to(torch.float32))
    return torch.stack(rows, dim=1), cache


# ---------------------------------------------------------------------------
# KV-cached generation: one prefill chunk, then one pool step a token
# ---------------------------------------------------------------------------


@torch.no_grad()
def generate_cached(params: dict, idx: torch.Tensor, cfg: ModelConfig,
                    max_new_tokens: int, seed: int = 0, temperature: float = 1.0,
                    top_k: Optional[int] = None) -> torch.Tensor:
    """KV-cached counterpart of models/generate.py: the same sampling
    contract (``sample_token`` over the last position, the prompt
    included in the return), O(T) a new token instead of a full
    ``block_size`` forward. The prompt is prefilled by
    :func:`forward_chunk`, then every token is one
    :func:`forward_decode_pool` step (all B rows at the same position),
    whose attention is the decode-attention kernel on the card.

    RoPE families (control/ndiff) may generate PAST block_size: the ring
    cache rolls the oldest keys off, so every step attends over the last
    block_size tokens (sliding-window attention). The diff family's
    learned absolute position table cannot roll, so it keeps the
    ``T0 + max_new_tokens <= block_size`` bound and models/generate.py
    for longer runs. Draws come from a generator seeded from ``seed``."""
    from differential_transformer_replication_tpu_torch.models.generate import (
        make_generator,
        sample_token,
    )

    B, T0 = idx.shape
    M = cfg.block_size
    if cfg.model == "diff" and T0 + max_new_tokens > M:
        raise ValueError(
            f"prompt ({T0}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"block_size ({M}) and the diff family's learned absolute "
            "position table cannot roll with a KV cache; use "
            "models.generate for its sliding-window behavior"
        )
    # the reference crops the prompt to the last block_size tokens;
    # rebasing the crop to position 0 is invariant for RoPE and exact for
    # diff (which fits by the guard above)
    idx_cond = idx[:, -M:] if T0 > M else idx
    Tc = idx_cond.shape[1]
    total = Tc + max_new_tokens
    dev = idx.device
    gen = make_generator(seed, dev)
    # weights cast to the compute dtype once, not in every step
    params = common.inference_params(params, compute_dtype(cfg), dev)
    cache = init_cache(cfg, B, device=dev)
    logits, cache = forward_chunk(params, idx_cond.to(torch.int64), 0, cache,
                                  cfg, rope_len=total)
    samples = []
    if max_new_tokens > 0:
        samples.append(sample_token(gen, logits[:, -1, :].to(torch.float32),
                                    temperature, top_k))
    pos = torch.empty((B,), dtype=torch.int32, device=dev)
    for i in range(1, max_new_tokens):
        pos.fill_(Tc + i - 1)
        last, cache = forward_decode_pool(params, samples[-1], pos, cache, cfg,
                                          rope_len=total)
        samples.append(sample_token(gen, last.to(torch.float32), temperature,
                                    top_k))
    if not samples:
        return idx.clone()
    return torch.cat([idx, torch.stack(samples, dim=1).to(idx.dtype)], dim=1)
