"""Shared model plumbing of the port: parameter init, linear, the
block-boundary norm/FFN application, the token-major attention dispatch
and the training tail (final norm + lm head + loss).

The param tree has the JAX package's layout exactly: Linear ``w`` is
``(in, out)`` so application is ``x @ W + b``; LayerNorm params are
``{"w", "b"}`` in fp32. Init follows the reference: every Linear weight
and embedding ~ N(0, 0.02), Linear biases zero, LayerNorm ones/zeros,
lambda vectors zero. Draws come from an explicit ``torch.Generator``
(they cannot reproduce ``jax.random``'s; parity tests hand both sides
the JAX-initialized params through ``params.py``).

Dropout follows the JAX package's sites and order of key splits, with
integer seeds in place of keys (:func:`split_seed`): per layer, then per
block (attention, FFN), then per attention (probabilities, output). A
forward without a seed (eval) drops nothing. On a mesh of ranks each
rank folds its data, fsdp and sequence position into the forward's seed
first (:func:`rank_seed`), and the attention folds the tensor index into
its own (``parallel/shard_flash.py:attention_seed``), as JAX's
``sequence_shard_map`` and ``shard_flash`` fold the mesh position into
the attention key: every rank's attention masks are its own, and the
residual and FFN masks are one per tensor line.

On a tensor line (``group.tensor``, ``parallel/mesh.py``) the params are
this rank's Megatron shard (``parallel/sharding.py:TensorLayout``) and
the forward crosses the region boundaries of ``parallel/regions.py``:
the attention's and the SwiGLU's inputs and the lm head's through
``copy_to_region``; the attention and FFN out-projections and the
vocab-sharded embedding lookups through ``reduce_from_region``, each
row-parallel bias added once after the sum (:func:`row_linear`); the
GroupLayerNorm gathers the head concat and its params, normalizes at
full width and keeps this rank's columns (:func:`apply_group_norm`).

With ``cfg.remat`` each block runs under :func:`remat_block`
(``torch.utils.checkpoint``, the counterpart of JAX's ``jax.checkpoint``):
its activations are recomputed in the backward from its saved inputs,
and its dropout seeds redraw the same masks there.

The block-boundary norms, the SwiGLU chain and the training attention
always go through the kernel wrappers (ops/fused_norm_residual.py,
ops/fused_ffn.py, ops/flash.py), which dispatch by device: GPU kernel
for a CUDA tensor, plain version for a CPU tensor, differentiable either
way. There is no config switch between the two.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from differential_transformer_replication_tpu_torch.ops.dropout import (
    dropout,
    fold_seed,
    generator,
)
from differential_transformer_replication_tpu_torch.ops.flash import (
    dropout_seed_from_generator,
    multi_stream_flash_attention_bh,
    multi_stream_flash_attention_tm,
    multi_stream_flash_attention_tm_packed,
    use_tm,
)
from differential_transformer_replication_tpu_torch.ops.fused_ffn import fused_swiglu
from differential_transformer_replication_tpu_torch.ops.fused_norm_residual import (
    fused_add_norm,
    fused_group_norm,
    fused_norm,
)
from differential_transformer_replication_tpu_torch.ops.lambdas import (
    diff_lambda,
    lambda_init_schedule,
    ndiff_lambdas,
    ndiff_signs,
)
from differential_transformer_replication_tpu_torch.ops.losses import (
    dense_linear_cross_entropy,
    fused_linear_cross_entropy,
)
from differential_transformer_replication_tpu_torch.ops.rope import apply_rope
from differential_transformer_replication_tpu_torch.ops.streams import (
    diff_coeffs,
    ndiff_coeffs,
    vanilla_coeffs,
)
from differential_transformer_replication_tpu_torch.parallel.regions import (
    copy_to_region,
    gather_columns,
    live,
    own_columns,
    reduce_from_region,
)
from differential_transformer_replication_tpu_torch.parallel.ring import (
    ring_flash_body,
    use_ring,
)
from differential_transformer_replication_tpu_torch.parallel.shard_flash import (
    attention_seed,
)
from differential_transformer_replication_tpu_torch.parallel.ulysses import (
    ulysses_flash_body,
)

INIT_STD = 0.02
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the param-tree keys whose leaves stay fp32 at inference: LayerNorm
# params feed the fused norm's fp32 affine, lambda vectors the fp32
# combine coefficients
_FP32_SUBTREES = ("ln1", "ln2", "ln_f", "gn", "lambda_q", "lambda_k")


def compute_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def normal_init(gen: torch.Generator, shape, std: float = INIT_STD) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * std


def linear_params(gen: torch.Generator, in_dim: int, out_dim: int,
                  bias: bool = True) -> dict:
    p = {"w": normal_init(gen, (in_dim, out_dim))}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=torch.float32, device=gen.device)
    return p


def layer_norm_params(dim: int, device=None) -> dict:
    return {"w": torch.ones((dim,), dtype=torch.float32, device=device),
            "b": torch.zeros((dim,), dtype=torch.float32, device=device)}


def ffn_params(gen: torch.Generator, n_embd: int) -> dict:
    """SwiGLU(n_embd -> 4*n_embd) then Linear(4*n_embd -> n_embd), all
    with biases."""
    return {
        "gate": linear_params(gen, n_embd, 4 * n_embd),
        "xform": linear_params(gen, n_embd, 4 * n_embd),
        "out": linear_params(gen, 4 * n_embd, n_embd),
    }


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def tensor_line(group):
    """The forward's tensor line (None off a tensor mesh)."""
    return None if group is None else group.tensor


def row_linear(x: torch.Tensor, p: dict, tp) -> torch.Tensor:
    """A row-parallel Linear: this rank's rows of ``w`` against its
    columns of ``x``, the partial products summed over the tensor line,
    then the (replicated) bias once; :func:`linear` off a tensor line."""
    y = reduce_from_region(x @ p["w"].to(x.dtype), tp)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embed_rows(table: torch.Tensor, ids: torch.Tensor, tp) -> torch.Tensor:
    """``table[ids]`` (fp32, not yet summed) where ``table`` is this
    rank's block of rows of a row-sharded table: the ids it holds, zeros
    for the others; the caller reduces the sum from the region."""
    if not live(tp):
        return F.embedding(ids, table)
    n = table.shape[0]
    local = ids - tp.index * n
    held = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), table)
    return rows * held[..., None].to(rows.dtype)


def apply_pre_norm(x: torch.Tensor, p: dict) -> torch.Tensor:
    """A LayerNorm with no residual input: the block's ln1 and ln_f."""
    return fused_norm(x.contiguous(), p["w"], p["b"])


def apply_group_norm(x: torch.Tensor, p: dict, tp=None) -> torch.Tensor:
    """The full-width GroupLayerNorm over the head concat (diff/ndiff).
    On a tensor line its statistics span every rank's heads (JAX's
    partitioner reduces them): the ranks' head outputs and ``gn`` params
    are gathered, the norm kernel runs at full width, and this rank's
    columns are kept; each gather's backward reduce-scatters."""
    if not live(tp):
        return fused_group_norm(x.contiguous(), p["w"], p["b"])
    wb = gather_columns(torch.stack([p["w"], p["b"]]), tp)
    full = fused_group_norm(gather_columns(x, tp), wb[0], wb[1])
    return own_columns(full, tp)


def split_seed(seed, n: int) -> tuple:
    """Split an optional dropout seed into n optional seeds (the
    counterpart of the JAX ``split_rng``)."""
    if seed is None:
        return (None,) * n
    return tuple(fold_seed(seed, i) for i in range(n))


def rank_seed(seed, group):
    """The forward's dropout seed on this rank: ``seed`` with this rank's
    mesh position over data, fsdp and sequence folded in on a mesh of
    more than one rank (``Mesh.replicated_position``, data major), with
    the ring rank on a ring alone, else ``seed``. The fold comes first,
    so every seed the forward derives (attention, and residual and FFN
    dropout, which JAX's GSPMD path draws from one global mask sharded
    over the batch) is this batch and sequence shard's own. The tensor
    index is left out: the residual and FFN masks fall on activations
    every rank of a tensor line holds in full, and must be the same
    there; the attention, on the rank's own heads, folds it in
    (``parallel/shard_flash.py:attention_seed``)."""
    if seed is None or group is None:
        return seed
    if group.position is not None:
        return fold_seed(seed, group.position)
    return fold_seed(seed, group.rank) if use_ring(group) else seed


def shard_start(T: int, group) -> int:
    """The global position of this rank's first token: rank r of the ring
    holds positions r*T .. (r+1)*T - 1 of every sequence; 0 without one."""
    return group.rank * T if use_ring(group) else 0


def apply_dropout(x: torch.Tensor, rate: float, seed) -> torch.Tensor:
    """Residual/FFN-output dropout with a generator on x's device made
    from ``seed`` (identity without one)."""
    if rate <= 0.0 or seed is None:
        return x
    return dropout(x, rate, generator(seed, x.device))


def apply_block_ffn(x: torch.Tensor, attn_out: torch.Tensor, blk: dict,
                    rate: float = 0.0, seed=None, tp=None) -> torch.Tensor:
    """The block's FFN half: attention residual add + ln2 (one fused
    pass producing the carried residual and the normalized FFN input),
    the fused SwiGLU chain, the down projection, its dropout and the FFN
    residual. On a tensor line ``tp`` the SwiGLU is column-parallel (this
    rank's F / tp columns) and the down projection row-parallel."""
    p = blk["ffn"]
    x, normed = fused_add_norm(x.contiguous(), attn_out.contiguous(),
                               blk["ln2"]["w"], blk["ln2"]["b"])
    h = fused_swiglu(copy_to_region(normed, tp), p["gate"]["w"], p["gate"]["b"],
                     p["xform"]["w"], p["xform"]["b"])
    return x + apply_dropout(row_linear(h, p["out"], tp), rate, seed)


# The products a ``dots`` policy saves (JAX ``dots_saveable``) and those
# of them with no batch dimension (``dots_with_no_batch_dims_saveable``).
_DOTS = {"dots": ("mm", "addmm", "bmm", "baddbmm"),
         "dots_no_batch": ("mm", "addmm")}


def remat_block(block_fn, cfg):
    """``block_fn`` (a family's ``block_forward``) recomputed in the
    backward under ``cfg.remat_policy`` (JAX ``models/common.py:
    remat_block``): ``none`` and ``nothing`` save the block's inputs only;
    ``dots`` also the outputs of the aten products (``mm``, ``addmm``,
    ``bmm``, ``baddbmm``), ``dots_no_batch`` of those with no batch
    dimension (``mm``, ``addmm``), through a selective-checkpoint policy;
    ``everything`` saves all, so the block runs as it is and nothing is
    recomputed.

    The checkpoint is the non-reentrant one: the block's params arrive in
    a dict, and its autograd Functions keep their residuals through
    ``save_for_backward``, which it frees. The hand-written kernels are
    launched through ctypes, opaque to a policy as a ``pallas_call`` is
    to JAX's: on the card ``dots`` saves the projections' products and
    recomputes the kernels. On the CPU the plain versions' products
    inside those Functions are visible to it too, so what is saved there
    differs from the card, but not the math. Every dropout mask of a
    block comes from a generator made from the block's integer seed, and
    nothing draws from the global RNG, so the recompute redraws the same
    masks without a stash of the RNG state. Without grad (eval,
    generation) the block runs as it is."""
    policy = cfg.remat_policy
    if policy == "everything":
        return block_fn
    context_fn = noop_context_fn
    if policy in _DOTS:
        ops = [getattr(torch.ops.aten, name).default for name in _DOTS[policy]]
        context_fn = functools.partial(create_selective_checkpoint_contexts, ops)

    def run(*args):
        if not torch.is_grad_enabled():
            return block_fn(*args)
        return checkpoint(block_fn, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=context_fn)

    return run


def layer_coeffs(cfg, p_attn: dict, layer_idx: int) -> torch.Tensor:
    """(S, H) fp32 stream-combine coefficients of one layer (1-based
    ``layer_idx``): [1] for control, [1, -lambda] for diff, sign *
    lambda for ndiff; differentiable in the lambda vectors."""
    if cfg.model == "control":  # this rank's heads on a tensor line
        return vanilla_coeffs(p_attn["wq"].shape[-2], device=p_attn["wq"].device)
    lq = p_attn["lambda_q"].to(torch.float32)
    lk = p_attn["lambda_k"].to(torch.float32)
    if cfg.model == "diff":
        lam = diff_lambda(lq[0], lk[0], lq[1], lk[1],
                          lambda_init_schedule(layer_idx))
        return diff_coeffs(lam).contiguous()
    lams = ndiff_lambdas(lq, lk, lambda_init_schedule(layer_idx))
    return ndiff_coeffs(lams, ndiff_signs(cfg.n_terms, device=lq.device)).contiguous()


def flash_attention(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                    wv: torch.Tensor, coeffs: torch.Tensor, cos=None,
                    sin=None, rate: float = 0.0, seed=None,
                    group=None, seq_impl: str = "ring") -> torch.Tensor:
    """The training attention of all three families (the JAX
    ``flash_bh_fn``): x (B, T, E) normed block input, wq/wk (S, E, H, d),
    wv (E, H, dv), coeffs (S, H) fp32, attention-dropout ``rate`` with an
    optional ``seed``; returns (B, T, H, dv).

    As in JAX the rate counts only with a seed (``rate_live``). Inside
    the token-major envelope (no live dropout, T <= 512, S <= 4): without
    RoPE (diff) the PACKED route, one projection matmul ``x @
    [Wq_0..|Wk_0..|Wv]`` whose column windows the kernel reads; with RoPE
    (control, ndiff) each projection is its own matmul, rotated (headed
    layout), on the per-array route. Everything else takes the HEAD-MAJOR
    route: the same one projection matmul, its q/k/v windows laid out as
    (B*H, S, T, width), rotated there (RoPE tables broadcast over B*H),
    and the head-major kernels with in-kernel attention dropout whose
    seed words come from a CPU generator seeded with ``seed``.

    With a sequence ``group`` of more than one rank (JAX
    ``dispatch_attention`` branch 1), x is this rank's T-shard and the
    same head-major operands (RoPE tables at the shard's global
    positions) go around the ring (``parallel/ring.py``), or, with
    ``seq_impl="ulysses"`` (``ModelConfig.sequence_impl``), through the
    two all-to-alls of ``parallel/ulysses.py``; ``seed`` is then already
    this rank's (:func:`rank_seed`).

    On a tensor line (``group.tensor``) wq/wk/wv and coeffs are this
    rank's heads, H the local count, and every route runs on them; x
    enters the column-parallel projections through ``copy_to_region``
    and the seed takes the tensor index (``attention_seed``)."""
    x = copy_to_region(x, tensor_line(group))
    seed = attention_seed(seed, group)
    B, T, E = x.shape
    S, _, H, d = wq.shape
    dv = wv.shape[-1]
    rate_live = rate if seed is not None else 0.0
    if not use_ring(group) and use_tm(S, T, rate_live):
        if cos is None:
            wcat = torch.cat([wq[s].reshape(E, H * d) for s in range(S)]
                             + [wk[s].reshape(E, H * d) for s in range(S)]
                             + [wv.reshape(E, H * dv)], dim=1).to(x.dtype)
            return multi_stream_flash_attention_tm_packed(x @ wcat, coeffs, B,
                                                          H, S, d, dv)
        wq_c, wk_c = wq.to(x.dtype), wk.to(x.dtype)
        qs = [apply_rope((x @ wq_c[s].reshape(E, H * d)).reshape(B, T, H, d),
                         cos, sin, headed=True) for s in range(S)]
        ks = [apply_rope((x @ wk_c[s].reshape(E, H * d)).reshape(B, T, H, d),
                         cos, sin, headed=True) for s in range(S)]
        v = (x @ wv.to(x.dtype).reshape(E, H * dv)).reshape(B, T, H, dv)
        return multi_stream_flash_attention_tm(qs, ks, v, coeffs, B, H)
    wcat = torch.cat([wq.permute(1, 0, 2, 3).reshape(E, S * H * d),
                      wk.permute(1, 0, 2, 3).reshape(E, S * H * d),
                      wv.reshape(E, H * dv)], dim=1).to(x.dtype)
    proj = x @ wcat
    SHd = S * H * d

    def heads(cols):  # (B, T, S, H, d) -> (B*H, S, T, d)
        return cols.reshape(B, T, S, H, d).permute(0, 3, 2, 1, 4).reshape(
            B * H, S, T, d)

    q_r, k_r = heads(proj[..., :SHd]), heads(proj[..., SHd:2 * SHd])
    v_r = proj[..., 2 * SHd:].reshape(B, T, H, dv).transpose(1, 2).reshape(
        B * H, T, dv)
    if cos is not None:
        q_r = apply_rope(q_r, cos, sin, headed=False)
        k_r = apply_rope(k_r, cos, sin, headed=False)
    gen = generator(seed, "cpu") if rate_live > 0.0 else None
    if use_ring(group):
        words = dropout_seed_from_generator(gen) if gen is not None else None
        body = ulysses_flash_body if seq_impl == "ulysses" else ring_flash_body
        out = body(q_r, k_r, v_r, coeffs, group, words, rate_live)
    else:
        out = multi_stream_flash_attention_bh(q_r, k_r, v_r, coeffs, B, H,
                                              dropout_rate=rate_live,
                                              dropout_gen=gen)
    return out.reshape(B, H, T, dv).transpose(1, 2)


def apply_tail(x: torch.Tensor, params: dict, tp=None) -> torch.Tensor:
    """Final LayerNorm + untied lm head; on a tensor line the logits of
    this rank's vocab shard."""
    return linear(copy_to_region(apply_pre_norm(x, params["ln_f"]), tp),
                  params["lm_head"])


def tail_and_loss(x: torch.Tensor, params: dict, cfg, targets=None,
                  group=None):
    """The end of every family's forward: ``(logits, loss)``. With
    targets, the final norm feeds :func:`ops.losses.dense_linear_cross_
    entropy` and the logits returned are its own (no gradient path), or,
    with ``cfg.loss_chunk``, :func:`ops.losses.fused_linear_cross_entropy`
    in chunks of that many positions, and the logits returned are None,
    as in JAX; without targets, ``(apply_tail(x), None)``. On the ring the
    loss is this rank's share of the mean over all ranks' tokens (its sum
    over the global B*T), so the ranks' losses sum to the global mean.
    On a tensor line the lm head is vocab-parallel: the loss is the
    global one on every rank of the line (``ops/losses.py``), and the
    logits returned (with targets or without) are this rank's vocab
    shard, (B, T, V / tp); nothing gathers them."""
    tp = tensor_line(group)
    if targets is None:
        return apply_tail(x, params, tp), None
    x_ln = copy_to_region(apply_pre_norm(x, params["ln_f"]), tp)
    p = params["lm_head"]
    n_total = targets.numel() * group.size if use_ring(group) else None
    if cfg.loss_chunk:
        return None, fused_linear_cross_entropy(x_ln, p["w"], p.get("b"),
                                                targets, cfg.loss_chunk,
                                                n_total, tp)
    loss, logits = dense_linear_cross_entropy(x_ln, p["w"], p.get("b"),
                                              targets, n_total, tp)
    return logits, loss


def inference_params(params: dict, compute_dtype: torch.dtype,
                     device) -> dict:
    """The param tree on ``device`` with every matmul weight, bias and
    embedding cast to ``compute_dtype`` ONCE, and the LayerNorm and
    lambda leaves kept fp32. Every consumer casts those leaves to the
    activation dtype anyway (``linear``, the SwiGLU wrapper, the
    embedding gathers), so casting ahead is bit-identical and spares the
    per-step casts."""

    def walk(node, keep_fp32):
        if isinstance(node, dict):
            return {k: walk(v, keep_fp32 or k in _FP32_SUBTREES)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, keep_fp32) for v in node]
        dt = torch.float32 if keep_fp32 else compute_dtype
        return node.to(device=device, dtype=dt).contiguous()

    return walk(params, False)
