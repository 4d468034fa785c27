"""The lm-head + mean cross-entropy with hand-written backwards, dense
and chunked (plain PyTorch; neither is a TPU kernel).

Counterpart of ``differential_transformer_replication_tpu/ops/losses.py:
dense_linear_cross_entropy`` with its cast points kept:

- forward: logits = h @ W + b in h's dtype; the fp32 logsumexp minus
  the target logit (gathered from the stored logits, then widened);
- backward: ``d = (softmax - onehot) * g / n`` cast to h's dtype;
  ``dW = h^T d`` with an fp32 RESULT from upcast operands (not a matmul
  in h's dtype rounded afterwards); ``dh = d W^T`` in h's dtype;
  ``db = (colsum(p) - counts) * g / n``.

Counterpart of ``fused_linear_cross_entropy`` there too
(``ModelConfig.loss_chunk``), which never holds more than one chunk of
logits:

- forward: per chunk of positions, the product in h's dtype, an fp32
  upcast, ``log_softmax`` and the target gather; the chunks' sums make
  the mean (JAX pads and masks the shorter tail chunk, which adds zeros;
  here the tail chunk is shorter);
- backward: each chunk's logits recomputed, ``d = (softmax - onehot) *
  g / n`` cast to h's dtype; ``dh = d W^T`` and ``dW = h^T d`` as
  products in h's dtype, dW upcast and summed over the chunks in fp32
  (not the dense path's fp32-result product), ``db`` the fp32 sum of
  the fp32 ``d``.

Both take a ``tensor`` line (``parallel/mesh.py:Line``) on which the lm
head is vocab-parallel (Megatron): ``w`` is this rank's (E, V / tp)
columns and ``b`` its (V / tp,) block, vocab ids ``index * V / tp`` on.
Each rank makes its local logits only; per row its local logsumexp and
the target's logit (zero where another rank holds the target) go to
every rank of the line in one all-gather of (N, 2) fp32, and the global
logsumexp and target logit follow on each rank alike, so every rank
holds the same loss. The backward is the local ``softmax - onehot``
over the local vocab (the global logsumexp saved); ``dh`` is then this
rank's partial sum, which the caller's ``copy_to_region`` sums over the
line. Nothing gathers an (N, V) tensor: the dense path's logits are the
rank's vocab shard.
"""

from __future__ import annotations

from typing import Optional

import torch

from differential_transformer_replication_tpu_torch.parallel.mesh import all_gather_
from differential_transformer_replication_tpu_torch.parallel.regions import live


def _vocab_lo(w: torch.Tensor, tp) -> int:
    """The first vocab id of this rank's columns (0 off a tensor line)."""
    return tp.index * w.shape[-1] if live(tp) else 0


def _global_stats(lse: torch.Tensor, tgt: torch.Tensor, tp):
    """The logsumexp and target logit over the whole vocab from every
    rank's local ones (fp32, any shape; one all-gather)."""
    mine = torch.stack([lse.reshape(-1), tgt.reshape(-1)], -1)
    got = torch.empty(tp.size * mine.numel(), dtype=mine.dtype, device=mine.device)
    got = all_gather_(got, mine, tp).view(tp.size, -1, 2)
    return (torch.logsumexp(got[..., 0], 0).view(lse.shape),
            got[..., 1].sum(0).view(tgt.shape))


def _local_targets(targets: torch.Tensor, lo: int, V: int):
    """(targets as local column ids clamped into range, whether this rank
    holds each target)."""
    local = targets - lo
    held = (local >= 0) & (local < V)
    return local.clamp(0, V - 1), held


class _DenseLinearCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, b, targets, n_total, tp):
        logits = h @ w.to(h.dtype)
        if b is not None:
            logits = logits + b.to(h.dtype)
        V = logits.shape[-1]
        local, held = _local_targets(targets, _vocab_lo(w, tp), V)
        lse = torch.logsumexp(logits.to(torch.float32), dim=-1)
        tgt = torch.gather(logits, -1, local[..., None])[..., 0].to(torch.float32)
        if live(tp):
            lse, tgt = _global_stats(lse, tgt * held, tp)
        nll = lse - tgt
        loss = torch.mean(nll) if n_total is None else torch.sum(nll) / n_total
        ctx.save_for_backward(h, w, logits, lse, local, held)
        ctx.n_total = n_total
        ctx.b_dtype = None if b is None else b.dtype
        ctx.mark_non_differentiable(logits)
        return loss, logits

    @staticmethod
    def backward(ctx, g, _g_logits):
        h, w, logits, lse, local, held = ctx.saved_tensors
        V = logits.shape[-1]
        n = ctx.n_total or logits.numel() // V
        p = torch.exp(logits.to(torch.float32) - lse[..., None]).reshape(-1, V)
        t, keep = local.reshape(-1), held.reshape(-1)
        scale = g / n
        d32 = p.clone()
        d32[torch.arange(t.shape[0], device=t.device), t] -= keep.to(torch.float32)
        d = (d32 * scale).to(h.dtype)
        h2 = h.reshape(-1, h.shape[-1])
        dw = (h2.to(torch.float32).t() @ d.to(torch.float32)).to(w.dtype)
        dh = (d @ w.to(h.dtype).t()).reshape(h.shape)
        db = None
        if ctx.b_dtype is not None:
            counts = torch.zeros(V, dtype=torch.float32, device=t.device)
            counts.index_add_(0, t, keep.to(torch.float32))
            db = ((p.sum(0) - counts) * scale).to(ctx.b_dtype)
        return dh, dw, db, None, None, None


def dense_linear_cross_entropy(h: torch.Tensor, w: torch.Tensor,
                               b: Optional[torch.Tensor],
                               targets: torch.Tensor,
                               n_total: Optional[int] = None, tensor=None):
    """``(loss, logits)``: the mean cross-entropy of ``h @ w + b`` against
    ``targets`` (int64), differentiable in ``h``, ``w`` and ``b``; the
    logits are the loss's own forward logits, returned without a
    gradient path (a train step uses the loss only). ``n_total`` divides
    the sum instead of the local token count (a shard's share of a mean
    over ``n_total`` tokens). On a ``tensor`` line, vocab-parallel
    (module docstring): the logits are this rank's vocab shard."""
    return _DenseLinearCE.apply(h, w, b, targets, n_total, tensor)


def _chunk_logits(hc, wc, bc):
    """One chunk's fp32 logits: the product (and bias) in h's dtype,
    then the upcast."""
    logits = hc @ wc
    if bc is not None:
        logits = logits + bc
    return logits.to(torch.float32)


class _ChunkedLinearCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, b, targets, chunk, n_total, tp):
        h2, t1 = h.reshape(-1, h.shape[-1]), targets.reshape(-1)
        wc = w.to(h.dtype)
        bc = None if b is None else b.to(h.dtype)
        ctx.chunk = chunk
        ctx.n = n_total or h2.shape[0]
        ctx.tp = tp
        if live(tp):
            # per chunk the local logsumexp and target logit; one exchange
            local, held = _local_targets(t1, _vocab_lo(w, tp), w.shape[-1])
            lse, tgt = [], []
            for s in range(0, h2.shape[0], chunk):
                logits = _chunk_logits(h2[s:s + chunk], wc, bc)
                lse.append(torch.logsumexp(logits, -1))
                tgt.append(torch.gather(logits, -1, local[s:s + chunk, None])[:, 0])
            lse, tgt = _global_stats(torch.cat(lse), torch.cat(tgt) * held, tp)
            ctx.save_for_backward(h, w, b, local, held, lse)
            return (lse - tgt).sum() / ctx.n
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for s in range(0, h2.shape[0], chunk):
            logp = torch.log_softmax(_chunk_logits(h2[s:s + chunk], wc, bc), -1)
            total = total + torch.gather(logp, -1, t1[s:s + chunk, None]).sum()
        ctx.save_for_backward(h, w, b, t1, None, None)
        return -total / ctx.n

    @staticmethod
    def backward(ctx, g):
        h, w, b, t1, held, lse = ctx.saved_tensors
        h2 = h.reshape(-1, h.shape[-1])
        wc = w.to(h.dtype)
        bc = None if b is None else b.to(h.dtype)
        scale = g.to(torch.float32) / ctx.n
        dh = torch.empty_like(h2)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = torch.zeros(w.shape[1:], dtype=torch.float32, device=w.device)
        for s in range(0, h2.shape[0], ctx.chunk):
            hc, tc = h2[s:s + ctx.chunk], t1[s:s + ctx.chunk]
            rows = torch.arange(tc.shape[0], device=tc.device)
            if lse is None:
                d32 = torch.softmax(_chunk_logits(hc, wc, bc), -1)
                d32[rows, tc] -= 1.0
            else:  # the softmax over the whole vocab, on this rank's columns
                d32 = torch.exp(_chunk_logits(hc, wc, bc) - lse[s:s + ctx.chunk, None])
                d32[rows, tc] -= held[s:s + ctx.chunk].to(torch.float32)
            d32 *= scale
            d = d32.to(h.dtype)
            dh[s:s + ctx.chunk] = d @ wc.t()
            dw += (hc.t() @ d).to(torch.float32)
            db += d32.sum(0)
        return (dh.reshape(h.shape), dw.to(w.dtype),
                None if b is None else db.to(b.dtype), None, None, None, None)


def fused_linear_cross_entropy(h: torch.Tensor, w: torch.Tensor,
                               b: Optional[torch.Tensor],
                               targets: torch.Tensor, chunk: int,
                               n_total: Optional[int] = None,
                               tensor=None) -> torch.Tensor:
    """The mean cross-entropy of ``h @ w + b`` against ``targets``
    (int64), ``chunk`` positions of logits at a time, differentiable in
    ``h``, ``w`` and ``b``; no logits are returned. ``n_total`` divides
    the sum instead of the local token count, and ``tensor`` makes it
    vocab-parallel, as in :func:`dense_linear_cross_entropy`."""
    return _ChunkedLinearCE.apply(h, w, b, targets, int(chunk), n_total, tensor)
