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
"""

from __future__ import annotations

from typing import Optional

import torch


class _DenseLinearCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, b, targets, n_total):
        logits = h @ w.to(h.dtype)
        if b is not None:
            logits = logits + b.to(h.dtype)
        lse = torch.logsumexp(logits.to(torch.float32), dim=-1)
        tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
        nll = lse - tgt.to(torch.float32)
        loss = torch.mean(nll) if n_total is None else torch.sum(nll) / n_total
        ctx.save_for_backward(h, w, logits, lse, targets)
        ctx.n_total = n_total
        ctx.b_dtype = None if b is None else b.dtype
        ctx.mark_non_differentiable(logits)
        return loss, logits

    @staticmethod
    def backward(ctx, g, _g_logits):
        h, w, logits, lse, targets = ctx.saved_tensors
        V = logits.shape[-1]
        n = ctx.n_total or logits.numel() // V
        p = torch.exp(logits.to(torch.float32) - lse[..., None]).reshape(-1, V)
        t = targets.reshape(-1)
        scale = g / n
        d32 = p.clone()
        d32[torch.arange(t.shape[0], device=t.device), t] -= 1.0
        d = (d32 * scale).to(h.dtype)
        h2 = h.reshape(-1, h.shape[-1])
        dw = (h2.to(torch.float32).t() @ d.to(torch.float32)).to(w.dtype)
        dh = (d @ w.to(h.dtype).t()).reshape(h.shape)
        db = None
        if ctx.b_dtype is not None:
            counts = torch.zeros(V, dtype=torch.float32, device=t.device)
            counts.index_add_(0, t, torch.ones_like(t, dtype=torch.float32))
            db = ((p.sum(0) - counts) * scale).to(ctx.b_dtype)
        return dh, dw, db, None, None


def dense_linear_cross_entropy(h: torch.Tensor, w: torch.Tensor,
                               b: Optional[torch.Tensor],
                               targets: torch.Tensor,
                               n_total: Optional[int] = None):
    """``(loss, logits)``: the mean cross-entropy of ``h @ w + b`` against
    ``targets`` (int64), differentiable in ``h``, ``w`` and ``b``; the
    logits are the loss's own forward logits, returned without a
    gradient path (a train step uses the loss only). ``n_total`` divides
    the sum instead of the local token count (a shard's share of a mean
    over ``n_total`` tokens)."""
    return _DenseLinearCE.apply(h, w, b, targets, n_total)


def _chunk_logits(hc, wc, bc):
    """One chunk's fp32 logits: the product (and bias) in h's dtype,
    then the upcast."""
    logits = hc @ wc
    if bc is not None:
        logits = logits + bc
    return logits.to(torch.float32)


class _ChunkedLinearCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, b, targets, chunk, n_total):
        h2, t1 = h.reshape(-1, h.shape[-1]), targets.reshape(-1)
        wc = w.to(h.dtype)
        bc = None if b is None else b.to(h.dtype)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for s in range(0, h2.shape[0], chunk):
            logp = torch.log_softmax(_chunk_logits(h2[s:s + chunk], wc, bc), -1)
            total = total + torch.gather(logp, -1, t1[s:s + chunk, None]).sum()
        ctx.save_for_backward(h, w, b, targets)
        ctx.chunk = chunk
        ctx.n = n_total or h2.shape[0]
        return -total / ctx.n

    @staticmethod
    def backward(ctx, g):
        h, w, b, targets = ctx.saved_tensors
        h2, t1 = h.reshape(-1, h.shape[-1]), targets.reshape(-1)
        wc = w.to(h.dtype)
        bc = None if b is None else b.to(h.dtype)
        scale = g.to(torch.float32) / ctx.n
        dh = torch.empty_like(h2)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = torch.zeros(w.shape[1:], dtype=torch.float32, device=w.device)
        for s in range(0, h2.shape[0], ctx.chunk):
            hc, tc = h2[s:s + ctx.chunk], t1[s:s + ctx.chunk]
            d32 = torch.softmax(_chunk_logits(hc, wc, bc), -1)
            d32[torch.arange(tc.shape[0], device=tc.device), tc] -= 1.0
            d32 *= scale
            d = d32.to(h.dtype)
            dh[s:s + ctx.chunk] = d @ wc.t()
            dw += (hc.t() @ d).to(torch.float32)
            db += d32.sum(0)
        return (dh.reshape(h.shape), dw.to(w.dtype),
                None if b is None else db.to(b.dtype), None, None, None)


def fused_linear_cross_entropy(h: torch.Tensor, w: torch.Tensor,
                               b: Optional[torch.Tensor],
                               targets: torch.Tensor, chunk: int,
                               n_total: Optional[int] = None) -> torch.Tensor:
    """The mean cross-entropy of ``h @ w + b`` against ``targets``
    (int64), ``chunk`` positions of logits at a time, differentiable in
    ``h``, ``w`` and ``b``; no logits are returned. ``n_total`` divides
    the sum instead of the local token count, as in
    :func:`dense_linear_cross_entropy`."""
    return _ChunkedLinearCE.apply(h, w, b, targets, int(chunk), n_total)
