"""The lm-head + mean cross-entropy with a hand-written backward (plain
PyTorch; not a TPU kernel).

Counterpart of ``differential_transformer_replication_tpu/ops/losses.py:
dense_linear_cross_entropy`` with its cast points kept:

- forward: logits = h @ W + b in h's dtype; the fp32 logsumexp minus
  the target logit (gathered from the stored logits, then widened);
- backward: ``d = (softmax - onehot) * g / n`` cast to h's dtype;
  ``dW = h^T d`` with an fp32 RESULT from upcast operands (not a matmul
  in h's dtype rounded afterwards); ``dh = d W^T`` in h's dtype;
  ``db = (colsum(p) - counts) * g / n``.

The chunked ``fused_linear_cross_entropy`` (``ModelConfig.loss_chunk``)
is a later slice of the port.
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
