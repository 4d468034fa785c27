"""The single-device attention kernels on a tensor rank's heads.

Counterpart of ``differential_transformer_replication_tpu/parallel/
shard_flash.py``. GSPMD cannot partition a bare ``pallas_call``, so JAX
wraps its kernel in a ``shard_map`` whose specs put the batch on
``data``/``fsdp`` and the heads on ``tensor``: each device runs the
ordinary kernel on its (batch, head) slice with no collective inside.
In the port a rank already holds only its slice: its batch rows
(``parallel/sharding.py:shard_batch``) and its heads' q/k/v columns and
lambdas (``TensorLayout``), so the training attention
(``models/common.py:flash_attention``) runs the port's kernels (the
token-major D/E, the head-major K1-K4, the ring's chunk kernels, Ulysses)
on those local shapes as it stands. What is left here is what the JAX
wrapper adds around the kernel:

- the dropout fold: the kernels key their masks on the LOCAL
  ``b * H + h`` grid index, which repeats across shards, so JAX folds
  the device's mesh position ``(data * fsdp + fsdp_idx) * tensor +
  tensor_idx`` into the attention's key. The port folds the data, fsdp
  and sequence position into the forward's seed (``models/common.py:
  rank_seed``: the activations every tensor rank holds in full draw one
  mask) and :func:`attention_seed` folds the tensor index into the
  attention's own, so each (batch, head) shard draws its own masks;
- :func:`shard_flash_multi_stream_attention`: the rank's slice in JAX's
  layout through the head-major kernels, given the seed words of its
  mesh position (those JAX derives with ``fold_in(key, position)``), for
  holding a rank's masks against JAX's.
"""

from __future__ import annotations

import torch

from differential_transformer_replication_tpu_torch.ops.dropout import fold_seed
from differential_transformer_replication_tpu_torch.ops.flash import flash_bh


def attention_seed(seed, group):
    """The attention's dropout seed on this rank: ``seed`` with the index
    of the rank's tensor line folded in where that line has more than one
    rank (``group``: the forward's ``SequenceGroup`` or None)."""
    tp = None if group is None else group.tensor
    if seed is None or tp is None or tp.size == 1:
        return seed
    return fold_seed(seed, tp.index)


def shard_flash_multi_stream_attention(qs: torch.Tensor, ks: torch.Tensor,
                                       v: torch.Tensor, coeffs: torch.Tensor, *,
                                       dropout_rate: float = 0.0,
                                       dropout_seed=None) -> torch.Tensor:
    """Multi-stream attention on this rank's (batch, head) slice: qs/ks
    (S, Bl, T, Hl, d), v (Bl, T, Hl, dv), coeffs (S, Hl) fp32 (the rank's
    heads' columns); returns (Bl, T, Hl, dv). ``dropout_seed`` is the
    (1, 2) seed words of the rank's mesh position (None: no dropout)."""
    S, B, T, H, d = qs.shape
    dv = v.shape[-1]
    q_r = qs.permute(1, 3, 0, 2, 4).reshape(B * H, S, T, d)
    k_r = ks.permute(1, 3, 0, 2, 4).reshape(B * H, S, T, d)
    v_r = v.permute(0, 2, 1, 3).reshape(B * H, T, dv)
    rate = dropout_rate if dropout_seed is not None else 0.0
    out = flash_bh(q_r, k_r, v_r, coeffs, dropout_seed, H, rate)
    return out.reshape(B, H, T, dv).transpose(1, 2)
