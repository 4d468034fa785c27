"""All-to-all (Ulysses) sequence parallelism: the second strategy of the
``sequence`` axis beside the ring (``parallel/ring.py``).

Counterpart of ``differential_transformer_replication_tpu/parallel/
ulysses.py`` with ``impl="pallas"``. Activations arrive sharded on the
sequence: rank r of the sequence line holds positions r*Tl ..
(r+1)*Tl - 1 of every sequence, all H heads. All-to-all #1 gathers the
sequence and splits the heads: line position i takes head group i (heads
i*H/P .. (i+1)*H/P - 1) at full T, and its slice of the coefficients.
Each rank then runs the port's single-device training attention, the
head-major route of ``ops/flash.py`` (``flash_bh``: kernels K1-K4, the
route picked by T), on full T over its H/P heads; all-to-all #2 restores
the sequence sharding. Everything outside attention stays sequence-
sharded. The backward is autograd's: an all-to-all of equal chunks is
its own transpose, so each exchange's backward is the same exchange of
the cotangents.

Local heads must divide by the sequence line's size (JAX's
``_check_heads``, the same text). With dropout, ``seed`` is this rank's
seed words, which the caller derives from its full mesh position
(``models/common.py:rank_seed``): the kernel keys its masks on the LOCAL
(b*H/P + h) index, which repeats across ranks, so the fold keeps every
rank's masks its own, as in JAX.

JAX's ``impl="xla"`` dense body is a reference, not a path: the port's
CPU route is the plain head-major twin that ``ops/flash.py`` runs for a
CPU tensor. Over gloo with CUDA tensors each all-to-all stages through
pinned host memory (``parallel/mesh.py:all_to_all_``), one exchange for
q, k and v together.
"""

from __future__ import annotations

import torch

from differential_transformer_replication_tpu_torch.ops.flash import flash_bh
from differential_transformer_replication_tpu_torch.parallel.mesh import (
    STATS,
    SequenceGroup,
    all_to_all_,
)

# the all-to-alls of this process: count, bytes sent, host seconds spent
# in them (the ring's ROTATION counterpart; the host time is the share of
# parallel/mesh.py's STATS they took)
EXCHANGE = {"calls": 0, "bytes": 0, "host_s": 0.0}


def reset_exchange_stats() -> None:
    EXCHANGE.update(calls=0, bytes=0, host_s=0.0)


def _check_heads(n_head_local: int, p: int) -> int:
    if n_head_local % p:
        raise ValueError(
            f"ulysses sequence parallelism needs local heads divisible by "
            f"the sequence axis: {n_head_local} heads per tensor shard vs "
            f"sequence={p} (use the ring, sequence_impl='ring', for uneven "
            f"head counts)"
        )
    return n_head_local // p


def _exchange(x: torch.Tensor, sg: SequenceGroup) -> torch.Tensor:
    """All-to-all of ``x``'s P leading chunks over the sequence line."""
    x = x.contiguous()
    before = STATS["host_s"]
    out = all_to_all_(torch.empty_like(x), x, sg)
    EXCHANGE["calls"] += 1
    EXCHANGE["bytes"] += x.numel() * x.element_size()
    EXCHANGE["host_s"] += STATS["host_s"] - before
    return out


class _AllToAll(torch.autograd.Function):
    """Chunk j of the input goes to line position j, chunk j of the output
    comes from it (JAX ``lax.all_to_all(..., tiled=True)``); the backward
    is the same exchange of the cotangents."""

    @staticmethod
    def forward(ctx, x, sg):
        ctx.sg = sg
        return _exchange(x, sg)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.sg), None


def all_to_all(x: torch.Tensor, sg: SequenceGroup) -> torch.Tensor:
    """Differentiable all-to-all of ``x``'s leading dim (size P)."""
    return _AllToAll.apply(x, sg)


def ulysses_flash_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       coeffs: torch.Tensor, sg: SequenceGroup, seed=None,
                       rate: float = 0.0) -> torch.Tensor:
    """Ulysses on this rank's head-major shards (the ring's
    ``ring_flash_body`` signature): q, k (B*H, S, Tl, d), v (B*H, Tl,
    dv), coeffs (S, H) fp32; ``seed`` this rank's (1, 2) seed words (the
    caller folds the mesh position in) and ``rate`` the attention
    dropout. Returns (B*H, Tl, dv) in v's dtype."""
    BH, S, Tl, d = q.shape
    H = coeffs.shape[1]
    B, P, dv = BH // H, sg.size, v.shape[-1]
    hh = _check_heads(H, P)
    # all-to-all #1: chunk j of every operand is head group j, to
    # position j; q, k and v travel in one flat buffer
    parts = [q.reshape(B, P, hh, S, Tl, d), k.reshape(B, P, hh, S, Tl, d),
             v.reshape(B, P, hh, Tl, dv)]
    flat = torch.cat([t.transpose(0, 1).reshape(P, -1) for t in parts], dim=1)
    got = all_to_all(flat, sg)  # chunk j: position j's T-shard of my heads
    nq = B * hh * S * Tl * d
    q_g = got[:, :nq].reshape(P, B, hh, S, Tl, d)
    k_g = got[:, nq:2 * nq].reshape(P, B, hh, S, Tl, d)
    v_g = got[:, 2 * nq:].reshape(P, B, hh, Tl, dv)
    T = P * Tl
    q_f = q_g.permute(1, 2, 3, 0, 4, 5).reshape(B * hh, S, T, d)
    k_f = k_g.permute(1, 2, 3, 0, 4, 5).reshape(B * hh, S, T, d)
    v_f = v_g.permute(1, 2, 0, 3, 4).reshape(B * hh, T, dv)
    c = coeffs[:, sg.rank * hh:(sg.rank + 1) * hh]
    out = flash_bh(q_f, k_f, v_f, c, seed, hh, rate)  # (B*hh, T, dv)
    # all-to-all #2: chunk j is T-shard j, to position j; what comes
    # back from position j is head group j of this rank's T-shard
    back = all_to_all(out.reshape(B, hh, P, Tl, dv).permute(2, 0, 1, 3, 4), sg)
    return back.permute(1, 0, 2, 3, 4).reshape(BH, Tl, dv)


def ulysses_multi_stream_attention(qs, ks, v, coeffs, sg: SequenceGroup, *,
                                   dropout_rate: float = 0.0, dropout_seed=None):
    """Causal multi-stream attention, sequence-sharded via all-to-all:
    qs/ks (S, B, Tl, H, d) and v (B, Tl, H, dv) this rank's shards (rank r
    holds positions r*Tl .. (r+1)*Tl - 1), coeffs (S, H); returns this
    rank's (B, Tl, H, dv). ``dropout_seed`` is this rank's (1, 2) seed
    words (None: no dropout)."""
    S, B, Tl, H, d = qs.shape
    dv = v.shape[-1]
    q_r = qs.permute(1, 3, 0, 2, 4).reshape(B * H, S, Tl, d)
    k_r = ks.permute(1, 3, 0, 2, 4).reshape(B * H, S, Tl, d)
    v_r = v.permute(0, 2, 1, 3).reshape(B * H, Tl, dv)
    out = ulysses_flash_body(q_r, k_r, v_r, coeffs, sg, dropout_seed, dropout_rate)
    return out.reshape(B, H, Tl, dv).transpose(1, 2)
