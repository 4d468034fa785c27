"""Ring attention: sequence parallelism over P ``torch.distributed`` ranks.

Counterpart of ``differential_transformer_replication_tpu/parallel/
ring.py`` with ``impl="pallas"`` (``_ring_flash_body``). Each rank keeps
its query shard (T/P rows of every sequence); the K/V shards rotate
around the ring, rank r sending to r + 1 and receiving from r - 1, one
step per rank. At step t rank r holds the K/V of rank src = r - t (mod
P), whose columns lie (r - src) * Tl positions earlier: the chunk op
(``ops/flash.py:flash_chunk_attention``, kernel K1 without the combine)
runs with that causal offset, so a chunk from a later rank (a negative
offset) is masked whole. The per-chunk ``(o_c, lse_c)`` merge exactly by
the running logsumexp in fp32, then the streams combine with ``coeffs``
in a plain einsum that autograd differentiates (dcoeffs).

The backward is autograd's: :class:`_Rotate` is a permutation, so its
backward is the inverse permutation (send to r - 1, receive from r + 1),
as JAX transposes ``ppermute``; K/V cotangents travel back to the ranks
that own them. JAX's loop makes P rotations, the last of which only
restores the placement and goes unused; the port makes P - 1 (same
numbers, one exchange less per layer and direction).

Beside a data or fsdp axis the ring is this rank's sequence line of the
mesh (``parallel/mesh.py``): the exchanges go to the global ranks of the
line's neighbouring positions, over the line's group.

Every rank launches the same kernels a rank with a card of its own would,
at the same offsets; only the transport differs. On ``nccl`` the
exchange moves CUDA tensors; gloo has no send/recv for CUDA tensors, so
there each exchange copies to a pinned host buffer, exchanges it and
copies back (ranks sharing one card). On the CPU the same ring runs the chunk op's
plain version; there is no dense ring.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from differential_transformer_replication_tpu_torch.ops.flash import (
    _coeffs_bh,
    flash_chunk_attention,
)
from differential_transformer_replication_tpu_torch.ops.streams import (
    diff_coeffs,
    ndiff_coeffs,
    vanilla_coeffs,
)
from differential_transformer_replication_tpu_torch.parallel.mesh import (
    SequenceGroup,
    to_host,
)

# the exchanges of this process: count, bytes sent, host seconds spent in
# them (read by train/step_profile.py)
ROTATION = {"calls": 0, "bytes": 0, "host_s": 0.0}


def reset_rotation_stats() -> None:
    ROTATION.update(calls=0, bytes=0, host_s=0.0)


def _shift(x: torch.Tensor, sg: SequenceGroup, step: int) -> torch.Tensor:
    """Send ``x`` to ring position rank + step, receive the same shape
    from rank - step, over the sequence line's group: the peers are the
    global ranks at those positions of the line (beside a data axis the
    line is not the world). With gloo and CUDA tensors, through host
    buffers."""
    src = x.detach().contiguous()
    if sg.stages_through_host:
        # the copy waits for x's kernels anyway: wait first, so the host
        # time below is the exchange's own
        torch.cuda.current_stream(x.device).synchronize()
    t0 = time.perf_counter()
    if sg.stages_through_host:
        src = to_host(src)
    out = torch.empty_like(src, pin_memory=sg.stages_through_host)
    ops = [dist.P2POp(dist.isend, src, sg.peer(sg.rank + step), sg.group),
           dist.P2POp(dist.irecv, out, sg.peer(sg.rank - step), sg.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = out.to(x.device)
    ROTATION["calls"] += 1
    ROTATION["bytes"] += src.numel() * src.element_size()
    ROTATION["host_s"] += time.perf_counter() - t0
    return out


class _Rotate(torch.autograd.Function):
    """One step of the ring (JAX ``ppermute`` with perm i -> i + 1); the
    backward is the inverse step."""

    @staticmethod
    def forward(ctx, x, sg):
        ctx.sg = sg
        return _shift(x, sg, +1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.sg, -1), None


def rotate(x: torch.Tensor, sg: SequenceGroup) -> torch.Tensor:
    """``x`` of rank r arrives at rank r + 1 (differentiable)."""
    return _Rotate.apply(x, sg)


def _rotate_kv(k: torch.Tensor, v: torch.Tensor, sg: SequenceGroup) -> tuple:
    """K and V in one exchange (one flat buffer)."""
    got = rotate(torch.cat([k.reshape(-1), v.reshape(-1)]), sg)
    nk = k.numel()
    return got[:nk].view(k.shape), got[nk:].view(v.shape)


def ring_flash_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    coeffs: torch.Tensor, sg: SequenceGroup, seed=None,
                    rate: float = 0.0) -> torch.Tensor:
    """The ring on this rank's head-major shards (JAX
    ``_ring_flash_body``): q, k (BH, S, Tl, d), v (BH, Tl, dv), coeffs
    (S, H) fp32; ``seed`` this rank's (1, 2) seed words (the caller folds
    the rank in) and ``rate`` the attention dropout. Returns (BH, Tl, dv)
    in v's dtype."""
    P, my = sg.size, sg.rank
    Tl = q.shape[2]
    o = lse = None
    k_t, v_t = k, v
    for t in range(P):
        src = (my - t) % P
        o_c, lse_c = flash_chunk_attention(q, k_t, v_t, (my - src) * Tl, seed, rate)
        if o is None:
            # the merge with the (0, NEG_INF) start is this chunk exactly
            o, lse = o_c.to(torch.float32), lse_c
        else:
            lse_new = torch.logaddexp(lse, lse_c)
            o = (o * torch.exp(lse - lse_new)[..., None]
                 + o_c.to(torch.float32) * torch.exp(lse_c - lse_new)[..., None])
            lse = lse_new
        if t < P - 1:
            k_t, v_t = _rotate_kv(k_t, v_t, sg)
    c = _coeffs_bh(coeffs, q.shape[0])
    return torch.einsum("bs,bstd->btd", c, o).to(v.dtype)


def ring_multi_stream_attention(qs, ks, v, coeffs, sg: SequenceGroup, *,
                                dropout_rate: float = 0.0, dropout_seed=None):
    """Causal multi-stream attention with the sequence ring-sharded over
    the ranks of ``sg``: qs/ks (S, B, Tl, H, d) and v (B, Tl, H, dv) this
    rank's shards (rank r holds positions r*Tl .. (r+1)*Tl - 1), coeffs
    (S, H); returns this rank's (B, Tl, H, dv). ``dropout_seed`` is this
    rank's (1, 2) seed words (None: no dropout)."""
    S, B, Tl, H, d = qs.shape
    dv = v.shape[-1]
    q_r = qs.permute(1, 3, 0, 2, 4).reshape(B * H, S, Tl, d)
    k_r = ks.permute(1, 3, 0, 2, 4).reshape(B * H, S, Tl, d)
    v_r = v.permute(0, 2, 1, 3).reshape(B * H, Tl, dv)
    out = ring_flash_body(q_r, k_r, v_r, coeffs, sg, dropout_seed, dropout_rate)
    return out.reshape(B, H, Tl, dv).transpose(1, 2)


def ring_vanilla_attention(q, k, v, sg: SequenceGroup, **kw):
    """Sequence-parallel vanilla attention (one stream, coefficient 1)."""
    return ring_multi_stream_attention(q[None], k[None], v,
                                       vanilla_coeffs(q.shape[2], q.device), sg, **kw)


def ring_diff_attention(q1, k1, q2, k2, v, lam, sg: SequenceGroup, **kw):
    """Sequence-parallel differential attention: coeffs [1, -lambda]."""
    return ring_multi_stream_attention(torch.stack([q1, q2]), torch.stack([k1, k2]),
                                       v, diff_coeffs(lam), sg, **kw)


def ring_ndiff_attention(qs, ks, v, lams, signs, sg: SequenceGroup, **kw):
    """Sequence-parallel N-term differential attention: coeffs sign_s *
    lambda_{s,h}."""
    return ring_multi_stream_attention(qs, ks, v, ndiff_coeffs(lams, signs), sg, **kw)


def use_ring(sg) -> bool:
    """Ring attention applies when a sequence group of more than one rank
    is threaded into the forward."""
    return sg is not None and sg.size > 1

