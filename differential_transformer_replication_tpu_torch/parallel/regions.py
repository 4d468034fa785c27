"""The region boundaries of the ``tensor`` axis (Megatron), as autograd
Functions over a tensor :class:`~parallel.mesh.Line`.

JAX's GSPMD partitioner inserts these collectives from the param specs
(``parallel/sharding.py:spec_for``); the port writes each one out with
its adjoint:

- :func:`copy_to_region`: identity forward, all-reduce backward. The
  input of a column-parallel region (the attention's q/k/v projections,
  the SwiGLU's gate/xform, the lm head) is held in full by every rank;
  each rank's local columns give a partial cotangent, summed here;
- :func:`reduce_from_region`: all-reduce forward, identity backward. The
  output of a row-parallel product (the attention's and the FFN's
  out-projection, the vocab-sharded embedding lookup) is a partial sum
  on each rank;
- :func:`gather_columns`: all-gather along the last dim in line order,
  whose adjoint is the reduce-scatter: the GroupLayerNorm spans every
  rank's heads, so each rank gathers the head concat, normalizes it at
  full width and keeps its own columns; the columns it drops feed other
  ranks' math, and the cotangents of the gathered tensor are partial
  sums over the line.

Sums are exchanged in the tensor's own dtype: gloo sums bf16 (on two
ranks the one rounding of a + b equals the rounding of its fp32 sum). A
line of one rank makes every one an identity. The collectives go
through ``parallel/mesh.py`` and are counted in its ``STATS``.
"""

from __future__ import annotations

import torch

from differential_transformer_replication_tpu_torch.parallel.mesh import (
    Line,
    all_gather_,
    all_reduce_sum_,
    reduce_scatter_,
)


def _sum(t: torch.Tensor, tp: Line) -> torch.Tensor:
    return all_reduce_sum_(t.detach().clone(memory_format=torch.contiguous_format), tp)


class _CopyToRegion(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.tp), None


class _ReduceFromRegion(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, tp):
        return _sum(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather_last(x: torch.Tensor, tp: Line) -> torch.Tensor:
    """(..., C) on each rank -> (..., tp*C), rank i's columns at i*C."""
    flat = torch.empty(tp.size * x.numel(), dtype=x.dtype, device=x.device)
    all_gather_(flat, x.detach().contiguous(), tp)
    stacked = flat.view(tp.size, *x.shape)
    return stacked.movedim(0, -2).reshape(*x.shape[:-1], tp.size * x.shape[-1])


def _scatter_last(g: torch.Tensor, tp: Line) -> torch.Tensor:
    """The adjoint of :func:`_gather_last`: (..., tp*C) summed over the
    line, this rank's columns kept."""
    C = g.shape[-1] // tp.size
    parts = g.reshape(*g.shape[:-1], tp.size, C).movedim(-2, 0).contiguous()
    out = torch.empty(g.shape[:-1] + (C,), dtype=g.dtype, device=g.device)
    return reduce_scatter_(out.view(-1), parts, tp).view(out.shape)


class _GatherColumns(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _gather_last(x, tp)

    @staticmethod
    def backward(ctx, g):
        return _scatter_last(g, ctx.tp), None


def live(tp) -> bool:
    """A tensor line of more than one rank."""
    return tp is not None and tp.size > 1


def copy_to_region(x: torch.Tensor, tp) -> torch.Tensor:
    """Identity forward; the backward sums the cotangent over ``tp``."""
    return _CopyToRegion.apply(x, tp) if live(tp) else x


def reduce_from_region(x: torch.Tensor, tp) -> torch.Tensor:
    """The sum of ``x`` over ``tp``; the backward passes the cotangent
    through."""
    return _ReduceFromRegion.apply(x, tp) if live(tp) else x


def gather_columns(x: torch.Tensor, tp) -> torch.Tensor:
    """``x`` (..., C) of every rank of ``tp`` side by side in line order,
    (..., tp*C); the backward reduce-scatters the cotangent."""
    return _GatherColumns.apply(x, tp) if live(tp) else x


def own_columns(x: torch.Tensor, tp) -> torch.Tensor:
    """This rank's block of the last dim of a gathered (..., tp*C)."""
    if not live(tp):
        return x
    C = x.shape[-1] // tp.size
    return x[..., tp.index * C:(tp.index + 1) * C]
