"""The data and fsdp half of the JAX package's sharding rules.

Counterpart of ``differential_transformer_replication_tpu/parallel/
sharding.py``, for the axes the port runs:

- the batch: :func:`shard_batch` keeps this rank's rows and T-shard of a
  global ``(A, B, T)`` batch, JAX's ``batch_sharding``,
  ``P(None, ("data", "fsdp"), "sequence")``: rows by the mesh's
  ``batch_index`` (data major), positions by its sequence coordinate;
- the FSDP layout at rest (:class:`FsdpLayout`): the params are cut into
  the gradient buckets of ``parallel/dp_step.py`` (the embeddings, every
  ``dp_bucket_layers`` consecutive blocks, the ln_f/lm_head tail; JAX
  ``dp_step.py:145-167``). Each bucket's leaves, flattened in the
  ``train/optim.py:leaves`` order and padded with zeros to a multiple of
  fsdp, are one flat fp32 vector, of which fsdp rank i holds the i-th
  1/fsdp; so do AdamW's ``mu`` and ``nu``. The padding stays zero: its
  gradient is zero, and so its update.

The port does not copy JAX's per-leaf "largest dim on fsdp" spec
(``spec_for``): a checkpoint stores the gathered full state in both
packages (:meth:`FsdpLayout.gather_state`, JAX's ``gather_to_host``), so
the layout at rest is the port's own affair. The ``tensor`` specs wait
for tensor parallelism (ROADMAP Queue A: parallelism).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from differential_transformer_replication_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    all_gather_,
    all_reduce_sum_,
    reduce_scatter_,
)
from differential_transformer_replication_tpu_torch.train.optim import leaves, unflatten


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's slice of a global batch: ``x``/``y`` (..., B, T) keep
    rows ``batch_index * B/n .. `` (n = data x fsdp) and the sequence
    coordinate's T-shard; other entries (the fault poison) pass whole."""
    n, b = mesh.n_batch, mesh.batch_index
    seq = mesh.line("sequence")
    out = dict(batch)
    for k in ("x", "y"):
        if k not in batch:
            continue
        t = batch[k]
        rows, T = t.shape[-2] // n, t.shape[-1] // seq.size
        out[k] = t[..., b * rows:(b + 1) * rows, seq.index * T:(seq.index + 1) * T]
    return out


@dataclass(frozen=True)
class Bucket:
    """One gradient bucket: top-level ``keys`` of the param tree, or the
    blocks ``start`` .. ``stop`` - 1."""

    keys: tuple = ()
    start: int = 0
    stop: int = 0

    def subtree(self, params: dict):
        if self.keys:
            return {k: params[k] for k in self.keys}
        return list(params["blocks"][self.start:self.stop])


def param_buckets(params: dict, bucket_layers: int) -> list:
    """JAX ``make_param_sync``'s buckets in forward order: the embedding
    table(s), every ``bucket_layers`` consecutive blocks, the ln_f/lm_head
    tail."""
    group = max(1, int(bucket_layers))
    tail = tuple(k for k in ("ln_f", "lm_head") if k in params)
    embed = tuple(k for k in params if k != "blocks" and k not in tail)
    n = len(params["blocks"])
    return ([Bucket(keys=embed)]
            + [Bucket(start=s, stop=min(s + group, n)) for s in range(0, n, group)]
            + [Bucket(keys=tail)])


def _skeleton(tree):
    """``tree``'s dicts and lists with None for every leaf."""
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


class FsdpLayout:
    """The flat per-bucket shards of one rank (module docstring): built
    from a param tree (any values: only its structure and shapes are
    read) and the mesh."""

    def __init__(self, params: dict, mesh: Mesh, bucket_layers: int):
        self.fsdp = mesh.line("fsdp")
        # the ranks that hold the same shards: their gradients are summed
        self.rest = mesh.line(*(a for a in AXES if a != "fsdp"))
        self.n_batch = mesh.n_batch
        # the tree's structure alone: holding ``params`` would keep a full
        # copy alive at rest
        self.template = _skeleton(params)
        self.buckets = param_buckets(params, bucket_layers)
        self.n_layer = len(params["blocks"])
        f = self.fsdp.size
        self.shapes, self.numel, self.shard_numel = [], [], []
        for b in self.buckets:
            shapes = [tuple(t.shape) for t in leaves(b.subtree(params))]
            n = sum(int(torch.Size(s).numel()) for s in shapes)
            self.shapes.append(shapes)
            self.numel.append(n)
            self.shard_numel.append(-(-n // f))

    # -- at rest -----------------------------------------------------------

    def _flat(self, i: int, tree: dict) -> torch.Tensor:
        ts = leaves(self.buckets[i].subtree(tree))
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in ts])
        pad = self.shard_numel[i] * self.fsdp.size - flat.numel()
        return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat

    def shard_tree(self, tree: dict) -> list:
        """This rank's shard of every bucket of a full tree (fresh fp32
        tensors, in bucket order)."""
        r = self.fsdp.index
        return [self._flat(i, tree)[r * n:(r + 1) * n].clone()
                for i, n in enumerate(self.shard_numel)]

    def shard_state(self, state: dict) -> dict:
        """A full train state (train/step.py's) as this rank's shards:
        ``params`` and the moments become lists of flat shards; ``count``,
        ``step`` and the guard stay."""
        out = {"params": [t.requires_grad_(True) for t in self.shard_tree(state["params"])],
               "opt_state": {"mu": self.shard_tree(state["opt_state"]["mu"]),
                             "nu": self.shard_tree(state["opt_state"]["nu"]),
                             "count": state["opt_state"]["count"]},
               "step": state["step"]}
        if "guard" in state:
            out["guard"] = state["guard"]
        return out

    # -- gathers -----------------------------------------------------------

    def gather_flat(self, i: int, shard: torch.Tensor) -> torch.Tensor:
        """The full (padded) flat vector of bucket ``i`` from its shards
        (an all-gather over the fsdp line)."""
        full = torch.empty(self.shard_numel[i] * self.fsdp.size, dtype=shard.dtype,
                           device=shard.device)
        return all_gather_(full, shard.detach(), self.fsdp)

    def unflat(self, i: int, full: torch.Tensor):
        """Bucket ``i``'s subtree as views of its full flat vector."""
        views, off = [], 0
        for shape in self.shapes[i]:
            n = int(torch.Size(shape).numel())
            views.append(full[off:off + n].view(shape))
            off += n
        return unflatten(self.buckets[i].subtree(self.template), views)

    def assemble(self, subtrees: list) -> dict:
        """A full param tree from the buckets' subtrees."""
        tree, blocks = {}, []
        for b, sub in zip(self.buckets, subtrees):
            if b.keys:
                tree.update(sub)
            else:
                blocks.extend(sub)
        tree["blocks"] = blocks
        return tree

    def gather_tree(self, shards: list) -> dict:
        """The full tree (detached copies) of a shard list."""
        return self.assemble([self.unflat(i, self.gather_flat(i, s))
                              for i, s in enumerate(shards)])

    def gather_state(self, state: dict) -> dict:
        """The full train state of a sharded one, on every rank of the
        fsdp line (for a checkpoint: JAX's ``gather_to_host``)."""
        opt = state["opt_state"]
        out = {"params": self.gather_tree(state["params"]),
               "opt_state": {"mu": self.gather_tree(opt["mu"]),
                             "nu": self.gather_tree(opt["nu"]),
                             "count": opt["count"]},
               "step": state["step"]}
        if "guard" in state:
            out["guard"] = state["guard"]
        return out

    # -- the step's reductions -------------------------------------------

    def reduce_grad(self, i: int, g: torch.Tensor) -> torch.Tensor:
        """Bucket ``i``'s full local gradient -> this rank's shard of the
        mean over the batch shards: reduce-scatter over the fsdp line,
        sum over the ranks holding the same shard, / (data x fsdp)."""
        out = torch.empty(self.shard_numel[i], dtype=torch.float32, device=g.device)
        reduce_scatter_(out, g.to(torch.float32), self.fsdp)
        all_reduce_sum_(out, self.rest)
        return out.div_(self.n_batch)

    def group_sq(self, grads: list) -> torch.Tensor:
        """(L + 2,) fp32 squared norms of the embeddings, each block and
        the head, over all shards: this rank's shard sums, reduced over
        the fsdp line (so every rank holds the same values)."""
        r = self.fsdp.index
        sums = []
        for i, (b, g) in enumerate(zip(self.buckets, grads)):
            lo = r * self.shard_numel[i]
            g = g.to(torch.float32)
            if b.keys:
                ranges = [(0, self.numel[i])]
            else:
                sizes, per = [int(torch.Size(s).numel()) for s in self.shapes[i]], []
                n_leaf = len(sizes) // (b.stop - b.start)
                for j in range(b.stop - b.start):
                    per.append(sum(sizes[j * n_leaf:(j + 1) * n_leaf]))
                ranges, off = [], 0
                for n in per:
                    ranges.append((off, off + n))
                    off += n
            for a, z in ranges:
                a, z = max(a - lo, 0), min(z - lo, g.numel())
                sums.append((g[a:z] ** 2).sum() if z > a else g.new_zeros(()))
        sq = torch.stack(sums)
        return all_reduce_sum_(sq, self.fsdp)
