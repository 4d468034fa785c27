"""The JAX package's sharding rules on the port's mesh.

Counterpart of ``differential_transformer_replication_tpu/parallel/
sharding.py``, for the axes the port runs:

- the batch: :func:`shard_batch` keeps this rank's rows and T-shard of a
  global ``(A, B, T)`` batch, JAX's ``batch_sharding``,
  ``P(None, ("data", "fsdp"), "sequence")``: rows by the mesh's
  ``batch_index`` (data major), positions by its sequence coordinate;
- the tensor half of ``spec_for`` (:func:`tensor_dim`, Megatron): each
  leaf's dim on ``tensor`` or None (replicated). q/k/v, the lambdas and
  the GroupLayerNorm split on heads, gate/xform on their columns, the
  attention and FFN out-projections on their rows (their biases
  replicate: added once after the sum), the embeddings on rows, the lm
  head on vocab columns. A rank of a tensor line holds its
  :class:`TensorLayout` shard of every such leaf (and of AdamW's
  moments), contiguous, at rest and in the forward;
- the FSDP layout at rest (:class:`FsdpLayout`): the params are cut into
  the gradient buckets of ``parallel/dp_step.py`` (the embeddings, every
  ``dp_bucket_layers`` consecutive blocks, the ln_f/lm_head tail; JAX
  ``dp_step.py:145-167``). Each bucket's leaves, flattened in the
  ``train/optim.py:leaves`` order and padded with zeros to a multiple of
  fsdp, are one flat fp32 vector, of which fsdp rank i holds the i-th
  1/fsdp; so do AdamW's ``mu`` and ``nu``. The padding stays zero: its
  gradient is zero, and so its update.

Under tensor and fsdp together the FSDP layout cuts the rank's tensor
shards. The port does not copy JAX's per-leaf "largest dim on fsdp"
spec: a checkpoint stores the gathered full state in both packages
(:meth:`FsdpLayout.gather_state` then :meth:`TensorLayout.gather_state`,
JAX's ``gather_to_host``), so the layout at rest is the port's own
affair.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from differential_transformer_replication_tpu_torch.parallel.mesh import (
    Line,
    Mesh,
    all_gather_,
    all_reduce_sum_,
    reduce_scatter_,
)
from differential_transformer_replication_tpu_torch.parallel.regions import live
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


# ---------------------------------------------------------------------------
# the tensor axis
# ---------------------------------------------------------------------------


def tensor_dim(names: tuple, ndim: int) -> Optional[int]:
    """The dim of a param leaf at path ``names`` (its keys and list
    indices as strings) that JAX's ``spec_for`` puts on ``tensor``, or
    None where the leaf is replicated over the tensor line."""
    name = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if name in ("tok_emb", "pos_emb"):  # (V, E) / (T, E): rows
        return 0
    if name in ("wq", "wk"):  # (E, H, d) or (S, E, H, d): heads
        return ndim - 2
    if name == "wv" or name in ("lambda_q", "lambda_k"):  # (E|S, H, .)
        return 1
    if parent == "gn":  # (H * dv,): the head concat
        return 0
    if parent == "out" and ("attn" in names or "ffn" in names):
        return 0 if ndim == 2 else None  # row parallel; the bias replicates
    if parent in ("gate", "xform", "lm_head"):  # column parallel
        return ndim - 1
    return None


def tensor_dims(tree) -> list:
    """:func:`tensor_dim` of every leaf of ``tree`` in ``leaves`` order."""
    out = []

    def walk(node, names):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], names + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, names + (str(i),))
        else:
            out.append(tensor_dim(names, node.dim()))

    walk(tree, ())
    return out


def leaf_groups(tree) -> list:
    """The norm group of every leaf of a param tree in ``leaves`` order
    (``obs/introspect.py:group_norms``): 0 the embeddings, 1 + j block j,
    L + 1 the ln_f/lm_head tail."""
    n = len(tree["blocks"])
    out = []
    for k in sorted(tree):
        if k == "blocks":
            for j, blk in enumerate(tree[k]):
                out += [1 + j] * len(leaves(blk))
        else:
            out += [0 if k in ("tok_emb", "pos_emb") else n + 1] * len(leaves(tree[k]))
    return out


def tensor_norm_slots(params: dict, device) -> torch.Tensor:
    """(n_leaf, 2 (L + 2)) fp32 one-hot of each leaf's norm slot: its
    group (:func:`leaf_groups`), offset by L + 2 where the tensor axis
    shards it (:func:`tensor_group_sq`'s operand)."""
    G = len(params["blocks"]) + 2
    slot = [g + G * (d is not None) for g, d in zip(leaf_groups(params), tensor_dims(params))]
    return torch.nn.functional.one_hot(torch.tensor(slot, device=device),
                                       2 * G).to(torch.float32)


def tensor_group_sq(grads: list, slots: torch.Tensor, tp: Line) -> torch.Tensor:
    """(L + 2,) fp32 squared gradient norms of the embeddings, each block
    and the head on a tensor line, equal on every rank of it: the squared
    sums of the sharded leaves summed over the line, the replicated
    leaves' counted once. ``slots``: :func:`tensor_norm_slots`."""
    n2 = torch.stack(torch._foreach_norm([g.to(torch.float32) for g in grads])) ** 2
    sq = (n2[:, None] * slots).sum(0).view(2, -1)
    return sq[0] + all_reduce_sum_(sq[1].clone(), tp)


class TensorLayout:
    """This rank's shard of a tensor line (module docstring): cuts a full
    tree or train state to it and gathers one back, in one flat
    all-gather per tree."""

    def __init__(self, tp: Line):
        self.tp = tp

    def shard_tree(self, tree):
        """This rank's contiguous shard of every sharded leaf of a full
        tree (fresh tensors; replicated leaves copied)."""
        n, i = self.tp.size, self.tp.index
        ts = leaves(tree)
        out = []
        for t, dim in zip(ts, tensor_dims(tree)):
            t = t.detach()
            if dim is not None:
                w = t.shape[dim] // n
                t = t.narrow(dim, i * w, w)
            out.append(t.contiguous().clone())
        return unflatten(tree, out)

    def shard_state(self, state: dict) -> dict:
        """A full train state as this rank's shard (params requiring
        grad, AdamW's moments likewise cut)."""
        opt = state["opt_state"]
        params = self.shard_tree(state["params"])
        for t in leaves(params):
            t.requires_grad_(True)
        out = {"params": params,
               "opt_state": {"mu": self.shard_tree(opt["mu"]),
                             "nu": self.shard_tree(opt["nu"]), "count": opt["count"]},
               "step": state["step"]}
        if "guard" in state:
            out["guard"] = state["guard"]
        return out

    def gather_tree(self, tree):
        """The full tree (detached fresh tensors) of this rank's shard:
        every rank of the line joins."""
        ts = [t.detach() for t in leaves(tree)]
        dims = tensor_dims(tree)
        cut = [t for t, d in zip(ts, dims) if d is not None]
        n = self.tp.size
        flat = torch.cat([t.reshape(-1) for t in cut]) if cut else None
        got = None
        if flat is not None:
            got = torch.empty(n * flat.numel(), dtype=flat.dtype, device=flat.device)
            got = all_gather_(got, flat, self.tp).view(n, flat.numel())
        out, off = [], 0
        for t, d in zip(ts, dims):
            if d is None:
                out.append(t.clone())
                continue
            part = got[:, off:off + t.numel()].reshape(n, *t.shape)
            off += t.numel()
            full = list(t.shape)
            full[d] *= n
            out.append(part.movedim(0, d).reshape(full).contiguous())
        return unflatten(tree, out)

    def gather_state(self, state: dict) -> dict:
        """The full train state of this rank's shard (a checkpoint's)."""
        opt = state["opt_state"]
        out = {"params": self.gather_tree(state["params"]),
               "opt_state": {"mu": self.gather_tree(opt["mu"]),
                             "nu": self.gather_tree(opt["nu"]), "count": opt["count"]},
               "step": state["step"]}
        if "guard" in state:
            out["guard"] = state["guard"]
        return out


def tensor_layout(mesh: Mesh) -> Optional[TensorLayout]:
    """The tensor layout of this rank of ``mesh`` (None without tensor)."""
    tp = mesh.line("tensor")
    return TensorLayout(tp) if tp.size > 1 else None


# ---------------------------------------------------------------------------
# FSDP
# ---------------------------------------------------------------------------


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


def _bucket_order(per_leaf: list, params: dict, buckets: list) -> list:
    """Values given per leaf in ``leaves(params)`` order, re-ordered to
    the buckets' leaves in turn (each bucket's own ``leaves`` order)."""
    ids = unflatten(params, list(range(len(per_leaf))))
    return [per_leaf[k] for b in buckets for k in leaves(b.subtree(ids))]


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
    read; under tensor the rank's tensor shard) and the mesh."""

    def __init__(self, params: dict, mesh: Mesh, bucket_layers: int):
        self.fsdp = mesh.line("fsdp")
        self.tensor = mesh.line("tensor")
        # the ranks that hold the same shards: their gradients are summed
        self.rest = mesh.plane("fsdp", "tensor")
        self.n_batch = mesh.n_batch
        # the tree's structure alone: holding ``params`` would keep a full
        # copy alive at rest
        self.template = _skeleton(params)
        self.buckets = param_buckets(params, bucket_layers)
        self.n_layer = len(params["blocks"])
        f = self.fsdp.size
        self.shapes, self.numel, self.shard_numel = [], [], []
        # per bucket, each leaf's (start, stop) in the flat vector, its
        # norm group and whether the tensor axis shards it
        self.segments = []
        groups = iter(_bucket_order(leaf_groups(params), params, self.buckets))
        sharded = iter(_bucket_order([d is not None and live(self.tensor)
                                      for d in tensor_dims(params)],
                                     params, self.buckets))
        for b in self.buckets:
            shapes = [tuple(t.shape) for t in leaves(b.subtree(params))]
            n = sum(int(torch.Size(s).numel()) for s in shapes)
            self.shapes.append(shapes)
            self.numel.append(n)
            self.shard_numel.append(-(-n // f))
            segs, off = [], 0
            for s in shapes:
                k = int(torch.Size(s).numel())
                segs.append((off, off + k, next(groups), next(sharded)))
                off += k
            self.segments.append(segs)

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
        the fsdp line (so every rank holds the same values); under tensor
        the sums of the tensor-sharded leaves are reduced over the tensor
        line too, the replicated ones counted once."""
        r, G = self.fsdp.index, self.n_layer + 2
        kinds = 2 if live(self.tensor) else 1
        parts = [[[] for _ in range(G)] for _ in range(kinds)]
        for i, g in enumerate(grads):
            lo = r * self.shard_numel[i]
            g = g.to(torch.float32)
            for a, z, grp, sharded in self.segments[i]:
                a, z = max(a - lo, 0), min(z - lo, g.numel())
                if z > a:
                    parts[int(sharded)][grp].append((g[a:z] ** 2).sum())
        zero = grads[0].new_zeros((), dtype=torch.float32)
        sq = torch.stack([torch.stack([torch.stack(p).sum() if p else zero for p in kind])
                          for kind in parts])
        all_reduce_sum_(sq, self.fsdp)
        if kinds == 1:
            return sq[0]
        return sq[0] + all_reduce_sum_(sq[1].clone(), self.tensor)
