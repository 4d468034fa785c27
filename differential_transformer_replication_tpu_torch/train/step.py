"""The training and evaluation steps.

Counterpart of ``differential_transformer_replication_tpu/train/step.py``:
one optimizer step is forward, backward, global-norm clip, AdamW and the
anomaly guard, with ``grad_acc_steps`` microbatches whose gradients are
averaged (the sum of the microbatch grads over A, the loss likewise).
PyTorch runs it eagerly: the forward and backward go through the
port's kernels on the card (ops/), the update through train/optim.py.

The train state is a plain dict ``{"params": tree, "opt_state": {"mu",
"nu", "count"}, "step": int[, "guard": dict]}``; params are fp32 leaves
that require grad and are updated in place.

With a sequence group or a mesh of ranks (``parallel/``, the
counterpart of the JAX ``make_sharded_train_step``) every rank takes the
same global batch and keeps its shard (its T-shard on a ring; its rows
and T-shard on a mesh, ``parallel/sharding.py:shard_batch``); each runs
its shard's forward and backward (through the ring or Ulysses on a
sequence line, through the region collectives of its tensor line),
then the param gradients and the loss are summed in one all-reduce over
the ranks that hold the same tensor shard (the plane of every axis but
``tensor``: every rank of a tensor line holds the same loss, and a
sharded gradient sums only with its own shard's) and divided by the
batch shards: the flat step. Clip, AdamW and the guard then run on
identical values on every rank of that plane, and the gradient norms
count a tensor-sharded leaf over its line and a replicated one once
(``sharding.tensor_group_sq``), so every rank judges the same norm and
the replicated params stay bit-identical across ranks. Eval goes
through the mesh too, as JAX's ``make_eval_step(mesh=)``.

``make_step_fn`` also takes JAX's three hooks, which
``parallel/dp_step.py`` passes for its overlap and sharded steps:
``param_sync`` maps the params inside each microbatch's loss (the
per-bucket sync or gather, whose backward reduces that bucket's
gradient), ``loss_sync`` the local loss to the global mean, and
``grad_sync`` the accumulated gradients (with ``grad_acc_steps > 1``
the microbatches then differentiate the local loss, as in JAX). Under
FSDP the state's params are flat shards and ``layout``
(``parallel/sharding.py:FsdpLayout``) computes the norms over them.
"""

from __future__ import annotations

import torch

from differential_transformer_replication_tpu_torch.config import ModelConfig, TrainConfig
from differential_transformer_replication_tpu_torch.models import init_model, model_forward
from differential_transformer_replication_tpu_torch.obs.introspect import group_norms
from differential_transformer_replication_tpu_torch.ops.dropout import fold_seed
from differential_transformer_replication_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum_,
)
from differential_transformer_replication_tpu_torch.parallel.ring import use_ring
from differential_transformer_replication_tpu_torch.parallel.sharding import (
    shard_batch,
    tensor_group_sq,
    tensor_norm_slots,
)
from differential_transformer_replication_tpu_torch.train.anomaly import (
    apply_guard,
    init_guard_state,
)
from differential_transformer_replication_tpu_torch.train.optim import (
    adamw_update,
    clip_by_global_norm,
    cosine_warmup_schedule,
    global_norm,
    init_opt_state,
    leaves,
    unflatten,
)


def _to_leaves(tree, device):
    if isinstance(tree, dict):
        return {k: _to_leaves(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_leaves(v, device) for v in tree]
    return tree.detach().to(device=device, dtype=torch.float32).requires_grad_(True)


def train_state(params: dict, cfg: TrainConfig, device) -> dict:
    """A fresh train state around ``params`` (copied to ``device`` as
    fp32 leaves that require grad)."""
    params = _to_leaves(params, device)
    state = {"params": params, "opt_state": init_opt_state(params), "step": 0}
    if cfg.anomaly_guard:
        state["guard"] = init_guard_state()
    return state


def create_train_state(gen: torch.Generator, cfg: TrainConfig, device) -> dict:
    """Params drawn from ``gen`` (on its device), then moved to ``device``."""
    return train_state(init_model(gen, cfg.resolved_model()), cfg, device)


def loss_fn(params: dict, x: torch.Tensor, y: torch.Tensor,
            model_cfg: ModelConfig, seed=None, group=None) -> torch.Tensor:
    _, loss = model_forward(params, x, model_cfg, targets=y, seed=seed,
                            group=group)
    return loss


def shard_tokens(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's T-shard of a (..., T) token array (all of it without a
    ring): rank r keeps positions r*T/P .. (r+1)*T/P - 1."""
    if not use_ring(group):
        return t
    Tl = t.shape[-1] // group.size
    return t[..., group.rank * Tl:(group.rank + 1) * Tl]


def _placement(group) -> tuple:
    """(the mesh or None, the model's sequence view, the ranks the flat
    sync spans or None, the batch shards) of a step's ``group``: None,
    a ring's ``SequenceGroup``, or a ``parallel.Mesh`` (whose sync spans
    the plane of every axis but ``tensor``)."""
    if isinstance(group, Mesh):
        plane = group.plane("tensor")
        return (group, group.sequence_group, plane if plane.size > 1 else None,
                group.n_batch)
    return None, group, group if use_ring(group) else None, 1


def _local(t: torch.Tensor, mesh, sg) -> torch.Tensor:
    """This rank's rows and T-shard of a (..., B, T) token array."""
    if mesh is not None:
        return shard_batch({"x": t}, mesh)["x"]
    return shard_tokens(t, sg)


def make_grad_fn(cfg: TrainConfig, group=None, param_sync=None,
                 grad_sync=None, batch_is_local: bool = False):
    """``grads(params, batch, seed=None) -> (loss, grads)``: the mean loss
    (a 0-d tensor) and the param gradients (a list in :func:`leaves`
    order) of one optimizer step's ``grad_acc_steps`` microbatches,
    averaged; microbatch i runs with ``fold_seed(seed, i)``. With a
    sequence group or a mesh, of the global batch (``batch_is_local``:
    this rank's shard of it already): each rank computes its shard's
    terms and one all-reduce sums them (divided by the batch shards).
    ``param_sync`` and ``grad_sync`` are JAX's hooks (module
    docstring): the loss is then this rank's, for the caller's
    ``loss_sync``.

    ``batch["poison"]``, present only while ``nan`` faults are armed
    (utils/faults.py), is one scale per microbatch: microbatch i's loss
    is multiplied by it before its backward, so NaN there makes that loss
    and every gradient NaN (the failure the guard must catch) and 1.0
    changes nothing."""
    model_cfg = cfg.resolved_model()
    mesh, sg, spans, n_batch = _placement(group)
    hooked = param_sync is not None or grad_sync is not None

    def grads_fn(params, batch: dict, seed=None):
        plist = leaves(params)
        xs, ys = batch["x"], batch["y"]
        if not batch_is_local:
            xs, ys = _local(xs, mesh, sg), _local(ys, mesh, sg)
        poison = batch.get("poison")
        n_micro = xs.shape[0]
        # JAX: one microbatch differentiates through param_sync; an
        # accumulation does too unless grad_sync syncs after the loop
        sync_each = param_sync is not None and (n_micro == 1 or grad_sync is None)
        grads = loss = None
        for i in range(n_micro):
            si = None if seed is None else fold_seed(seed, i)
            p = param_sync(params) if sync_each else params
            li = loss_fn(p, xs[i], ys[i], model_cfg, si, sg)
            if poison is not None:
                li = li * float(poison[i])
            gi = torch.autograd.grad(li, plist)
            del p
            if grads is None:
                grads, loss = list(gi), li.detach()
            else:
                grads = [a + b for a, b in zip(grads, gi)]
                loss = loss + li.detach()
        if n_micro > 1:
            grads = [g / n_micro for g in grads]
            loss = loss / n_micro
            if grad_sync is not None:
                grads = grad_sync(grads)
        if spans is not None and not hooked:
            flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
            all_reduce_sum_(flat, spans)
            if n_batch > 1:
                flat.div_(n_batch)
            loss = flat[0]
            grads = list(torch.split(flat[1:], [g.numel() for g in grads]))
            grads = [g.view(p.shape) for g, p in zip(grads, plist)]
        return loss, grads

    return grads_fn


def make_step_fn(cfg: TrainConfig, group=None, param_sync=None,
                 loss_sync=None, grad_sync=None, layout=None,
                 batch_is_local: bool = False):
    """``step(state, batch, seed=None) -> (state, metrics)``. ``batch`` is
    ``{"x": (A, B, T), "y": (A, B, T)}`` int64 with A = grad_acc_steps
    (the global batch: with a sequence group or a mesh each rank keeps
    its shard, or is given it with ``batch_is_local``). ``seed`` is the
    step's dropout seed (None: no dropout); microbatch i runs with
    ``fold_seed(seed, i)``, as JAX folds ``i`` into the step's key. The
    state is updated in place and returned; metrics are host floats. The
    hooks and ``layout`` are JAX's (module docstring)."""
    schedule = cosine_warmup_schedule(cfg.learning_rate, cfg.warmup_iters,
                                      cfg.max_iters, cfg.min_lr)
    grads_fn = make_grad_fn(cfg, group, param_sync, grad_sync, batch_is_local)
    tp = group.line("tensor") if isinstance(group, Mesh) else None
    norm_slots = []  # tensor_norm_slots of the params, made at the first step

    def step(state: dict, batch: dict, seed=None):
        params = state["params"]
        loss, grads = grads_fn(params, batch, seed)
        if loss_sync is not None:
            # the global mean before the guard reads it: every rank must
            # judge the same value
            loss = loss_sync(loss)
        if layout is None and tp is not None and tp.size > 1:
            if not norm_slots:
                norm_slots.append(tensor_norm_slots(params, grads[0].device))
            sq = tensor_group_sq(grads, norm_slots[0], tp)
            groups, norm_f = torch.sqrt(sq), float(torch.sqrt(sq.sum()))
        elif layout is None:
            gg = group_norms(unflatten(params, grads))
            groups = torch.cat([gg["embed"][None], gg["blocks"], gg["head"][None]])
            norm_f = float(global_norm(grads))
        else:
            # the shards' squared sums, reduced over the fsdp line
            sq = layout.group_sq(grads)
            groups, norm_f = torch.sqrt(sq), float(torch.sqrt(sq.sum()))
        loss_f = float(loss)
        metrics = {
            "loss": loss_f,
            "learning_rate": float(schedule(state["step"])),
            "grad_norm": norm_f,
            "grad_norm_groups": groups.tolist(),
        }

        def do_update():
            opt = state["opt_state"]
            clipped = clip_by_global_norm(grads, norm_f, cfg.grad_clip)
            adamw_update(params, clipped, opt, schedule(opt["count"]),
                         cfg.beta1, cfg.beta2, cfg.weight_decay)

        if cfg.anomaly_guard:
            state["guard"], extra = apply_guard(cfg, state["guard"], loss_f,
                                                norm_f, do_update)
            metrics.update(extra)
        else:
            do_update()
        state["step"] += 1
        return state, metrics

    return step


def make_train_step(cfg: TrainConfig, group=None):
    """The train step, on one card or (with a sequence group or a mesh)
    the flat step on this rank (PyTorch runs it eagerly; there is nothing
    to compile). ``parallel/dp_step.py:make_sharded_train_step`` picks a
    mesh's step."""
    return make_step_fn(cfg, group)


def make_eval_step(cfg: TrainConfig, group=None, batch_is_local: bool = False):
    """``eval_step(params, x, y) -> loss`` (a 0-d tensor), no grad: the
    attention runs its forward without residuals. With a sequence group
    or a mesh, of the global (B, T) batch (``batch_is_local``: this
    rank's shard of it already): each rank's shard (through the ring or
    Ulysses), summed over the ranks and divided by the batch shards. The
    params are full trees (a sharded state is gathered first)."""
    model_cfg = cfg.resolved_model()
    mesh, sg, spans, n_batch = _placement(group)

    @torch.no_grad()
    def eval_step(params: dict, x: torch.Tensor, y: torch.Tensor):
        if not batch_is_local:
            x, y = _local(x, mesh, sg), _local(y, mesh, sg)
        loss = loss_fn(params, x, y, model_cfg, None, sg)
        if spans is not None:
            loss = all_reduce_sum_(loss.reshape(1), spans)[0] / n_batch
        return loss

    return eval_step


def make_eval_many(cfg: TrainConfig, group=None, batch_is_local: bool = False):
    """``eval_many(params, xs, ys) -> (K,) losses`` over K stacked eval
    batches, one host sync per call."""
    eval_step = make_eval_step(cfg, group, batch_is_local)

    def eval_many(params: dict, xs: torch.Tensor, ys: torch.Tensor):
        return torch.stack([eval_step(params, x, y) for x, y in zip(xs, ys)])

    return eval_many
