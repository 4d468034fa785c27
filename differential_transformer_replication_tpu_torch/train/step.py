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

With a sequence group (``parallel/``, the counterpart of the JAX
``make_sharded_train_step`` on a ``sequence`` mesh) every rank takes the
same global batch and keeps its T-shard; each runs its shard's forward
and backward through the ring (K/V cotangents travel back to their owners
through the rotations), then the param gradients and the loss are summed
over the ranks in one all-reduce. Clip, AdamW and the guard then run on
identical values on every rank, so the params stay bit-identical across
ranks. Eval goes through the ring too, as JAX's ``make_eval_step(mesh=)``.
"""

from __future__ import annotations

import torch

from differential_transformer_replication_tpu_torch.config import ModelConfig, TrainConfig
from differential_transformer_replication_tpu_torch.models import init_model, model_forward
from differential_transformer_replication_tpu_torch.obs.introspect import group_norms
from differential_transformer_replication_tpu_torch.ops.dropout import fold_seed
from differential_transformer_replication_tpu_torch.parallel.mesh import all_reduce_sum_
from differential_transformer_replication_tpu_torch.parallel.ring import use_ring
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


def make_grad_fn(cfg: TrainConfig, group=None):
    """``grads(params, batch, seed=None) -> (loss, grads)``: the mean loss
    (a 0-d tensor) and the param gradients (a list in :func:`leaves`
    order) of one optimizer step's ``grad_acc_steps`` microbatches,
    averaged; microbatch i runs with ``fold_seed(seed, i)``. With a
    sequence group, of the global batch: each rank computes its shard's
    terms and one all-reduce sums them.

    ``batch["poison"]``, present only while ``nan`` faults are armed
    (utils/faults.py), is one scale per microbatch: microbatch i's loss
    is multiplied by it before its backward, so NaN there makes that loss
    and every gradient NaN (the failure the guard must catch) and 1.0
    changes nothing."""
    model_cfg = cfg.resolved_model()

    def grads_fn(params: dict, batch: dict, seed=None):
        plist = leaves(params)
        xs, ys = shard_tokens(batch["x"], group), shard_tokens(batch["y"], group)
        poison = batch.get("poison")
        n_micro = xs.shape[0]
        grads = loss = None
        for i in range(n_micro):
            si = None if seed is None else fold_seed(seed, i)
            li = loss_fn(params, xs[i], ys[i], model_cfg, si, group)
            if poison is not None:
                li = li * float(poison[i])
            gi = torch.autograd.grad(li, plist)
            if grads is None:
                grads, loss = list(gi), li.detach()
            else:
                grads = [a + b for a, b in zip(grads, gi)]
                loss = loss + li.detach()
        if n_micro > 1:
            grads = [g / n_micro for g in grads]
            loss = loss / n_micro
        if use_ring(group):
            flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
            all_reduce_sum_(flat, group)
            loss = flat[0]
            grads = list(torch.split(flat[1:], [g.numel() for g in grads]))
            grads = [g.view(p.shape) for g, p in zip(grads, plist)]
        return loss, grads

    return grads_fn


def make_step_fn(cfg: TrainConfig, group=None):
    """``step(state, batch, seed=None) -> (state, metrics)``. ``batch`` is
    ``{"x": (A, B, T), "y": (A, B, T)}`` int64 with A = grad_acc_steps
    (the global batch: with a sequence group each rank keeps its
    T-shard). ``seed`` is the step's dropout seed (None: no dropout);
    microbatch i runs with ``fold_seed(seed, i)``, as JAX folds ``i`` into
    the step's key. The state is updated in place and returned; metrics
    are host floats."""
    schedule = cosine_warmup_schedule(cfg.learning_rate, cfg.warmup_iters,
                                      cfg.max_iters, cfg.min_lr)
    grads_fn = make_grad_fn(cfg, group)

    def step(state: dict, batch: dict, seed=None):
        params = state["params"]
        loss, grads = grads_fn(params, batch, seed)
        gg = group_norms(unflatten(params, grads))
        loss_f, norm_f = float(loss), float(global_norm(grads))
        metrics = {
            "loss": loss_f,
            "learning_rate": float(schedule(state["step"])),
            "grad_norm": norm_f,
            "grad_norm_groups": torch.cat([gg["embed"][None], gg["blocks"],
                                           gg["head"][None]]).tolist(),
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
    """The train step, on one card or (with a sequence group) on this
    rank of the ring (PyTorch runs it eagerly; there is nothing to
    compile)."""
    return make_step_fn(cfg, group)


def make_eval_step(cfg: TrainConfig, group=None):
    """``eval_step(params, x, y) -> loss`` (a 0-d tensor), no grad: the
    attention runs its forward without residuals. With a sequence group,
    of the global (B, T) batch through the ring, summed over the ranks."""
    model_cfg = cfg.resolved_model()

    @torch.no_grad()
    def eval_step(params: dict, x: torch.Tensor, y: torch.Tensor):
        loss = loss_fn(params, shard_tokens(x, group), shard_tokens(y, group),
                       model_cfg, None, group)
        if use_ring(group):
            loss = all_reduce_sum_(loss.reshape(1), group)[0]
        return loss

    return eval_step


def make_eval_many(cfg: TrainConfig, group=None):
    """``eval_many(params, xs, ys) -> (K,) losses`` over K stacked eval
    batches, one host sync per call."""
    eval_step = make_eval_step(cfg, group)

    def eval_many(params: dict, xs: torch.Tensor, ys: torch.Tensor):
        return torch.stack([eval_step(params, x, y) for x, y in zip(xs, ys)])

    return eval_many
