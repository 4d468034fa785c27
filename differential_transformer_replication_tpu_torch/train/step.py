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
"""

from __future__ import annotations

import torch

from differential_transformer_replication_tpu_torch.config import ModelConfig, TrainConfig
from differential_transformer_replication_tpu_torch.models import init_model, model_forward
from differential_transformer_replication_tpu_torch.ops.dropout import fold_seed
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
            model_cfg: ModelConfig, seed=None) -> torch.Tensor:
    _, loss = model_forward(params, x, model_cfg, targets=y, seed=seed)
    return loss


def group_norms(tree) -> dict:
    """Global L2 norm per layer group (a copy of the JAX package's
    obs/introspect.py:group_norms): embeddings, each block, the final
    norm + lm head."""
    embed = {k: v for k, v in tree.items() if k in ("tok_emb", "pos_emb")}
    head = {k: v for k, v in tree.items() if k in ("ln_f", "lm_head")}
    return {
        "embed": global_norm(leaves(embed)),
        "blocks": torch.stack([global_norm(leaves(b)) for b in tree["blocks"]]),
        "head": global_norm(leaves(head)),
    }


def make_step_fn(cfg: TrainConfig):
    """``step(state, batch, seed=None) -> (state, metrics)``. ``batch`` is
    ``{"x": (A, B, T), "y": (A, B, T)}`` int64 with A = grad_acc_steps.
    ``seed`` is the step's dropout seed (None: no dropout); microbatch i
    runs with ``fold_seed(seed, i)``, as JAX folds ``i`` into the step's
    key. The state is updated in place and returned; metrics are host
    floats."""
    model_cfg = cfg.resolved_model()
    schedule = cosine_warmup_schedule(cfg.learning_rate, cfg.warmup_iters,
                                      cfg.max_iters, cfg.min_lr)

    def step(state: dict, batch: dict, seed=None):
        params = state["params"]
        plist = leaves(params)
        n_micro = batch["x"].shape[0]
        grads = loss = None
        for i in range(n_micro):
            si = None if seed is None else fold_seed(seed, i)
            li = loss_fn(params, batch["x"][i], batch["y"][i], model_cfg, si)
            gi = torch.autograd.grad(li, plist)
            if grads is None:
                grads, loss = list(gi), li.detach()
            else:
                grads = [a + b for a, b in zip(grads, gi)]
                loss = loss + li.detach()
        if n_micro > 1:
            grads = [g / n_micro for g in grads]
            loss = loss / n_micro
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


def make_train_step(cfg: TrainConfig):
    """The single-card train step (PyTorch runs it eagerly; there is
    nothing to compile)."""
    return make_step_fn(cfg)


def make_eval_step(cfg: TrainConfig):
    """``eval_step(params, x, y) -> loss`` (a 0-d tensor), no grad: the
    attention runs its forward without residuals."""
    model_cfg = cfg.resolved_model()

    @torch.no_grad()
    def eval_step(params: dict, x: torch.Tensor, y: torch.Tensor):
        return loss_fn(params, x, y, model_cfg)

    return eval_step


def make_eval_many(cfg: TrainConfig):
    """``eval_many(params, xs, ys) -> (K,) losses`` over K stacked eval
    batches, one host sync per call."""
    eval_step = make_eval_step(cfg)

    def eval_many(params: dict, xs: torch.Tensor, ys: torch.Tensor):
        return torch.stack([eval_step(params, x, y) for x, y in zip(xs, ys)])

    return eval_many
