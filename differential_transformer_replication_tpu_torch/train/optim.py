"""Optimizer and LR schedule: the JAX package's optax chain, written out.

Counterpart of ``differential_transformer_replication_tpu/train/optim.py``
(``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
eps=1e-8, weight_decay))``), with optax's formulas and their order:

- the linear-warmup + cosine schedule, in fp32; step 0 runs at lr 0 and
  the cosine continues past max_iters (no clamp);
- global-norm clipping: ``t / ||g|| * max`` only when ``||g|| >= max``
  (``torch.nn.utils.clip_grad_norm_`` divides by ``||g|| + 1e-6`` and
  does not match);
- AdamW: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, bias
  corrections ``1 - b^count`` in fp32, ``u = mu_hat / (sqrt(nu_hat) +
  eps) + wd * p`` (decoupled decay on ALL params), ``p += -lr * u`` with
  lr = schedule(count before the increment).

The update and the norms run as multi-tensor (``torch._foreach_*``)
launches over all leaves, not a few launches per leaf. The optimizer
state is ``{"mu": tree, "nu": tree, "count": int}`` with the
param tree's layout (params/train_state_from_jax carries an optax state
across). Params and moments are updated IN PLACE.
"""

from __future__ import annotations

import math

import torch


def cosine_warmup_schedule(base_lr: float, warmup_steps: int, max_steps: int,
                           min_lr: float):
    """count -> fp32 lr (a 0-d CPU tensor), the exact formula of the
    reference's CosineWarmupScheduler.get_lr."""

    def schedule(count) -> torch.Tensor:
        c = torch.tensor(float(count), dtype=torch.float32)
        warm = base_lr * c / max(warmup_steps, 1)
        progress = (c - warmup_steps) / max(max_steps - warmup_steps, 1)
        factor = 0.5 * (1.0 + torch.cos(math.pi * progress))
        decay = min_lr + (base_lr - min_lr) * factor
        return torch.where(c < warmup_steps, warm, decay)

    return schedule


def leaves(tree) -> list:
    """The tensors of a param-layout tree in the JAX flatten order (dict
    keys sorted, lists in order), so sums over leaves add in the same
    order on both sides."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def unflatten(tree, items) -> dict:
    """``tree``'s layout filled from ``items`` in :func:`leaves` order."""
    it = iter(items)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [fill(v) for v in node]
        return next(it)

    return fill(tree)


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, fp32, on their device (the
    per-tensor norms in one multi-tensor launch)."""
    norms = torch._foreach_norm([t.to(torch.float32) for t in tensors])
    return torch.sqrt((torch.stack(norms) ** 2).sum())


def init_opt_state(params: dict) -> dict:
    zeros = lambda tree: _map(tree, torch.zeros_like)  # noqa: E731
    return {"mu": zeros(params), "nu": zeros(params), "count": 0}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


@torch.no_grad()
def clip_by_global_norm(grads, g_norm: float, max_norm: float) -> list:
    """optax.clip_by_global_norm on a list of grads, given their norm
    (the fp32 value, read back to the host): ``t / norm * max`` only when
    the norm is at least ``max``."""
    if g_norm < max_norm:
        return grads
    return torch._foreach_mul(torch._foreach_div(grads, g_norm), max_norm)


@torch.no_grad()
def adamw_update(params, grads, opt_state: dict, lr: torch.Tensor, b1: float,
                 b2: float, weight_decay: float, eps: float = 1e-8) -> None:
    """One AdamW step in place over ``params`` (a tree) with ``grads``
    (clipped, in the tree's leaf order); advances ``opt_state["count"]``.
    Each line is one multi-tensor (``torch._foreach_*``) launch over all
    leaves; the scalars are the fp32 values optax computes."""
    count_inc = opt_state["count"] + 1
    c = torch.tensor(float(count_inc), dtype=torch.float32)
    bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** c)
    bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** c)
    step = float(-lr)
    ps, mus, nus = leaves(params), leaves(opt_state["mu"]), leaves(opt_state["nu"])
    # mu = (1 - b1) g + b1 mu ; nu = (1 - b2) g^2 + b2 nu
    torch._foreach_mul_(mus, b1)
    torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(nus, b2)
    torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                1 - b2))
    # u = mu_hat / (sqrt(nu_hat) + eps) + wd p ; p += -lr u
    den = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
    torch._foreach_add_(den, eps)
    u = torch._foreach_div(torch._foreach_div(mus, bc1), den)
    torch._foreach_add_(u, torch._foreach_mul(ps, weight_decay))
    torch._foreach_add_(ps, torch._foreach_mul(u, step))
    opt_state["count"] = count_inc
