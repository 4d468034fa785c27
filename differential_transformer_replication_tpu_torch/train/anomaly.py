"""Anomaly guard: skip bad updates, roll back, abort.

Counterpart of ``differential_transformer_replication_tpu/train/
anomaly.py``, its three layers:

1. **Skip** (the train step): a step is ``bad`` when its loss or grad
   norm is non-finite, or (once ``anomaly_warmup_steps`` good steps have
   seeded it) its grad norm exceeds ``anomaly_spike_factor`` x a running
   EMA of good steps' norms; a bad step leaves params, optimizer moments
   and the EMA untouched while the step counter still advances. The
   decision needs the loss and norm on the host (one sync per step,
   which the train step makes anyway for its metrics); the JAX package
   decides on the device under ``lax.cond``.
2. **Rollback** (the trainer): a periodic device copy of a known-good
   train state (:func:`snapshot_state`); when ``bad_streak`` reaches
   ``anomaly_rollback_after`` the trainer copies it back into the live
   tensors (:func:`restore_state`) and rewinds the epoch sampler.
3. **Abort** (the trainer): past ``anomaly_max_rollbacks`` rollbacks it
   raises :class:`TrainingDivergedError`, and the non-finite state never
   replaces the last checkpoint.

On a sequence ring the loss and grad norm are all-reduced before the
guard reads them, so every rank takes the same decisions.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class TrainingDivergedError(RuntimeError):
    """Raised when the rollback budget is exhausted: the run cannot make
    progress and must stop before corrupting its checkpoints."""


def init_guard_state() -> dict:
    return {"ema": np.float32(0.0), "good_steps": 0, "bad_streak": 0,
            "skipped": 0}


def apply_guard(cfg, guard: dict, loss: float, grad_norm: float,
                do_update) -> tuple:
    """Decide ``bad``, run ``do_update()`` only on a good step, advance
    the guard. Returns (new guard, extra metrics)."""
    finite = math.isfinite(loss) and math.isfinite(grad_norm)
    warmed = guard["good_steps"] >= max(cfg.anomaly_warmup_steps, 1)
    spike = warmed and grad_norm > cfg.anomaly_spike_factor * float(guard["ema"])
    bad = (not finite) or spike
    if not bad:
        do_update()
    beta = np.float32(cfg.anomaly_ema_beta)
    norm = np.float32(grad_norm)
    seeded = norm if guard["good_steps"] == 0 else (
        beta * guard["ema"] + (np.float32(1.0) - beta) * norm)
    new = {
        "ema": guard["ema"] if bad else np.float32(seeded),
        "good_steps": guard["good_steps"] + (0 if bad else 1),
        "bad_streak": guard["bad_streak"] + 1 if bad else 0,
        "skipped": guard["skipped"] + int(bad),
    }
    extra = {"bad": int(bad), "bad_streak": new["bad_streak"],
             "skipped": new["skipped"]}
    return new, extra


def snapshot_state(tree):
    """A device copy of a train state: every tensor cloned (detached, on
    its device), the host values (``step``, the optimizer's ``count``,
    the guard's state) copied. The optimizer updates the live params in
    place, so a snapshot must never share their storage."""
    if isinstance(tree, dict):
        return {k: snapshot_state(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [snapshot_state(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


@torch.no_grad()
def restore_state(state, snapshot):
    """Copy ``snapshot`` back into the live train state ``state``: tensors
    in place (the live params keep their identity and ``requires_grad``),
    host values replaced. The snapshot is left as it was, so a second
    rollback can use it. Returns ``state``."""
    if isinstance(state, dict):
        for k in state.keys() - snapshot.keys():
            del state[k]
        for k, v in snapshot.items():
            state[k] = restore_state(state[k], v) if k in state else \
                snapshot_state(v)
        return state
    if isinstance(state, list):
        state[:] = [restore_state(a, b) for a, b in zip(state, snapshot)]
        return state
    if isinstance(state, torch.Tensor):
        state.copy_(snapshot)
        return state
    return snapshot_state(snapshot)
