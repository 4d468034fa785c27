"""In-step anomaly guard: skip bad updates.

Counterpart of the skip layer of ``differential_transformer_replication_
tpu/train/anomaly.py``: a step is ``bad`` when its loss or grad norm is
non-finite, or (once ``anomaly_warmup_steps`` good steps have seeded
it) its grad norm exceeds ``anomaly_spike_factor`` x a running EMA of
good steps' norms; a bad step leaves params, optimizer moments and the
EMA untouched while the step counter still advances. The decision needs
the loss and norm on the host (one sync per step, which the train step
makes anyway for its metrics); the JAX package decides on the device
under ``lax.cond``. Rollback to snapshots and the abort belong to the
trainer slice (ROADMAP Queue A: full trainer).
"""

from __future__ import annotations

import math

import numpy as np


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
