"""Where a serving decode step of the port spends its time on the GPU.

    python -m differential_transformer_replication_tpu_torch.serving.decode_profile

Builds the diff model at the reference recipe's widths (random weights
from seed 0, bf16 compute), fills the 8 slots of a ``ServingEngine``
with 256-token prompts, lets prefill finish, then runs 20 decode-only
engine steps twice: once timed by the host clock (each step ends in the
sampler's device-to-host copy), once under ``torch.profiler`` to sum the
device time of every kernel. Prints one JSON line: the card, host wall
ms per step, device busy ms per step, the device's idle share, kernel
launches per step, and the kernels that take the most device time.
Needs a CUDA GPU.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

from differential_transformer_replication_tpu_torch.config import (
    ModelConfig,
    ServingConfig,
)
from differential_transformer_replication_tpu_torch.models import init_model
from differential_transformer_replication_tpu_torch.ops import (
    decode_attention as dat,
    fused_ffn as ffn,
    fused_norm_residual as fnr,
)
from differential_transformer_replication_tpu_torch.serving.engine import ServingEngine
from differential_transformer_replication_tpu_torch.serving.scheduler import ACTIVE

WRAPPERS = {"fused_norm": fnr.fused_norm, "fused_add_norm": fnr.fused_add_norm,
            "fused_swiglu": ffn.fused_swiglu,
            "decode_attention": dat.decode_attention}
SLOTS, CONTEXT, STEPS, WARMUP, TOP = 8, 256, 20, 3, 12


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("decode_profile needs a CUDA GPU")
    cfg = ModelConfig(model="diff")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    engine = ServingEngine(
        init_model(gen, cfg), cfg,
        ServingConfig(num_slots=SLOTS, prefill_chunk=128,
                      prefill_budget=SLOTS * CONTEXT),
        device="cuda",
    )
    prompts = torch.randint(0, cfg.vocab_size, (SLOTS, CONTEXT),
                            generator=torch.Generator().manual_seed(0))
    for p in prompts.tolist():
        engine.submit(p, max_new_tokens=WARMUP + 2 * STEPS + 2,
                      temperature=0.0)
    while not all(s.state == ACTIVE for s in engine.scheduler.slots):
        engine.step()
    for _ in range(WARMUP):
        engine.step()
    torch.cuda.synchronize()

    wall = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    for fn in WRAPPERS.values():
        fn.launches = 0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS):
            engine.step()
        torch.cuda.synchronize()
    launches = {k: fn.launches / STEPS for k, fn in WRAPPERS.items()}
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    wall_ms = statistics.median(wall)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    out = {
        "card": _card(),
        "model": cfg.model, "num_slots": SLOTS, "context": CONTEXT,
        "steps": STEPS, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_us / STEPS / 1e3 if busy_us else None,
        "device_idle_share": (1.0 - busy_us / STEPS / 1e3 / wall_ms
                              if busy_us else None),
        "device_kernels_per_step": sum(e.count for e in kernels) / STEPS,
        "wrapper_launches_per_step": launches,
        "top_kernels": [
            {"name": e.key[:80], "ms_per_step": e.self_device_time_total
             / STEPS / 1e3, "calls_per_step": e.count / STEPS}
            for e in top[:TOP]
        ],
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
