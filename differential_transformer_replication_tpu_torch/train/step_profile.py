"""Where a train step of the port spends its time on the GPU.

    python -m differential_transformer_replication_tpu_torch.train.step_profile [--model diff]

Builds the recipe (8 layers, width 768, T = 512, vocab 12000, micro-batch
32, bf16 compute, fp32 params; random weights from seed 0) and runs
train steps on random batches: a few to warm up, then ``STEPS`` timed by
the host clock (each step ends in its metrics' device-to-host copy),
then ``STEPS`` under ``torch.profiler`` to sum the device time of every
kernel. Prints one JSON line: the card, host wall ms per step, tokens
per second, device busy ms per step, the device's idle share, peak
device memory, kernel launches per step of each kernel wrapper, and the
kernels that take the most device time. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from differential_transformer_replication_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
)
from differential_transformer_replication_tpu_torch.ops import (
    flash,
    fused_ffn as ffn,
    fused_norm_residual as fnr,
)
from differential_transformer_replication_tpu_torch.train.step import (
    create_train_state,
    make_train_step,
)

WRAPPERS = {"fused_norm": fnr.fused_norm, "fused_add_norm": fnr.fused_add_norm,
            "fused_swiglu": ffn.fused_swiglu, "swiglu_bwd": ffn.swiglu_bwd,
            "add_norm_bwd": fnr.add_norm_bwd, "flash_tm_fwd": flash.flash_tm_fwd,
            "flash_tm_bwd": flash.flash_tm_bwd}
BATCH, STEPS, WARMUP, TOP = 32, 5, 2, 16


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=("control", "diff", "ndiff"), default="diff")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_profile needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TrainConfig(model=ModelConfig(model=args.model), micro_batch_size=BATCH,
                      warmup_iters=2, learning_rate=1e-3, sampler="replacement")
    mcfg = cfg.resolved_model()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = create_train_state(gen, cfg, "cuda")
    step = make_train_step(cfg)
    T = mcfg.block_size

    def batch():
        idx = torch.randint(0, mcfg.vocab_size, (1, BATCH, T + 1),
                            generator=gen, device="cuda")
        return {"x": idx[..., :-1], "y": idx[..., 1:]}

    for _ in range(WARMUP):
        state, _ = step(state, batch())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall = []
    for _ in range(STEPS):
        b = batch()
        t0 = time.perf_counter()
        state, _ = step(state, b)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()

    for fn in WRAPPERS.values():
        fn.launches = 0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    batches = [batch() for _ in range(STEPS)]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for b in batches:
            state, _ = step(state, b)
        torch.cuda.synchronize()
    launches = {k: fn.launches / STEPS for k, fn in WRAPPERS.items()}
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    wall_ms = statistics.median(wall)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    out = {
        "card": _card(), "model": mcfg.model, "n_layer": mcfg.n_layer,
        "micro_batch": BATCH, "T": T, "steps": STEPS,
        "wall_ms_per_step": wall_ms,
        "tokens_per_s": BATCH * T / wall_ms * 1e3,
        "device_busy_ms_per_step": busy_us / STEPS / 1e3 if busy_us else None,
        "device_idle_share": (1.0 - busy_us / STEPS / 1e3 / wall_ms
                              if busy_us else None),
        "peak_device_memory_gib": peak / 2 ** 30,
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
