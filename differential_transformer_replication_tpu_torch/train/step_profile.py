"""Where a train step of the port spends its time on the GPU.

    python -m differential_transformer_replication_tpu_torch.train.step_profile \
        [--model diff] [--block-size 2048 --micro-batch 8 --dropout 0.1] \
        [--remat --remat-policy nothing] [--loss-chunk 2048]

Builds the recipe (8 layers, width 768, T = 512, vocab 12000, micro-batch
32, bf16 compute, fp32 params; random weights from seed 0), or the
context length, micro-batch and dropout given (with remat under the
policy given, and the chunked loss at the chunk given), and runs train
steps on random batches (each with its own dropout seed when dropout >
0): a few to warm up, then ``STEPS`` timed by the host clock (each step
ends in its metrics' device-to-host copy), then ``STEPS`` under
``torch.profiler`` to sum the device time of every kernel. Prints one
JSON line: the card, host wall ms per step, tokens per second, device
busy ms per step, the device's idle share, peak device memory, kernel
launches per step of each kernel wrapper (head-major ones also by
route), the device ms per step of the token-major kernels D and E, and
the kernels that take the most device time. Needs a CUDA
GPU.

``--sequence-parallel P --dist-backend {nccl,gloo}`` profiles the
sequence-parallel step (ring attention over P ranks) under torchrun:

    torchrun --nproc-per-node P -m differential_transformer_replication_tpu_torch.train.step_profile \
        --sequence-parallel P --dist-backend gloo --block-size 8192 --micro-batch 2

Every rank runs the same steps on the same batches; rank 0 is profiled
and prints the line, which adds the ring's exchanges per step: their
count, megabytes and host time (``parallel/ring.py``: with gloo each
exchange stages through host memory). Its device time is rank 0's
kernels only; with ranks sharing one card the wall time is the shared
card's.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import statistics
import subprocess
import time

import torch

from differential_transformer_replication_tpu_torch.config import (
    REMAT_POLICIES,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from differential_transformer_replication_tpu_torch.ops.dropout import fold_seed
from differential_transformer_replication_tpu_torch.ops import (
    flash,
    fused_ffn as ffn,
    fused_norm_residual as fnr,
)
from differential_transformer_replication_tpu_torch.parallel import ring
from differential_transformer_replication_tpu_torch.parallel.mesh import (
    destroy_sequence_group,
    init_sequence_group,
)
from differential_transformer_replication_tpu_torch.train.step import (
    create_train_state,
    make_train_step,
)

WRAPPERS = {"fused_norm": fnr.fused_norm, "fused_add_norm": fnr.fused_add_norm,
            "fused_swiglu": ffn.fused_swiglu, "swiglu_bwd": ffn.swiglu_bwd,
            "add_norm_bwd": fnr.add_norm_bwd, "flash_tm_fwd": flash.flash_tm_fwd,
            "flash_tm_bwd": flash.flash_tm_bwd, "flash_bh_fwd": flash.flash_bh_fwd,
            "flash_bh_bwd_dq": flash.flash_bh_bwd_dq,
            "flash_bh_bwd_dkv": flash.flash_bh_bwd_dkv,
            "flash_bh_bwd_fused": flash.flash_bh_bwd_fused,
            "flash_chunk_fwd": flash.flash_chunk_fwd,
            "flash_chunk_bwd_dq": flash.flash_chunk_bwd_dq,
            "flash_chunk_bwd_dkv": flash.flash_chunk_bwd_dkv}
BATCH, STEPS, WARMUP, TOP = 32, 5, 2, 16


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def profile(model: str = "diff", block_size: int = 512, micro_batch: int = BATCH,
            dropout: float = 0.0, sequence_parallel: int = 1,
            dist_backend: str = "nccl", n_layer: int = 8, remat: bool = False,
            remat_policy: str = "none", loss_chunk=None) -> dict:
    """The breakdown of one train step of this configuration (see the
    module docstring; ``n_layer`` cuts the recipe's depth); returns the
    JSON record (on rank 0; None on the other ranks of a
    sequence-parallel run)."""
    if not torch.cuda.is_available():
        raise SystemExit("step_profile needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    group = (init_sequence_group(dist_backend, "cuda") if sequence_parallel > 1
             else None)
    try:
        return _profile(model, block_size, micro_batch, dropout, sequence_parallel,
                        group, n_layer, remat, remat_policy, loss_chunk)
    finally:
        if group is not None:
            destroy_sequence_group(group)


def _profile(model, block_size, micro_batch, dropout, P, group, n_layer, remat,
             remat_policy, loss_chunk):
    cfg = TrainConfig(model=ModelConfig(model=model, block_size=block_size,
                                        dropout=dropout, n_layer=n_layer,
                                        remat=remat, remat_policy=remat_policy,
                                        loss_chunk=loss_chunk),
                      mesh=MeshConfig(sequence=P),
                      micro_batch_size=micro_batch, warmup_iters=2,
                      learning_rate=1e-3, sampler="replacement")
    mcfg = cfg.resolved_model()
    dev = "cuda" if group is None else group.device
    primary = group is None or group.rank == 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = create_train_state(gen, cfg, dev)
    step = make_train_step(cfg, group)
    T = mcfg.block_size
    seeds = itertools.count()

    def run(b):
        seed = fold_seed(2, next(seeds)) if dropout > 0.0 else None
        return step(state, b, seed)[0]

    def batch():
        idx = torch.randint(0, mcfg.vocab_size, (1, micro_batch, T + 1),
                            generator=gen, device=dev)
        return {"x": idx[..., :-1], "y": idx[..., 1:]}

    for _ in range(WARMUP):
        state = run(batch())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall = []
    for _ in range(STEPS):
        b = batch()
        t0 = time.perf_counter()
        state = run(b)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()

    for fn in WRAPPERS.values():
        fn.launches = 0
    flash.reset_bh_counters()
    ring.reset_rotation_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    batches = [batch() for _ in range(STEPS)]
    torch.cuda.synchronize()
    with (torch.profiler.profile(activities=acts) if primary
          else contextlib.nullcontext()) as prof:
        for b in batches:
            state = run(b)
        torch.cuda.synchronize()
    if not primary:
        return None
    rot = dict(ring.ROTATION)
    launches = {k: fn.launches / STEPS for k, fn in WRAPPERS.items()}
    routes = {k: {r: n / STEPS for r, n in fn.routes.items()}
              for k, fn in WRAPPERS.items() if getattr(fn, "routes", None)}
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    wall_ms = statistics.median(wall)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    sp = {}
    if group is not None:
        sp = {"sequence_parallel": P, "dist_backend": group.backend,
              "rotations_per_step": rot["calls"] / STEPS,
              "rotation_mb_per_step": rot["bytes"] / STEPS / 2 ** 20,
              "rotation_host_ms_per_step": rot["host_s"] / STEPS * 1e3}
    return {
        "card": _card(), "model": mcfg.model, "n_layer": mcfg.n_layer,
        "micro_batch": micro_batch, "T": T, "dropout": dropout,
        "remat": mcfg.remat, "remat_policy": mcfg.remat_policy,
        "loss_chunk": mcfg.loss_chunk, "steps": STEPS,
        **sp,
        "wall_ms_per_step": wall_ms,
        "tokens_per_s": micro_batch * T / wall_ms * 1e3,
        "device_busy_ms_per_step": busy_us / STEPS / 1e3 if busy_us else None,
        "device_idle_share": (1.0 - busy_us / STEPS / 1e3 / wall_ms
                              if busy_us else None),
        "peak_device_memory_gib": peak / 2 ** 30,
        "device_kernels_per_step": sum(e.count for e in kernels) / STEPS,
        # kernels D and E (csrc/flash_tm.cu), all their CUDA kernels
        "tm_attention_ms_per_step": {
            part: sum(e.self_device_time_total for e in kernels
                      if f"tm_{part}" in e.key) / STEPS / 1e3
            for part in ("fwd", "bwd")},
        "wrapper_launches_per_step": launches,
        "head_major_routes_per_step": routes,
        "top_kernels": [
            {"name": e.key[:80], "ms_per_step": e.self_device_time_total
             / STEPS / 1e3, "calls_per_step": e.count / STEPS}
            for e in top[:TOP]
        ],
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=("control", "diff", "ndiff"), default="diff")
    p.add_argument("--block-size", type=int, default=512)
    p.add_argument("--micro-batch", type=int, default=BATCH)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--sequence-parallel", type=int, default=1)
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default="nccl")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--remat-policy", choices=REMAT_POLICIES, default="none")
    p.add_argument("--loss-chunk", type=int, default=None)
    args = p.parse_args(argv)
    rec = profile(args.model, args.block_size, args.micro_batch, args.dropout,
                  args.sequence_parallel, args.dist_backend, remat=args.remat,
                  remat_policy=args.remat_policy, loss_chunk=args.loss_chunk)
    if rec is not None:
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
