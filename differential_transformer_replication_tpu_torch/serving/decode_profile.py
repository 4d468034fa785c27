"""Where a serving decode step of the port spends its time on the GPU.

    python -m differential_transformer_replication_tpu_torch.serving.decode_profile \\
        [--kv-page-size 16] [--kv-cache-dtype int8] \\
        [--spec-mode ngram --spec-verify batched] \\
        [--quality-telemetry] [--trace-path t.json]

Builds the diff model at the reference recipe's widths (random weights
from seed 0, bf16 compute), fills the 8 slots of a ``ServingEngine``
with 256-token prompts, lets prefill finish, then runs 20 decode-only
engine steps twice: once timed by the host clock (each step ends in the
sampler's device-to-host copy), once under ``torch.profiler`` to sum the
device time of every kernel. With the options the steps run through the
paged pool (the paged L=1 step), the int8 cache, or speculative verify
steps (the prompts then repeat an 8-token motif, so the n-gram drafter
proposes for every slot at every step). ``--quality-telemetry`` turns on
the engine's quality tail, ``--trace-path`` its span tracer, so their cost
reads off the same numbers. Prints one JSON line: the card,
the configuration, host wall ms per step, device busy ms per step, the
device's idle share, tokens emitted per step, kernel launches per step,
and the kernels that take the most device time. Needs a CUDA GPU.
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
            "decode_attention": dat.decode_attention,
            "decode_attention_paged": dat.decode_attention_paged,
            "decode_attention_multi": dat.decode_attention_multi,
            "decode_attention_multi_paged": dat.decode_attention_multi_paged}
SLOTS, CONTEXT, STEPS, WARMUP, TOP = 8, 256, 20, 3, 12
MOTIF = 8  # period of the repeating prompts of a spec profile


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def profile(engine: ServingEngine, prompts, steps: int = STEPS,
            warmup: int = WARMUP, top: int = TOP) -> dict:
    """Fill the engine's slots with ``prompts`` (greedy, long enough
    budgets), finish prefill, then time ``steps`` decode-only steps on
    the host clock and profile as many again; returns the measurements."""
    for p in prompts:
        engine.submit(p, max_new_tokens=engine.cfg.block_size - len(p) - 1,
                      temperature=0.0)
    while not all(s.state == ACTIVE for s in engine.scheduler.slots):
        engine.step()
    for _ in range(warmup):
        engine.step()
    torch.cuda.synchronize()
    wall = []
    tok0 = {**engine.stats.snapshot(), **engine.steps}
    for _ in range(steps):
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    tok1 = {**engine.stats.snapshot(), **engine.steps}
    for fn in WRAPPERS.values():
        fn.launches = 0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    wall_ms = statistics.median(wall)
    top_k = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    proposed = tok1["spec_proposed"] - tok0["spec_proposed"]
    return {
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_us / steps / 1e3 if busy_us else None,
        "device_idle_share": (1.0 - busy_us / steps / 1e3 / wall_ms
                              if busy_us else None),
        "tokens_per_step": (tok1["decode_tokens"] - tok0["decode_tokens"]) / steps,
        "verify_steps": tok1["spec_steps"] - tok0["spec_steps"],
        "accept_rate": ((tok1["spec_accepted"] - tok0["spec_accepted"]) / proposed
                        if proposed else None),
        "device_kernels_per_step": sum(e.count for e in kernels) / steps,
        "wrapper_launches_per_step": {k: fn.launches / steps
                                      for k, fn in WRAPPERS.items()},
        "top_kernels": [
            {"name": e.key[:80], "ms_per_step": e.self_device_time_total
             / steps / 1e3, "calls_per_step": e.count / steps}
            for e in top_k[:top]
        ],
    }


def recipe_engine(serving: ServingConfig, tracer=None) -> ServingEngine:
    """The diff recipe (random weights from seed 0) on the card."""
    cfg = ModelConfig(model="diff")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return ServingEngine(init_model(gen, cfg), cfg, serving, device="cuda",
                         tracer=tracer)


def prompts_for(serving: ServingConfig, vocab: int):
    """SLOTS prompts of CONTEXT tokens: random, or a repeated random
    motif per slot when speculation is on."""
    g = torch.Generator().manual_seed(0)
    if not serving.spec_enabled():
        return torch.randint(0, vocab, (SLOTS, CONTEXT), generator=g).tolist()
    motifs = torch.randint(0, vocab, (SLOTS, MOTIF), generator=g)
    return motifs.repeat(1, CONTEXT // MOTIF).tolist()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kv-page-size", type=int, default=0)
    p.add_argument("--kv-cache-dtype", default="", choices=("", "auto", "bf16", "int8"))
    p.add_argument("--spec-mode", default="", choices=("", "ngram"))
    p.add_argument("--spec-draft-len", type=int, default=4)
    p.add_argument("--spec-verify", default="exact", choices=("exact", "batched"))
    p.add_argument("--quality-telemetry", action="store_true")
    p.add_argument("--trace-path", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_profile needs a CUDA GPU")
    serving = ServingConfig(
        num_slots=SLOTS, prefill_chunk=128, prefill_budget=SLOTS * CONTEXT,
        kv_page_size=args.kv_page_size, kv_cache_dtype=args.kv_cache_dtype,
        spec_mode=args.spec_mode, spec_draft_len=args.spec_draft_len,
        spec_verify=args.spec_verify, quality_telemetry=args.quality_telemetry)
    tracer = None
    if args.trace_path:
        from differential_transformer_replication_tpu_torch.obs.spans import (
            SpanTracer,
        )

        tracer = SpanTracer(args.trace_path, process_name="serving-engine")
    engine = recipe_engine(serving, tracer)
    out = {"card": card(), "model": engine.cfg.model, "num_slots": SLOTS,
           "context": CONTEXT, "steps": STEPS,
           "kv_cache_dtype": engine.cfg.kv_cache_dtype,
           "kv_page_size": serving.kv_page_size,
           "spec": (f"{serving.spec_mode} k={serving.spec_draft_len} "
                    f"{serving.spec_verify}" if serving.spec_mode else "off"),
           "quality_telemetry": serving.quality_telemetry,
           "tracing": tracer is not None}
    out.update(profile(engine, prompts_for(serving, engine.cfg.vocab_size)))
    if tracer is not None:
        tracer.close()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
