#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs
one CUDA card, imports nothing of JAX or of the JAX package, and drives
the port (``differential_transformer_replication_tpu_torch``) through
these phases, each printing its own lines and its seconds:

1. card: the GPU's name and power limit (nvidia-smi), torch/CUDA
   versions, and the build of every kernel from the checkout's sources
   (one ``nvcc`` per CUDA source, all started together, the Triton JIT
   at first use), with the registers and spills ``ptxas -v`` reports for
   the bf16 tensor-core instances of kernels D, E, K1-K4, the decode
   attention's split kernel and the SwiGLU kernels, and for every
   instance of the add+norm backward (none may spill);
2. kernels: each hand-written kernel against its plain PyTorch version
   on the card at the recipe's shapes, fp32 and bf16, with max-abs
   error against a stated bound (the attention kernels row by row, each
   row against its own scale: ``testing.py``), and median times beside
   the plain version, the bound (least time the card could take) and, where one
   exists, a one-call PyTorch equivalent: the serving kernels (add+norm,
   SwiGLU, decode attention) and the training kernels (token-major
   attention forward and backward for the diff, control and ndiff
   recipes, with SDPA's forward and backward at the control shape, both
   by CUDA-graph replay; add+norm backward with and without the carry
   cotangent, each against its own byte bound, on its instance
   (``add_norm_bwd_instance``), two calls bit-equal, its two launches
   split by torch.profiler, ``aten.native_layer_norm_backward`` on saved
   statistics beside the form without the carry as a yardstick; SwiGLU
   backward; add+norm and
   SwiGLU forward also at the training shape M = 16384; the SwiGLU's
   instance at each shape (``swiglu_instance``), cuBLAS computing its
   products alone beside it as a yardstick, the backward's three
   launches by torch.profiler and two backward calls bit-equal); and the
   decode-attention instances of the paged pool, the int8 cache and the
   speculative verify (rows 5-int8, 6, 7, 8) at the recipes' decode
   shapes (8 slots, M 512, pages of 16, 5 verify rows) in fp32, bf16
   and int8, with the paged-vs-contiguous difference on the same
   contents, a batched verify of L 9 rows (two kernel passes) against
   the plain version with every row equal to the single-row call bit for
   bit, the split body and tile length of each shape
   (``decode_instance``), and the split and combine kernels' device
   times (torch.profiler) beside the whole call at L 1 and 5;
   kernels-hm: the head-major attention kernels K1-K4
   (forward; dq; dk/dv; fused backward) with attention dropout 0.1 at
   the train-hm shapes (diff T 2048, diff and control T 512, ndiff T
   512, diff T 8192) in bf16 and at one shape per route in fp32, and at
   S = 5 streams (two passes) in both, each row held to its own scale
   (``testing.py``) and faults planted at T 2048 (in the plain results
   and in K2's and K3's own) shown to fail that bound; then, at dropout
   0 and the control width (S 1), SDPA's forward and backward beside K1
   and the backward of each route (T 512 fused, T 2048 split, T 8192
   tiled), with entries of their own for K1 (T 512,
   T 8192) and K4 (T 512) there, held against their plain versions and
   carrying SDPA's time on the same operands as library_ms (the diff
   entries carry none: no one call computes S streams with dropout);
   bounds from ``testing.attention_work``; kernels-ring: the ring
   chunk's modes of K1 (no combine) and K2/K3 (per-stream cotangents) at
   chunk lengths 2048, 4096 and 8192 (both sides of the 4096 route
   split), causal offsets 0, +Tl, +3Tl and -Tl, bf16 and fp32, dropout
   0 and 0.1, diff/control/ndiff widths, held row by row, then at each
   train-ring run's own shapes and offsets; timed at the ring's shapes
   (diff, B 2, H 4) with the bound of the visible pairs only (and of
   the operands they read), SDPA beside the chunk forward at S 1 and
   dropout 0 (Tl 4096 and 8192; the full chunk an entry of its own);
3. serve: a diff model at recipe width (random weights from a seed)
   behind the port's HTTP ``serve()``, 12 concurrent ``/generate``
   requests, launch counters read around that run, with the engine's
   registry, span tracer, event log, quality telemetry and the SLO
   monitor on: ``/metrics`` against the replies and the engine's stats,
   the trace's spans and traced requests, one received and one finished
   event a request; then the same bodies, submitted in one order,
   through that engine and through one with all of it off: bit-equal
   tokens; serve-paged: the
   same model served (a) paged, int8, prefix cache, n-gram speculation
   with batched verify and (b) contiguous, int8, batched verify — one
   request carrying a 64-token prefix, then 12 concurrent requests of
   which four share it — with prefix hits, draft acceptance, tokens per
   decode step, TTFT of hits and misses and launch counters; (c) as (a)
   with drafts of 8 (9 verify rows a slot) served to completion; greedy
   identity runs (paged vs contiguous, exact spec vs none); and the
   steady-state decode step of ``serving/decode_profile.py`` (wall, device
   busy, idle share) for the contiguous bf16 step, the paged int8 step and
   the paged batched verify step; a chaos wave (the paged exact-verify
   run again, its wave submitted twice, a reject storm, then
   ``prefix_corrupt`` and ``serve_corrupt``): every request served with
   the unfaulted tokens or failed typed, two restarts, no draft accepted
   in the storm; and the contiguous bf16 step with quality telemetry and
   tracing off and on, A B B A;
   serve-tier: KV state that leaves the card, same model, pages of 16:
   (a) the host tier, int8 and bf16 KV: a wave on a shared 256-token
   prefix, a flood that evicts and demotes it, the wave again with its
   prefix promoted back (demotions, promotions and tier hits, the two
   waves' greedy tokens bit-equal), and the page image's bytes and the
   ms to extract and inject one; (b) preemption: six low-priority
   requests (greedy and sampled) preempted by two high-priority ones on
   a short pool, preemptions equal to resumes, the low requests'
   tokens bit-equal to their run without pressure, the high requests'
   TTFT beside a run without the low load; again under batched n-gram
   speculation (rows 6 and 8, tokens reported); (c) migration between
   two port servers in this process: a greedy and a sampled request
   polled on ``A/inflight``, moved by ``POST A/migrate/export``, their
   ``/generate`` answering ``{"code": "migrated"}`` and ``B/migrate/await``
   giving B's own tokens for them bit for bit (int8 and bf16 KV); then
   dedup against a warmed B and ``migrate_corrupt`` (B's typed 409, A
   finishing the request itself), with the blobs' bytes and the export
   and import ms; (d) ``page_demote_fail``, ``page_promote_hang``
   (``DTX_TIER_HANG_S`` 0.2) and ``page_swap_corrupt``: counted
   fallbacks, no crash, every request finished, tokens reported against
   the unfaulted runs; (e) replay by ``key_offset`` 32 on the contiguous
   int8 pool under batched speculation (rows 5 and 7), the first
   difference from the uninterrupted tail reported. Decode-attention
   launches of every run equal the paged formula over its decode and
   verify steps;
   serve-requests: what a request can ask of the server, same model,
   8 slots: (a) the model drafter, contiguous pool, exact verify, 8
   greedy requests of 128 tokens: the target drafting for itself
   (acceptance >= 0.9) and a random 2-layer control model at the
   recipe's width, both bit-equal to the non-spec run, decode-attention
   launches equal to the target's steps plus the drafter's rounds times
   its layers, ``serving_spec_drafter_kv_bytes`` the pool's bytes; both
   on the paged int8 pool under batched verify (first difference
   reported); ``spec_drafter_crash``: one crash, tokens bit-equal; (b)
   int8 weights: target and drafter saved with the port's checkpoint
   writer and served through the CLI parser with ``--quantize-weights
   int8 --spec-drafter-ckpt``, every matmul weight within its channels'
   half steps, the decode step's kernels those of bf16 weights, greedy
   agreement reported; (c) regex, choices and JSON-schema requests over
   HTTP with the smoke corpus's BPE, greedy and sampled, each accepted
   by its FSM, greedy ones equal under model speculation,
   ``constraint_compile_failed`` and ``constraint_dead_end`` answered,
   cache hits; (d) penalties and logprobs beside plain rows in one wave
   (plain rows bit-equal to their wave alone, presence 100 repeating no
   token, top lists sorted with the greedy token first), and
   ``decode_profile``'s step inert (the parent's kernels per step) and
   with the pipeline on every row;
   serve-fleet: the fleet front: two replicas of the port's server (the
   diff recipe, seed-0 weights, 8 slots, pages of 16, prefix cache) on
   this card through ``serving/fleet.py``, the port's router in this
   process: one ``config_hash`` and one greedy reply on both; the
   router's added latency on an idle replica; (a) a rolling restart
   (``pre_drain=router.migrate_out``) and a SIGKILL under 4 client
   threads with no failed reply, every reply attributed and the probe
   prompt's tokens unchanged, with the SIGKILL's ejection, relaunch,
   ready, first-reply and re-admission seconds; (c) gate A on that
   SIGKILL: journaled requests caught mid-decode, every one finished by
   replay (first differences reported); (b) gate B: a drain by
   migration within its budget, the continuations bit-equal to the
   destination alone, its ms against the pages moved; (d) the four router faults in one plan, and
   an admission burst whose sheds carry the controller's clamped
   predicted wait as Retry-After, beside the time the backlog took to
   clear; (e) the control plane (``serving/autoscaler.py``) through a
   router of its own: (e1) the autoscaler polling ``/fleet/metrics``
   and acting through ``FleetActuator`` between 1 and 2 replicas, under
   client load: calm scales down by drain (no launch), a ``scale_flap``
   window moves nothing, pressure scales up by one launch, held pressure
   holds at max_replicas; no failed reply, one up and one down, the
   ``autoscaler_*`` families on the router's ``/metrics``, the record
   replaying to the live decisions byte for byte, each action's signals
   and its decision-to-effect seconds; (e2) a ``canary_regress`` canary
   rolled back by ``CanaryController`` for its burn or p95 regression
   onto its exact previous argv and env, the probe prompt's tokens
   unchanged, no failed reply, with the window's counts, p95 TTFT
   against control and the rollback's seconds; the serving kernels'
   launches in the replicas;
4. e2e: prefill + decode logits of one prompt in fp32 on the card
   (kernels) against the CPU (plain versions); and a 2-layer diff at
   recipe width through the paged pool: paged steps and batched verify
   blocks, card vs CPU;
5. train: the diff recipe at full width and depth, then the control
   recipe, each from a seed-0 init through the trainer's entry point
   (``train.trainer.train``) on a seeded synthetic ``tokens.npy``,
   then a few steps on one repeated batch whose loss must fall; launch
   counters read around each run (the add+norm backward's calls with
   and without the carry counted apart, and every one of them on the
   bf16 warp instance, here, in train-hm and on every train-ring rank);
   train-hm: training through the head-major kernels with attention,
   residual and FFN dropout 0.1 through the trainer: diff at T 2048
   (micro-batch 8, routes resident + split), diff and control at T 512
   (micro-batch 32, fused), diff at T 8192 (micro-batch 2, tiled), all
   8 layers at recipe width; exact launch counts per route and step, a
   falling loss on a repeated batch; then memory for compute: one
   forward+backward of the diff recipe at T 8192 (micro-batch 2, tiled)
   and T 2048 (micro-batch 8, split), dropout 0.1, unremat and under
   each ``remat_policy``, loss and every gradient bit-equal to the
   unremat step's, exact launches per policy (each block's forward
   kernels once more under every policy but ``everything``), peak device
   memory and ms beside the unremat step's; remat ``nothing`` with the
   chunked loss (``loss_chunk`` 2048) at T 8192, and the chunked loss
   alone at T 512 (micro-batch 32, dropout 0), against the dense loss
   within stated bounds, each beside the dense step's peak and ms; then
   ``train/step_profile.py`` of the diff T 512 (fused), T 2048 and T
   8192 dropout steps;
   train-ring: sequence-parallel training through the ring (ring flash
   attention over P ranks, ``parallel/ring.py``): the trainer's command
   line under ``torch.distributed.run`` with ``--dist-backend gloo``, the
   P ranks sharing this card, diff at recipe width, 2 layers, dropout 0.1,
   16,384 tokens per step: P 2 at T 8192 (chunk routes resident +
   split), P 4 at T 8192, P 2 at T 16384 (tiled), control P 2 at T 8192;
   exact launches per route and rank, losses equal on every rank and
   falling on a repeated batch, params bit-identical across ranks; with
   two or more cards the first run again over nccl (else a line says the
   leg was not run); the first run's ranks then run
   ``train/step_profile.py`` over the ring at the runs' depth
   (rank 0: wall, busy, the exchanges' host time);
   train-mesh, tasks of the same two launches (``parallel/dp_step.py``):
   the P = 2 launch runs Ulysses (``--sequence-parallel 2
   --sequence-impl ulysses``) for the diff at T 8192 at the ring runs'
   depth, dropout 0.1, control at ``--tensor-parallel 2`` at that depth,
   T 512, dropout 0.1 (the head-major kernels on 4 of its 8 heads, the
   evals on kernel D), and then, the card its alone, the diff recipe at
   full width and depth (8 layers, T 512, dropout 0, global micro-batch
   32, bf16) at ``--data-parallel 2`` (the overlap path), with
   ``--no-dp-overlap`` (the flat path), at ``--fsdp 2`` and at
   ``--tensor-parallel 2`` (Megatron: 2 of the 4 heads, the SwiGLU at F
   1536, the vocab split; ``parallel/regions.py``) and at
   ``--pipeline-parallel 2`` (GPipe, ``parallel/pipeline.py``: 4 layers a
   stage, the step's 16,384 tokens as 4 microbatches of 8, 3 steps and an
   eval); the P = 4 launch runs ``--data-parallel 2 --sequence-parallel
   2`` and ``--tensor-parallel 2 --sequence-parallel 2`` over the ring at
   T 8192, ``--data-parallel 2 --fsdp 2`` and ``--data-parallel 2
   --tensor-parallel 2`` on the recipe's width at 1 layer,
   ``--pipeline-parallel 4`` at 8 layers and ``--pipeline-parallel 2``
   with ``--data-parallel 2`` and with ``--tensor-parallel 2`` at 2 (the launches
   start before train-e2e and run beside it, train-ckpt and train-full;
   the runs that time the card alone wait for those to end); each with
   exact launches per kernel (or route) and rank (under pipeline per
   stage: its layers' kernels for each microbatch, ln_f on the last stage
   only), losses equal on every rank and falling on a repeated batch,
   params identical on every rank (gathered under tensor, fsdp and
   pipeline, so a tensor line's or a pipeline line's replicated leaves
   are bit-identical), ms per step, tokens/s, the collectives' calls,
   bytes and host time per step (under pipeline also the sends' and
   receives'), and each rank's peak and state at rest (fsdp's and
   tensor's about half of data's, a pipeline stage's its half of the
   blocks and the replicated leaves), beside a one-rank step of the
   recipe; with two or more cards ``--data-parallel 2``,
   ``--tensor-parallel 2`` and ``--pipeline-parallel 2`` again over nccl
   (else a line says the leg was not run);
6. train e2e: one train step of a 2-layer diff model at recipe width in
   fp32, loss and every gradient on the card (kernels) against the CPU
   (plain versions); again at T 640 through the head-major route;
   train-ring-e2e: one fp32 step of a 2-layer diff and control at recipe
   width, T 1024, and of the diff under remat ``nothing`` (the recompute
   runs the ring's exchanges again in the backward), over P 2 and 4 gloo
   ranks on the card against the same single-card head-major step (loss,
   grads, updated params); train-mesh-e2e, beside it: one fp32 diff step
   at ``data=2`` (overlap), ``fsdp=2``, ``data=2, sequence=2``, Ulysses
   ``sequence`` 2 and 4, ``tensor=2``, ``data=2, tensor=2``, ``fsdp=2,
   tensor=2`` and ``tensor=2, sequence=2`` (the ring, and Ulysses), and
   at 4 layers ``pipeline=2``, ``pipeline=4``, ``pipeline=2, data=2``,
   ``pipeline=2, tensor=2`` and ``pipeline=2, sequence=2`` (M microbatches
   a step), against the single-card step of the same global batch
   (micro-batch 2 where the data axes split it; grad-acc M);
7. train-ckpt: the default recipe from text, with checkpoints, through
   the command lines, each in a process of its own (``chip_smoke.py
   --cli-worker``: the trainer's, the server's or the sampler's ``main``
   with the kernel wrappers' counts written out at its end): the diff
   recipe at full width and 2 of its 8 layers, bf16, micro-batch 8 x 48 grad-acc
   steps, built with ``--dataset synthetic --num-train-samples D
   --tokenizer-dir`` (D the first corpus size whose stream, encoded by the
   port's BPE, has an epoch that ends inside the run; the model's vocab
   is the tokenizer's), the epoch sampler, async step checkpoints and an
   eval every N = 6 steps. (a) where the epoch boundary falls; the first
   run builds the corpus cache (its stream equal to the one built in
   this process) and the later runs load it; an uninterrupted 2N-step
   run against one killed by SIGKILL once its step-N checkpoint is
   certified and resumed with ``--resume-from auto`` to 2N: the last
   checkpoints' ``state.msgpack`` bit-equal and every step's loss equal,
   the backward kernels' exact launches in both runs, every checkpoint
   recording the tokenizer's fingerprint; (b) ``sample --temperature 0``
   on the best checkpoint, through generate_cached and through the
   windowed generate (a prompt near 512 tokens plus new tokens past
   it), its text equal to the in-process generators' output decoded by
   the tokenizer, with the decode kernel's and kernel D's launches of
   each run; (c) the server on the best checkpoint with ``--tokenizer``
   answering four greedy token requests and four greedy text requests
   one after another with the in-process engine's tokens on
   ``load_params_for_inference`` of the same directory (text prompts on
   the tokenizer's encoding; the reply's ``text`` its decoding); (d) the
   host's costs: corpus, BPE training, encoding and cache-hit seconds,
   sampling tokens/s of both routes, the checkpoint's MB, the async
   save's seconds, the loop's time in each periodic save and its
   back-pressure, the inline best and last saves, verify and load
   seconds. Its files live in a temporary directory under ``build/``,
   removed at the end. The earlier train phases write their best
   checkpoints to ``build/chip_smoke/best.ckpt`` (the train-ring
   launches, side by side, to ``best-ring-P<P>.ckpt`` each), removed
   likewise.

It then prints the kernels' JSON summary, the card line, and, last,
``{"ok": true, "device": {...}}``. Any failure exits non-zero before
the last line.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

# wall time this module was imported (a serve-fleet replica's interpreter
# start, before ``import torch``)
T_IMPORT = time.time()

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50 * 2**20

RECIPE = dict(model="diff", vocab_size=12000, n_embd=768, n_head=4,
              n_layer=8, block_size=512, dropout=0.0)
TRAIN_B = 32  # the recipe's micro-batch
TRAIN_M = TRAIN_B * RECIPE["block_size"]  # rows of a training activation


def few(long: bool) -> dict:
    """Timing iterations for a kernel of tens of ms: fewer, so the smoke
    stays inside its time limit."""
    return dict(iters=4, reps=5) if long else {}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    """(least time in ms, "bytes" | "operations") on the H100 SXM."""
    name = str(dtype).replace("torch.", "")
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS[name]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def call_ms(calls, iters: int = 20, reps: int = 7) -> float:
    """Median time of one call as the host launches them back to back
    (CUDA events over ``iters`` calls): includes the host's launch cost,
    which bounds small kernels."""
    import torch

    for fn in calls:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            calls[i % len(calls)]()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(calls, iters: int = 20, reps: int = 7) -> float:
    """Median DEVICE time of one call: ``iters`` calls captured once in
    a CUDA graph and replayed, timed by CUDA events, so the host's
    launch cost is out of the number. ``calls`` are closures over
    distinct input buffers, cycled so that together they exceed the L2
    cache (the serving loop finds a layer's weights and cache cold)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def kernel_us(calls, names, n: int = 40) -> dict:
    """Device us per call of the CUDA kernels whose names hold each of
    ``names`` (``torch.profiler`` over ``n`` calls, cycling through
    ``calls``, launched back to back from the host)."""
    import torch

    for fn in calls:
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(n):
            calls[i % len(calls)]()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return {k: sum(e.self_device_time_total for e in evs if k in e.key) / n
            for k in names}


def timings(k_calls, p_calls, lib_calls=None, iters: int = 20,
            reps: int = 7) -> dict:
    """Device and per-call times of a kernel, its plain version and the
    one-call PyTorch equivalent (None where there is none)."""
    out = {"ms": device_ms(k_calls, iters, reps),
           "call_ms": call_ms(k_calls, iters, reps),
           "plain_ms": device_ms(p_calls, iters, reps), "library_ms": None}
    if lib_calls:
        out["library_ms"] = device_ms(lib_calls, iters, reps)
    return out


def fmt_times(t: dict, bms: float, by: str) -> str:
    lib = (f", one-call PyTorch {t['library_ms'] * 1e3:.2f} us"
           if t["library_ms"] is not None else "")
    return (f"device {t['ms'] * 1e3:.2f} us (per call from the host "
            f"{t['call_ms'] * 1e3:.2f} us), plain {t['plain_ms'] * 1e3:.2f} "
            f"us{lib}, bound {bms * 1e3:.3f} us ({by})")


def n_copies(nbytes: int) -> int:
    """How many input sets a timing cycles through so that together
    they exceed the L2 cache."""
    return max(1, min(16, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


class Failure(AssertionError):
    pass


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise Failure(msg)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def bf16_ulp_bound(ref) -> float:
    """One bf16 rounding step at the largest |value|: a kernel and its
    plain version that agree in fp32 differ after the final cast by at
    most this."""
    return 2.0 ** -7 * float(ref.abs().max())


def check_norm(torch, fnr, dtype, M, E, with_delta, gen):
    dev = "cuda"
    es = torch.finfo(dtype).bits // 8
    x = torch.randn(M, E, generator=gen, device=dev).to(dtype)
    d = torch.randn(M, E, generator=gen, device=dev).to(dtype)
    w = 1.0 + 0.1 * torch.randn(E, generator=gen, device=dev)
    b = 0.1 * torch.randn(E, generator=gen, device=dev)
    if with_delta:
        carry, got = fnr.fused_add_norm(x, d, w, b)
        ref_carry, ref = fnr.add_norm_reference(x, d, w, b)
        carry_err = float((carry.float() - ref_carry.float()).abs().max())
        expect(carry_err == 0.0, f"add-norm carry differs: {carry_err}")
    else:
        got = fnr.fused_norm(x, w, b)
        ref = fnr.norm_reference(x, w, b)
    err = float((got.float() - ref.float()).abs().max())
    tol = 1e-5 if dtype == torch.float32 else bf16_ulp_bound(ref.float())
    nbytes = (4 if with_delta else 2) * M * E * es + 2 * E * 4
    flops = 8 * M * E
    return err, tol, nbytes, flops, (x, d, w, b)


def run_kernels(torch, ops) -> dict:
    """Phase 2. Returns {kernel name: json entry sans launches}."""
    fnr, ffn, dat = ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    entries = {}
    tiny = torch.zeros(1, device="cuda")
    floor = call_ms([lambda: tiny.add_(1.0)], iters=200)
    floor_dev = device_ms([lambda: tiny.add_(1.0)], iters=200)
    log(f"[kernels] launch floor (1-element add_): {floor * 1e3:.2f} us per "
        f"call from the host, {floor_dev * 1e3:.2f} us on the device")

    # A: fused residual-add + LayerNorm (Triton)
    for with_delta in (True, False):
        name = "fused_add_norm" if with_delta else "fused_norm"
        for dtype in (torch.float32, torch.bfloat16):
            for M in (8, 128, TRAIN_M):
                E = 768
                err, tol, nbytes, flops, (x, d, w, b) = check_norm(
                    torch, fnr, dtype, M, E, with_delta, gen)
                expect(err <= tol, f"{name} {dtype} ({M},{E}): max-abs "
                       f"{err:.3g} > bound {tol:.3g}")
                sets = [(torch.randn_like(x, dtype=torch.float32).to(dtype),
                         torch.randn_like(d, dtype=torch.float32).to(dtype))
                        for _ in range(n_copies(nbytes))]
                if with_delta:
                    k_calls = [lambda a=a, c=c: fnr.fused_add_norm(a, c, w, b)
                               for a, c in sets]
                    p_calls = [lambda a=a, c=c: fnr.add_norm_reference(a, c, w, b)
                               for a, c in sets]
                    lib_calls = None
                else:
                    k_calls = [lambda a=a: fnr.fused_norm(a, w, b) for a, _ in sets]
                    p_calls = [lambda a=a: fnr.norm_reference(a, w, b)
                               for a, _ in sets]
                    wl, bl = w.to(dtype), b.to(dtype)
                    lib_calls = [lambda a=a: torch.nn.functional.layer_norm(
                        a, (E,), wl, bl, 1e-5) for a, _ in sets]
                t = timings(k_calls, p_calls, lib_calls)
                bms, by = bound_ms(nbytes, flops, dtype)
                log(f"[kernels] {name} {str(dtype)[6:]} ({M},{E}): max-abs "
                    f"{err:.3g} (bound {tol:.3g}); " + fmt_times(t, bms, by))
                if dtype == torch.bfloat16 and M == 8:
                    entries[name] = dict(
                        name=name, route="triton",
                        source="differential_transformer_replication_tpu_torch/ops/fused_norm_residual.py",
                        replaces="differential_transformer_replication_tpu/ops/fused_norm_residual.py:75",
                        max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
                        bound_ms=bms, bound_by=by, library_ms=t["library_ms"])

    # B: fused SwiGLU (CUDA C++) at the row counts the smoke's runs give
    # it, so every instance branch is held against the plain version: the
    # prefill chunks (powers of two up to 128: 1, 16, 32 and 64 take the
    # skinny instance's 8-, 16-, 32- and 64-row branches, 128 one full mma
    # tile), the decode step (8 slots), batched verify of 4 and 8 drafts
    # over 8 slots (40: the 64-row branch, ragged; 72: a ragged mma tile)
    # and the training shape (bf16; fp32 runs the SIMT kernel), beside
    # cuBLAS computing the products alone (x @ [Wg | Wx], a yardstick: no
    # one call computes the function)
    E, F = 768, 3072
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.finfo(dtype).bits // 8
        wbytes = 2 * E * F * es
        wsets = []
        for _ in range(n_copies(wbytes)):
            wsets.append(tuple(
                (0.02 * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)
                for shape in ((E, F), (F,), (E, F), (F,))))
        wg, bg, wx, bx = wsets[0]
        wcats = [torch.cat([w[0], w[2]], dim=1) for w in wsets]
        for M in (1, 8, 16, 32, 40, 64, 72, 128, TRAIN_M):
            x = torch.randn(M, E, generator=gen, device="cuda").to(dtype)
            inst = ffn.swiglu_instance(dtype, M, E, F)
            n0 = ffn.fused_swiglu.instances[inst]
            got = ffn.fused_swiglu(x, wg, bg, wx, bx)
            ref = ffn.swiglu_reference(x, wg, bg, wx, bx)
            err = float((got.float() - ref.float()).abs().max())
            # fp32: accumulation order over E = 768 products
            tol = 5e-5 if dtype == torch.float32 else bf16_ulp_bound(ref.float())
            expect(err <= tol and ffn.fused_swiglu.instances[inst] == n0 + 1,
                   f"fused_swiglu {dtype} M={M} ({inst}): max-abs {err:.3g} "
                   f"(bound {tol:.3g})")
            k_calls = [lambda s=s: ffn.fused_swiglu(x, *s) for s in wsets]
            p_calls = [lambda s=s: ffn.swiglu_reference(x, *s) for s in wsets]
            t = timings(k_calls, p_calls, **few(M == TRAIN_M))
            yard = ""
            if dtype == torch.bfloat16:
                cub = device_ms([lambda c=c: x @ c for c in wcats], **few(M == TRAIN_M))
                yard = (f"; cuBLAS x @ [Wg | Wx] alone {cub * 1e3:.2f} us "
                        "(a yardstick, not the function)")
            nbytes = M * E * es + wbytes + 2 * F * es + M * F * es
            bms, by = bound_ms(nbytes, 4 * M * E * F + 6 * M * F, dtype)
            log(f"[kernels] fused_swiglu {str(dtype)[6:]} M={M} E={E} F={F} "
                f"({inst}): max-abs {err:.3g} (bound {tol:.3g}); "
                + fmt_times(t, bms, by) + yard + "; no one-call PyTorch equivalent")
            name = {8: "fused_swiglu", TRAIN_M: "fused_swiglu_train"}.get(M)
            if dtype == torch.bfloat16 and name:
                entries[name] = dict(
                    name=name, route="cuda",
                    source="differential_transformer_replication_tpu_torch/csrc/fused_swiglu.cu",
                    replaces="differential_transformer_replication_tpu/ops/fused_ffn.py:81",
                    max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=bms, bound_by=by, library_ms=None)

    # C: decode attention (CUDA C++)
    S, B, H, M, d, dv = 2, 8, 4, 512, 96, 192
    pos = torch.tensor([0, 37, 300, 511, 511, 300, 37, 700],
                       dtype=torch.int32, device="cuda")
    lam = torch.tensor([0.2, 0.35, 0.5, 0.7], device="cuda")
    coeffs = torch.stack([torch.ones_like(lam), -lam]).contiguous()
    n_vis = int(torch.clamp(pos + 1, max=M).sum())
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.finfo(dtype).bits // 8
        cache_bytes = (S * d + dv) * B * H * M * es
        sets = []
        for _ in range(n_copies(cache_bytes)):
            sets.append((
                torch.randn(S, B, H, d, generator=gen, device="cuda").to(dtype),
                torch.randn(S, B, H, M, d, generator=gen, device="cuda").to(dtype),
                torch.randn(B, H, M, dv, generator=gen, device="cuda").to(dtype)))
        q, k, v = sets[0]
        got = dat.decode_attention(q, k, v, pos, coeffs)
        ref = dat.decode_attention_reference(q, k, v, pos, coeffs)
        err = float((got.float() - ref.float()).abs().max())
        if dtype == torch.float32:
            tol = 1e-5
        else:
            # per-stream p rounded to bf16 before PV (kernel) vs the
            # combined map rounded once (plain): 2^-8 of sum|c| * max|V|,
            # plus one bf16 step of the output
            tol = (2.0 ** -8 * float(coeffs.abs().sum(0).max())
                   * float(v.float().abs().max()) + bf16_ulp_bound(ref.float()))
        expect(err <= tol, f"decode_attention {dtype}: max-abs {err:.3g} > "
               f"bound {tol:.3g}")
        k_calls = [lambda s=s: dat.decode_attention(*s, pos, coeffs) for s in sets]
        p_calls = [lambda s=s: dat.decode_attention_reference(*s, pos, coeffs)
                   for s in sets]
        t = timings(k_calls, p_calls)
        # bytes this run's data needs: only visible keys are read
        nbytes = (S * B * H * d * es + n_vis * H * (S * d + dv) * es
                  + B * 4 + S * H * 4 + B * H * dv * es)
        flops = n_vis * H * (2 * S * d + 2 * S * dv + 5 * S)
        bms, by = bound_ms(nbytes, flops, dtype)
        log(f"[kernels] decode_attention {str(dtype)[6:]} S={S} B={B} H={H} "
            f"M={M} d={d} dv={dv} pos={pos.tolist()}: max-abs {err:.3g} "
            f"(bound {tol:.3g}); " + fmt_times(t, bms, by)
            + "; no one-call PyTorch equivalent (multi-stream combine)")
        if dtype == torch.bfloat16:
            entries["decode_attention"] = dict(
                name="decode_attention", route="cuda",
                source="differential_transformer_replication_tpu_torch/csrc/decode_attention.cu",
                replaces="differential_transformer_replication_tpu/ops/decode_attention.py:102",
                max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=bms, bound_by=by, library_ms=None)
    return entries


# ---------------------------------------------------------------------------
# phase 2, continued: the decode-attention instances of rows 5-int8, 6, 7, 8
# ---------------------------------------------------------------------------

DEC_B, DEC_M, DEC_PS, DEC_L = 8, 512, 16, 5
# (name, S, H, d, dv): the recipes' decode shapes
DEC_CONFIGS = (("diff", 2, 4, 96, 192), ("control", 1, 8, 96, 96),
               ("ndiff", 4, 4, 96, 192))
# the JSON line's entries (int8 storage): name -> TPU kernel body line
DEC_ENTRIES = {"decode_attention_int8": 102, "decode_attention_paged": 268,
               "decode_attention_multi": 428, "decode_attention_multi_paged": 613}


def paged_copy(torch, t, tab, ps: int, axis: int, n_pages: int, gen):
    """A paged pool holding the slots of the contiguous leaf ``t`` (batch
    axis ``axis``) behind ``tab``; the other pages, the trash page 0
    included, hold garbage a correct kernel never reads."""
    shape = list(t.shape)
    shape[axis], shape[axis + 2] = n_pages, ps
    if t.dtype == torch.int8:
        out = torch.randint(-127, 128, shape, generator=gen, device="cuda").to(torch.int8)
    else:
        out = torch.rand(*shape, generator=gen, device="cuda").to(t.dtype)
    B, pp = tab.shape
    for b in range(B):
        for j in range(pp):
            out.select(axis, int(tab[b, j])).copy_(
                t.select(axis, b).narrow(axis + 1, j * ps, ps))
    return out


def dec_operands(torch, dat, gen, S, H, d, dv, store, R):
    """A contiguous cache of R rows and the same B slots in a paged pool
    behind a scrambled table: {"kc", "vc", "kp", "vp", "tab", "cs", "ps"}
    where cs/ps are the scale keywords (empty for float storage), and the
    first B rows as contiguous tensors ("kc1", "vc1", "cs1")."""
    dtype = torch.float32 if store == "fp32" else torch.bfloat16
    kc = torch.randn(S, R, H, DEC_M, d, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(R, H, DEC_M, dv, generator=gen, device="cuda").to(dtype)
    pp = DEC_M // DEC_PS
    P = 1 + DEC_B * pp + 7
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(S))
    tab = (1 + perm[:DEC_B * pp]).reshape(DEC_B, pp).to(torch.int32).cuda()
    cs, ps = {}, {}
    if store == "int8":
        (kc, ks), (vc, vs) = dat.quantize_kv(kc), dat.quantize_kv(vc)
        cs = {"k_scale": ks, "v_scale": vs}
        ps = {"k_scale": paged_copy(torch, ks[:, :DEC_B].unsqueeze(-1), tab, DEC_PS,
                                    1, P, gen).squeeze(-1),
              "v_scale": paged_copy(torch, vs[:DEC_B].unsqueeze(-1), tab, DEC_PS,
                                    0, P, gen).squeeze(-1)}
    kp = paged_copy(torch, kc[:, :DEC_B], tab, DEC_PS, 1, P, gen)
    vp = paged_copy(torch, vc[:DEC_B], tab, DEC_PS, 0, P, gen)
    # the single-row contiguous instance takes exactly B cache rows
    cs1 = {k: (v[:, :DEC_B] if k == "k_scale" else v[:DEC_B]).contiguous()
           for k, v in cs.items()}
    return dict(kc=kc, vc=vc, kp=kp, vp=vp, tab=tab, cs=cs, ps=ps,
                kc1=kc[:, :DEC_B].contiguous(), vc1=vc[:DEC_B].contiguous(), cs1=cs1)


def run_decode_kernels(torch, dat) -> dict:
    """Rows 5 (float, already timed above, and int8), 6, 7 and 8 at the
    recipes' decode shapes (B = 8 slots, M = 512, pages of 16, L = 5
    verify rows), fp32, bf16 and int8 K/V with bf16 queries: each
    instance against its plain version, the paged instances against the
    contiguous ones on the same contents, device times by CUDA-graph
    replay beside the plain version and the bound; SDPA with a boolean
    mask at the control shape (S = 1) for rows 5 and 7."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    entries = {}
    base = torch.tensor([0, 37, 300, 506, 506, 300, 37, 150], dtype=torch.int32,
                        device="cuda")
    pos_l = (base[:, None] + torch.arange(DEC_L, device="cuda",
                                          dtype=torch.int32)).contiguous()
    pos_1 = pos_l[:, 0].contiguous()
    n_vis = [int(v) for v in torch.clamp(pos_l + 1, max=DEC_M).sum(0)]
    for name, S, H, d, dv in DEC_CONFIGS:
        c = torch.randn(S, H, generator=gen, device="cuda") * 0.5
        c[0] = 1.0
        for store in ("fp32", "bf16", "int8"):
            qdt = torch.float32 if store == "fp32" else torch.bfloat16
            es = 1 if store == "int8" else torch.finfo(qdt).bits // 8
            cache_bytes = (S * d + dv) * (DEC_B + 1) * H * DEC_M * es
            sets = [dec_operands(torch, dat, gen, S, H, d, dv, store, DEC_B + 1)
                    for _ in range(n_copies(cache_bytes))]
            q_l = torch.randn(S, DEC_B, DEC_L, H, d, generator=gen, device="cuda").to(qdt)
            q_1 = q_l[:, :, 0].contiguous()
            # each instance: (kernel call, plain call, K/V rows it reads)
            fns = {
                "decode_attention": (
                    lambda s: dat.decode_attention(q_1, s["kc1"], s["vc1"], pos_1, c,
                                                   **s["cs1"]),
                    lambda s: dat.decode_attention_reference(
                        q_1, s["kc1"], s["vc1"], pos_1, c, **s["cs1"]), 1),
                "decode_attention_paged": (
                    lambda s: dat.decode_attention_paged(q_1, s["kp"], s["vp"], s["tab"],
                                                         pos_1, c, **s["ps"]),
                    lambda s: dat.decode_attention_paged_reference(
                        q_1, s["kp"], s["vp"], s["tab"], pos_1, c, **s["ps"]), 1),
                "decode_attention_multi": (
                    lambda s: dat.decode_attention_multi(q_l, s["kc"], s["vc"], pos_l, c,
                                                         **s["cs"]),
                    lambda s: dat.decode_attention_multi_reference(
                        q_l, s["kc"], s["vc"], pos_l, c, **s["cs"]), DEC_L),
                "decode_attention_multi_paged": (
                    lambda s: dat.decode_attention_multi_paged(
                        q_l, s["kp"], s["vp"], s["tab"], pos_l, c, **s["ps"]),
                    lambda s: dat.decode_attention_multi_paged_reference(
                        q_l, s["kp"], s["vp"], s["tab"], pos_l, c, **s["ps"]), DEC_L),
            }
            o = sets[0]
            outs = {k: (kf(o), pf(o)) for k, (kf, pf, _) in fns.items()}
            vmax = (float(o["vc"].float().abs().max()) if store != "int8"
                    else float(o["cs"]["v_scale"].max()) * 127.0)
            if store == "fp32":
                tol = 1e-5
            else:  # as row 5's bf16 bound, over the (dequantized) V
                tol = (2.0 ** -8 * float(c.abs().sum(0).max()) * vmax
                       + bf16_ulp_bound(outs["decode_attention_multi"][1].float()))
            errs = {k: max_err(*v) for k, v in outs.items()}
            for k, e in errs.items():
                expect(e <= tol, f"{k} {name} {store}: max-abs {e:.3g} > bound {tol:.3g}")
            paged_diff = max(
                max_err(outs["decode_attention"][0], outs["decode_attention_paged"][0]),
                max_err(outs["decode_attention_multi"][0],
                        outs["decode_attention_multi_paged"][0]))
            rows_diff = max_err(outs["decode_attention_multi"][0][:, 0],
                                outs["decode_attention"][0])
            # batched verify past one kernel pass: L = 9 rows (passes of 8
            # and 1) against the plain version, paged equal to contiguous,
            # and row l equal to the single-row call at pos[:, l], bit for bit
            pos_9 = (base[:, None] + torch.arange(9, device="cuda",
                                                  dtype=torch.int32)).contiguous()
            q_9 = torch.randn(S, DEC_B, 9, H, d, generator=gen, device="cuda").to(qdt)
            m9 = dat.decode_attention_multi(q_9, o["kc"], o["vc"], pos_9, c, **o["cs"])
            r9 = dat.decode_attention_multi_reference(q_9, o["kc"], o["vc"], pos_9, c,
                                                      **o["cs"])
            p9 = dat.decode_attention_multi_paged(q_9, o["kp"], o["vp"], o["tab"], pos_9,
                                                  c, **o["ps"])
            tol9 = tol if store == "fp32" else (
                tol - bf16_ulp_bound(outs["decode_attention_multi"][1].float())
                + bf16_ulp_bound(r9.float()))
            rows9 = all(torch.equal(m9[:, l], dat.decode_attention(
                q_9[:, :, l].contiguous(), o["kc1"], o["vc1"], pos_9[:, l].contiguous(), c,
                **o["cs1"])) for l in range(9))
            err9 = max_err(m9, r9)
            expect(err9 <= tol9 and torch.equal(m9, p9) and rows9,
                   f"decode_attention_multi {name} {store} L=9: max-abs {err9:.3g} "
                   f"(bound {tol9:.3g}), paged equal {torch.equal(m9, p9)}, rows "
                   f"equal to single-row calls {rows9}")
            inst = {L: dat.decode_instance(qdt, S, L, d, dv) for L in (1, DEC_L, 9)}
            log(f"[kernels] decode {name} {store} S={S} B={DEC_B} H={H} M={DEC_M} "
                f"d={d} dv={dv} pages of {DEC_PS}, L={DEC_L}: max-abs vs plain "
                + ", ".join(f"{k[17:] or 'contiguous'} {e:.3g}" for k, e in errs.items())
                + f" (bound {tol:.3g}); paged vs contiguous on the same contents "
                f"{paged_diff:.3g}; multi row 0 vs single row {rows_diff:.3g}; L 9 "
                f"(two passes) max-abs {err9:.3g} (bound {tol9:.3g}), paged and every "
                "row equal to the single-row calls bit for bit; "
                + "; ".join(f"L {L}: split body {r}, {tk}-key tiles"
                            for L, (r, tk) in inst.items()))
            if store == "fp32":
                continue
            # bytes: each visible key's K/V (and scales) read once for all
            # rows, queries, outputs and page tables; flops per row
            per_key = H * ((S * d + dv) * es + ((S + 1) * 4 if store == "int8" else 0))
            vis = {1: int(torch.clamp(pos_1 + 1, max=DEC_M).sum()),
                   DEC_L: int(torch.clamp(pos_l.max(1).values + 1, max=DEC_M).sum())}
            rows_keys = {1: vis[1], DEC_L: sum(n_vis)}
            calls = {}
            for k, (kf, pf, L) in fns.items():
                nbytes = (vis[L] * per_key + S * DEC_B * L * H * d * 2
                          + DEC_B * L * H * dv * 2
                          + (DEC_B * (DEC_M // DEC_PS) * 4 if "paged" in k else 0))
                flops = rows_keys[L] * H * (2 * S * d + 2 * S * dv + 5 * S)
                calls[k] = ([lambda s=s, kf=kf: kf(s) for s in sets],
                            [lambda s=s, pf=pf: pf(s) for s in sets], nbytes, flops)
            for k, (k_calls, p_calls, nbytes, flops) in calls.items():
                lib = None
                if S == 1 and store == "bf16" and k in ("decode_attention",
                                                        "decode_attention_multi"):
                    # one causal stream: SDPA with a boolean visibility mask
                    L = 1 if k == "decode_attention" else DEC_L
                    qt = q_l[0, :, :L].transpose(1, 2)  # (B, H, L, d)
                    kt, vt = o["kc"][0, :DEC_B], o["vc"][:DEC_B]
                    mask = (torch.arange(DEC_M, device="cuda")[None, None, :]
                            <= pos_l[:, :L, None])[:, None]
                    lib = [lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask)]
                t = timings(k_calls, p_calls, lib)
                bms, by = bound_ms(nbytes, flops, torch.bfloat16)
                parts = ""
                if k in ("decode_attention", "decode_attention_multi"):
                    # the two device launches of a call (L 1 and DEC_L)
                    us = kernel_us(k_calls, ("dattn_split", "dattn_combine"))
                    parts = (f"; split kernel {us['dattn_split']:.2f} us, combine "
                             f"{us['dattn_combine']:.2f} us a call (torch.profiler, "
                             "launched from the host; the combine starts early and "
                             "its time holds its wait for the split)")
                log(f"[kernels] {k} {name} {store}: " + fmt_times(t, bms, by) + parts
                    + ("; one-call PyTorch is SDPA with a boolean mask" if lib else ""))
                key = k + ("_int8" if k == "decode_attention" else "")
                if name == "diff" and store == "int8" and key in DEC_ENTRIES:
                    entries[key] = dict(
                        name=key, route="cuda",
                        source=SRC + "csrc/decode_attention.cu",
                        replaces=f"{TPU}decode_attention.py:{DEC_ENTRIES[key]}",
                        max_abs_err=errs[k], ms=t["ms"], plain_ms=t["plain_ms"],
                        bound_ms=bms, bound_by=by, library_ms=None)
            del sets, o, outs
        torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# phase 3: serve the diff recipe through the HTTP front-end
# ---------------------------------------------------------------------------

PROMPT_LENS = (17, 45, 80, 123, 160, 200, 237, 280, 311, 350, 377, 400)
NEW_TOKENS = 64


def _post(url: str, body: dict) -> tuple:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.load(r)


def _snap(engine) -> dict:
    """The engine's counters and its step counts (prefill chunks, decode
    and verify steps: what the launch formulas multiply)."""
    return {**engine.stats.snapshot(), **engine.steps}


def _counters():
    from differential_transformer_replication_tpu_torch.ops import (
        decode_attention as dat,
        fused_ffn as ffn,
        fused_norm_residual as fnr,
    )

    return {"fused_add_norm": fnr.fused_add_norm, "fused_norm": fnr.fused_norm,
            "fused_swiglu": ffn.fused_swiglu,
            "decode_attention": dat.decode_attention}


SPAN_NAMES = {"schedule", "prefill", "decode", "sample", "emit"}
TRACED = (0, 5, 9)  # requests that send a traceparent


def _traceparent(i: int) -> str:
    return f"00-{i + 1:032x}-{i + 1:016x}-01"


def _metrics(url: str) -> dict:
    """GET /metrics parsed: {(name, sorted label items): value}."""
    from differential_transformer_replication_tpu_torch.obs.registry import (
        parse_exposition,
    )

    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        body = r.read().decode()
    _, samples = parse_exposition(body)
    return {(n, tuple(sorted(lab.items()))): v for n, lab, v in samples}


def check_serve_telemetry(cfg, vals: dict, st: dict, bodies, replies,
                          trace_path, events_path) -> None:
    """The telemetry of the served run: the /metrics scrape ``vals``
    against the engine's stats ``st`` and the replies, then the closed
    span trace and event log."""
    n_req = len(bodies) + 1  # the wave and the repeat
    expect(vals[("serving_ttft_seconds_count", ())] == n_req,
           f"serving_ttft_seconds count {vals[('serving_ttft_seconds_count', ())]}"
           f" != {n_req} requests")
    expect(vals[("serving_decode_tokens_total", ())] == st["decode_tokens"],
           "serving_decode_tokens_total disagrees with stats")
    expect(vals[("serving_token_entropy_count", ())] == NEW_TOKENS * n_req,
           f"serving_token_entropy count {vals[('serving_token_entropy_count', ())]}"
           f" != {NEW_TOKENS * n_req} tokens emitted")
    lam = sorted(k[1][0][1] for k in vals if k[0] == "serving_lambda_mean")
    expect(len(lam) == cfg.n_layer, f"serving_lambda_mean series {lam}")
    slo = {k[0] for k in vals if k[0].startswith("slo_")}
    expect({"slo_target", "slo_burn_rate", "slo_error_ratio"} <= slo,
           f"slo gauges {sorted(slo)}")
    for (_, reply), i in zip(replies, range(len(bodies))):
        expect(reply["quality"]["tokens_observed"] == NEW_TOKENS,
               f"request {i}: quality {reply.get('quality')}")
        if i in TRACED:
            expect(reply["trace_id"] == _traceparent(i)[3:35],
                   f"request {i} answered trace id {reply['trace_id']}")
    trace = json.load(open(trace_path))  # valid Chrome trace JSON
    names = {e["name"] for e in trace}
    expect(SPAN_NAMES <= names, f"span names {sorted(names)}")
    for i in TRACED:
        tid = _traceparent(i)[3:35]
        mine = {e["name"] for e in trace if e.get("args", {}).get("trace_id") == tid}
        expect({"admit", "first_token", "finish", "request"} <= mine,
               f"request {i}: trace events {sorted(mine)}")
    lines = [json.loads(x) for x in open(events_path)]
    got = {ev: sum(1 for r in lines if r["event"] == ev)
           for ev in ("request_received", "request_finished")}
    expect(got == {"request_received": n_req, "request_finished": n_req},
           f"event log {got} for {n_req} requests")
    log(f"[serve] telemetry: /metrics ttft count {n_req}, "
        f"{int(vals[('serving_token_entropy_count', ())])} entropy observations, "
        f"lambda_mean layers {lam}, slo burn ttft "
        f"{vals.get(('slo_burn_rate', (('objective', 'ttft'),)))}; trace "
        f"{len(trace)} events; event log {got}")


def run_serve(torch, card: str) -> dict:
    """Phase 3. Returns the launch count of each kernel wrapper over the
    served run. The engine runs with its registry, a span tracer, an
    event log and quality telemetry on, the server with the SLO monitor;
    then the greedy bodies run again through an engine with all of it
    off, and must give the same tokens."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from differential_transformer_replication_tpu_torch.config import (
        ModelConfig,
        ServingConfig,
    )
    from differential_transformer_replication_tpu_torch.models import (
        init_model,
        param_count,
    )
    from differential_transformer_replication_tpu_torch.obs.events import EventLog
    from differential_transformer_replication_tpu_torch.obs.slo import (
        SLOMonitor,
        default_serving_objectives,
    )
    from differential_transformer_replication_tpu_torch.obs.spans import SpanTracer
    from differential_transformer_replication_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from differential_transformer_replication_tpu_torch.serving.request import (
        SamplingParams,
    )
    from differential_transformer_replication_tpu_torch.serving.server import (
        ServingClient,
        serve,
    )

    cfg = ModelConfig(**RECIPE, compute_dtype="bfloat16", param_dtype="float32")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_model(gen, cfg)
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    trace_path, events_path = out_dir / "serve.trace.json", out_dir / "serve.events.jsonl"
    events_path.unlink(missing_ok=True)
    tracer = SpanTracer(str(trace_path), process_name="serving-engine")
    events = EventLog(str(events_path), process="replica")
    torch.cuda.reset_peak_memory_stats()
    serving = dict(num_slots=8, prefill_chunk=128, prefill_budget=256)
    engine = ServingEngine(
        params, cfg, ServingConfig(**serving, quality_telemetry=True),
        device="cuda", tracer=tracer,
    )
    log(f"[serve] diff recipe: {cfg.n_layer} layers, width {cfg.n_embd}, "
        f"{cfg.n_head} heads (d {cfg.head_size}, dv {cfg.value_size}), block "
        f"{cfg.block_size}, vocab {cfg.vocab_size}, bf16 compute, "
        f"{param_count(engine.params) / 1e6:.1f} M params; KV pool "
        f"{sum(t.numel() * t.element_size() for c in engine.cache for t in c.values()) / 1e6:.1f} MB"
        "; registry, span tracer, event log, quality telemetry and SLOs on")
    client = ServingClient(engine)
    slo = SLOMonitor(engine.registry, *default_serving_objectives())
    httpd = serve(client, port=0, events=events, slo=slo)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    rng = np.random.default_rng(0)
    bodies = []
    for i, n in enumerate(PROMPT_LENS):
        body = {"prompt_ids": rng.integers(0, cfg.vocab_size, n).tolist(),
                "max_new_tokens": NEW_TOKENS, "temperature": 0.0}
        if i in (3, 8):  # two sampled requests
            body.update(temperature=0.8, top_k=50, seed=100 + i)
        if i in TRACED:
            body["traceparent"] = _traceparent(i)
        bodies.append(body)
    try:
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        counters["fused_swiglu"].instances.clear()
        stats0 = _snap(engine)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as pool:
            replies = list(pool.map(lambda b: _post(url + "/generate", b), bodies))
        wall = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in counters.items()}
        instances = dict(counters["fused_swiglu"].instances)
        stats1 = _snap(engine)
        for (status, reply), body in zip(replies, bodies):
            expect(status == 200, f"/generate answered {status}: {reply}")
            expect(len(reply["tokens"]) == NEW_TOKENS
                   and reply["finish_reason"] == "length",
                   f"reply has {len(reply['tokens'])} tokens, "
                   f"{reply['finish_reason']}")
            expect(all(0 <= t < cfg.vocab_size for t in reply["tokens"]),
                   "token id out of range")
            expect(reply["prompt_ids"] == body["prompt_ids"], "prompt echo")
        steps = stats1["decode_steps"] - stats0["decode_steps"]
        chunks = stats1["prefill_chunks"] - stats0["prefill_chunks"]
        L = cfg.n_layer
        # telemetry launches none of these kernels: the formula is the
        # one of a run without it
        expected = {"fused_norm": (2 * L + 1) * (steps + chunks),
                    "fused_add_norm": L * (steps + chunks),
                    "fused_swiglu": L * (steps + chunks),
                    "decode_attention": L * steps}
        log(f"[serve] {len(bodies)} requests, {steps} decode steps, {chunks} "
            f"prefill chunks; launches {counts} (expected {expected}); "
            f"fused_swiglu instances {instances}")
        # the decode steps (8 rows) run the skinny instance
        expect(instances.get("skinny", 0) >= L * steps
               and sum(instances.values()) == counts["fused_swiglu"],
               f"fused_swiglu instances {instances}")
        for name, n in expected.items():
            expect(counts[name] == n and n > 0,
                   f"{name} launched {counts[name]} times, expected {n}")
        # greedy replies are deterministic: the same request again
        status, again = _post(url + "/generate", bodies[0])
        expect(again["tokens"] == replies[0][1]["tokens"],
               "greedy reply changed on a repeat")
        health = json.load(urllib.request.urlopen(url + "/health", timeout=60))
        expect(health["ok"] and health["stats"]["completed"] >= len(bodies) + 1,
               f"/health: {health}")
        t_tel = time.perf_counter()
        vals, st = _metrics(url), engine.stats.snapshot()
    finally:
        httpd.shutdown()
        httpd.server_close()
        client.close()
        server.join(timeout=30)
        tracer.close()
        events.close()
    check_serve_telemetry(cfg, vals, st, bodies, replies, trace_path, events_path)
    # telemetry must not move a token: every body again, submitted in
    # one order (so both runs share one schedule of prefill chunks and
    # batches), through the telemetry engine and through an engine on the
    # same params with all of it off
    plain = ServingEngine(params, cfg, ServingConfig(**serving), device="cuda")
    del params
    sps = [SamplingParams(max_new_tokens=NEW_TOKENS, temperature=b["temperature"],
                          top_k=b.get("top_k"), seed=b.get("seed", 0)) for b in bodies]
    prompts = [b["prompt_ids"] for b in bodies]
    on = [o.tokens for o in engine.generate(prompts, sps)]
    off = [o.tokens for o in plain.generate(prompts, sps)]
    greedy = [i for i, b in enumerate(bodies) if b["temperature"] == 0.0]
    diff = first_difference(on, off)
    served = first_difference([replies[i][1]["tokens"] for i in greedy],
                              [off[i] for i in greedy])
    log(f"[serve] telemetry on vs off, same params and schedule: "
        f"{len(bodies)} bodies ({len(greedy)} greedy) "
        f"{'bit-equal' if diff is None else f'differ at {diff}'}; the served "
        f"greedy replies vs off: {'equal' if served is None else f'differ at {served}'}"
        f" (reported: the served batches and prefill chunks differ); telemetry "
        f"checks and the reruns took {time.perf_counter() - t_tel:.1f} s")
    expect(diff is None, f"tokens with telemetry off differ at {diff}")
    del plain
    torch.cuda.empty_cache()
    ttft = sorted(r["ttft_ms"] for _, r in replies)
    p50 = statistics.median(ttft)
    p95 = ttft[min(len(ttft) - 1, math.ceil(0.95 * len(ttft)) - 1)]
    out_tok = NEW_TOKENS * len(bodies)
    log(f"[serve] TTFT p50 {p50:.1f} ms, p95 {p95:.1f} ms; {out_tok} output "
        f"tokens in {wall:.2f} s = {out_tok / wall:.1f} tok/s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
    return counts


# ---------------------------------------------------------------------------
# phase 3b: serve the diff recipe through the paged pool, the prefix
# cache, the int8 cache and speculative verify
# ---------------------------------------------------------------------------

SHARED = 64   # tokens of the prefix four requests share
HITS = (1, 4, 7, 10)       # wave-2 requests on the shared prefix
MOTIFS = (2, 5, 8, 11)     # wave-2 requests repeating a short motif
SAMPLED = (3, 9)           # wave-2 requests that sample
PAGED_COUNTERS = ("decode_attention", "decode_attention_paged",
                  "decode_attention_multi", "decode_attention_multi_paged")


def paged_bodies(vocab: int):
    """Wave 1: one greedy request carrying the shared prefix, served
    alone so that its prompt pages are cached (and its first decode
    step, with no draft yet, runs the L=1 kernel). Wave 2: 12 concurrent
    requests; hit prompts are the prefix plus < 64 tokens, so their
    prefill chunks line up with the contiguous pool's (a 64-token chunk
    first) and the pools' outputs can be compared bit for bit."""
    import numpy as np

    rng = np.random.default_rng(7)
    shared = rng.integers(0, vocab, SHARED).tolist()
    donor = {"prompt_ids": shared + rng.integers(0, vocab, 16).tolist(),
             "max_new_tokens": 16, "temperature": 0.0}
    wave = []
    for i in range(12):
        if i in HITS:
            p = shared + rng.integers(0, vocab, 8 + 12 * HITS.index(i)).tolist()
        elif i in MOTIFS:
            motif = rng.integers(0, vocab, 3 + i % 4).tolist()
            p = (motif * 64)[:40 + 10 * i]
        else:
            p = rng.integers(0, vocab, 30 + 25 * i).tolist()
        body = {"prompt_ids": p, "max_new_tokens": NEW_TOKENS, "temperature": 0.0}
        if i in SAMPLED:
            body.update(temperature=0.8, top_k=50, seed=100 + i)
        wave.append(body)
    return donor, wave


def serve_waves(torch, params, cfg, serving, donor, wave) -> dict:
    """One engine behind ``serve()``: the donor alone, then the wave
    concurrently; launch counters set to 0 just before and read just
    after; the engine's stats, /health and the replies."""
    from concurrent.futures import ThreadPoolExecutor

    from differential_transformer_replication_tpu_torch.ops import (
        decode_attention as dat,
    )
    from differential_transformer_replication_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from differential_transformer_replication_tpu_torch.serving.server import (
        ServingClient,
        serve,
    )

    engine = ServingEngine(params, cfg, serving, device="cuda")
    client = ServingClient(engine)
    httpd = serve(client, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        counters = {k: getattr(dat, k) for k in PAGED_COUNTERS}
        for fn in counters.values():
            fn.launches = fn.int8_launches = 0
        torch.cuda.synchronize()
        status, first = _post(url + "/generate", donor)
        expect(status == 200, f"/generate answered {status}: {first}")
        stats0 = _snap(engine)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(wave)) as pool:
            replies = list(pool.map(lambda b: _post(url + "/generate", b), wave))
        wall = time.perf_counter() - t0
        counts = {k: (fn.launches, fn.int8_launches) for k, fn in counters.items()}
        stats1 = _snap(engine)
        health = json.load(urllib.request.urlopen(url + "/health", timeout=60))
    finally:
        httpd.shutdown()
        httpd.server_close()
        client.close()
        server.join(timeout=30)
    for (status, reply), body in zip(replies, wave):
        expect(status == 200 and len(reply["tokens"]) == NEW_TOKENS
               and reply["prompt_ids"] == body["prompt_ids"]
               and all(0 <= t < cfg.vocab_size for t in reply["tokens"]),
               f"/generate answered {status}: {reply}")
    return dict(first=first, replies=[r for _, r in replies], counts=counts,
                stats0=stats0, stats1=stats1, health=health, wall=wall)


STORM = (14, 113)  # the reject storm's first and last wave iteration


def would_accept(draft: list, want: list, g: int) -> int:
    """Drafts the exact verify accepts when its greedy tokens are
    ``want``: the length of the draft's common prefix with ``want[g:]``."""
    n = 0
    while n < len(draft) and g + n < len(want) and draft[n] == want[g + n]:
        n += 1
    return n


def serve_chaos(torch, params, cfg, serving, donor, wave, want) -> dict:
    """The paged exact-verify run again with faults armed over one wave, the wave
    submitted twice so that requests queue behind the crashes:
    ``prefix_corrupt`` at wave iteration 7 (a hit slot reads the donor's
    cached pages), ``serve_corrupt`` at 12, and a reject storm over
    iterations STORM, counted from the wave's first iteration. Every
    request must finish with the unfaulted run's tokens ``want``
    (greedy) or fail typed; the engine restarts once a crash-class
    fault. During the storm no draft is accepted, and at least one of
    the storm's drafts must be one that the exact verify accepts without
    it (its greedy tokens are ``want``), so a storm that never fired
    cannot pass."""
    from differential_transformer_replication_tpu_torch.obs.registry import (
        parse_exposition,
    )
    from differential_transformer_replication_tpu_torch.serving.engine import (
        EngineCrashError,
        ServingEngine,
    )
    from differential_transformer_replication_tpu_torch.serving.server import (
        ServingClient,
    )
    from differential_transformer_replication_tpu_torch.utils import faults

    engine = ServingEngine(params, cfg, serving, device="cuda")
    client = ServingClient(engine)
    steps = []  # (iteration, drafts proposed, drafts accepted) per step
    drafts = []  # (iteration, request id, tokens generated, draft) per proposal
    step, collect = engine.step, engine._collect_proposals

    def logged_step():
        it, p0, a0 = (engine.stats[k] for k in ("iterations", "spec_proposed",
                                                "spec_accepted"))
        try:
            return step()
        finally:
            steps.append((it, engine.stats["spec_proposed"] - p0,
                          engine.stats["spec_accepted"] - a0))

    def logged_collect(active, iteration):
        props = collect(active, iteration)
        it = engine.stats["iterations"]
        drafts.extend((it, s.request.request_id, len(s.generated), list(props[s.index]))
                      for s in active if props.get(s.index))
        return props

    engine.step, engine._collect_proposals = logged_step, logged_collect
    bodies = wave + wave
    try:
        out = client.generate(donor["prompt_ids"], max_new_tokens=donor["max_new_tokens"],
                              temperature=0.0, timeout=600)
        expect(len(out.tokens) == donor["max_new_tokens"], "chaos donor")
        it0 = engine.stats["iterations"]
        storm = (it0 + STORM[0], it0 + STORM[1])
        faults.arm(f"prefix_corrupt@{it0 + 7},serve_corrupt@{it0 + 12},"
                   f"spec_reject_storm@{storm[0]}-{storm[1]}")
        t0 = time.perf_counter()
        pend = [client.runner.submit(
            b["prompt_ids"], max_new_tokens=b["max_new_tokens"],
            temperature=b["temperature"], top_k=b.get("top_k"),
            seed=b.get("seed", 0)) for b in bodies]
        for p in pend:
            expect(p.done.wait(600), "chaos wave did not finish")
        wall = time.perf_counter() - t0
        _, samples = parse_exposition(engine.registry.render())
        restarts_metric = next(v for n, lab, v in samples
                               if n == "serving_engine_restarts_total")
        restarts = client.runner.restarts
    finally:
        faults.reset()
        client.close()
    ok = failed = 0
    for i, (p, b) in enumerate(zip(pend, bodies)):
        if p.error is not None:
            expect(isinstance(p.error, EngineCrashError) and p.error.retriable,
                   f"chaos request {i} failed untyped: {p.error!r}")
            failed += 1
            continue
        ok += 1
        expect(len(p.result.tokens) == NEW_TOKENS, f"chaos request {i} length")
        if b["temperature"] == 0.0:
            expect(p.result.tokens == want[i % len(wave)],
                   f"chaos request {i} (greedy) differs from the unfaulted wave")
    body_of = {p.rid: i % len(wave) for i, p in enumerate(pend)}
    in_storm = [(p, a) for it, p, a in steps if storm[0] <= it <= storm[1]]
    would = sum(would_accept(d, want[body_of[rid]], g)
                for it, rid, g, d in drafts
                if storm[0] <= it <= storm[1] and body_of[rid] not in SAMPLED)
    proposed, accepted = (sum(x[k] for x in in_storm) for k in (0, 1))
    expect(would > 0 and accepted == 0,
           f"storm iterations {storm}: {proposed} drafts proposed, {accepted} "
           f"accepted, {would} that the unfaulted exact verify accepts")
    after = [(p, a) for it, p, a in steps if it > storm[1]]
    expect(restarts == 2 == restarts_metric,
           f"restarts {restarts}, serving_engine_restarts_total {restarts_metric}, "
           "2 crash-class faults armed")
    expect(ok > 0 and failed > 0, f"chaos: {ok} served, {failed} failed")
    return dict(ok=ok, failed=failed, restarts=restarts, storm=(proposed, accepted),
                would=would, wall=wall, it0=it0, after=(sum(p for p, _ in after),
                                                        sum(a for _, a in after)))


def first_difference(a: list, b: list):
    """(request, token position) of the first difference, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (s, t) in enumerate(zip(x, y)):
            if s != t:
                return i, j
    return None


def run_serve_paged(torch, card: str) -> dict:
    """Phase 3b. Serves the diff recipe (random weights from a seed) in
    (a) the paged pool, int8 K/V, prefix cache, n-gram speculation with
    batched verify (rows 6 and 8), (b) the contiguous pool, int8 K/V,
    batched verify (rows 5-int8 and 7), then the identity runs: paged
    and contiguous without speculation, and paged with the exact verify.
    Returns the launch count of each row's instance over (a) and (b)."""
    from differential_transformer_replication_tpu_torch.config import (
        ModelConfig,
        ServingConfig,
    )
    from differential_transformer_replication_tpu_torch.models import init_model
    from differential_transformer_replication_tpu_torch.obs.spans import SpanTracer
    from differential_transformer_replication_tpu_torch.serving import decode_profile

    cfg = ModelConfig(**RECIPE, compute_dtype="bfloat16", param_dtype="float32")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_model(gen, cfg)
    donor, wave = paged_bodies(cfg.vocab_size)
    base = dict(num_slots=8, prefill_chunk=128, prefill_budget=4096,
                kv_cache_dtype="int8", spec_draft_len=4)
    paged = dict(kv_page_size=16)
    runs = {}
    for key, label, kw in (
            ("a", "paged, prefix cache, batched verify",
             dict(paged, spec_mode="ngram", spec_verify="batched")),
            ("b", "contiguous, batched verify",
             dict(spec_mode="ngram", spec_verify="batched")),
            ("paged", "paged, prefix cache, no spec", paged),
            ("contiguous", "contiguous, no spec", {}),
            ("paged-exact", "paged, prefix cache, exact verify",
             dict(paged, spec_mode="ngram", spec_verify="exact")),
            ("c", "paged, prefix cache, batched verify of 8 drafts (9 rows: two "
             "kernel passes)",
             dict(paged, spec_mode="ngram", spec_verify="batched", spec_draft_len=8))):
        serving = ServingConfig(**{**base, **kw})
        runs[key] = r = serve_waves(torch, params, cfg, serving, donor, wave)
        s0, s1 = r["stats0"], r["stats1"]
        steps = s1["decode_steps"] - s0["decode_steps"]
        verify = s1["spec_steps"] - s0["spec_steps"]
        proposed = s1["spec_proposed"] - s0["spec_proposed"]
        accepted = s1["spec_accepted"] - s0["spec_accepted"]
        tokens = s1["decode_tokens"] - s0["decode_tokens"]
        iters = s1["iterations"] - s0["iterations"]
        ttft = {h: [r["replies"][i]["ttft_ms"] for i in range(len(wave))
                    if (i in HITS) == h] for h in (True, False)}
        pages = r["health"].get("kv_pages")
        log(f"[serve-paged] ({key}) {label}, int8 KV, pages of 16, k = {serving.spec_draft_len}: "
            f"wave of {len(wave)} in {r['wall']:.2f} s over {iters} engine iterations "
            f"({r['wall'] / max(iters, 1) * 1e3:.1f} ms per iteration); {steps} decode "
            f"steps ({verify} verify), {tokens / max(steps, 1):.2f} tokens per decode "
            f"step over all slots; drafts {accepted}/{proposed} accepted"
            + (f" ({accepted / proposed:.3f})" if proposed else "")
            + f"; prefix hits {pages['hits_total'] if pages else 'n/a'}; TTFT p50 "
            f"hits {statistics.median(ttft[True]):.1f} ms, misses "
            f"{statistics.median(ttft[False]):.1f} ms; launches {r['counts']}; {card}")
    greedy = [i for i in range(len(wave)) if i not in SAMPLED]
    toks = {k: [r["replies"][i]["tokens"] for i in greedy] for k, r in runs.items()}
    for name, x, y, must in (("paged vs contiguous (no spec)", "paged", "contiguous", True),
                             ("exact spec vs no spec (paged)", "paged-exact", "paged", True),
                             ("batched paged vs batched contiguous", "a", "b", False),
                             ("batched spec vs no spec (paged)", "a", "paged", False)):
        diff = first_difference(toks[x], toks[y])
        same = sum(p == q for p, q in zip(toks[x], toks[y]))
        log(f"[serve-paged] greedy identity, {name}: {same}/{len(greedy)} requests "
            "identical" + ("" if diff is None else
                           f"; first difference: request {greedy[diff[0]]}, token "
                           f"{diff[1]}") + ("" if must else " (reported, not required:"
                                           " a batched verify's larger products may "
                                           "round differently)"))
        if must:
            expect(diff is None, f"greedy {name} differ at {diff}")
    a, b = runs["a"], runs["b"]
    t_chaos = time.perf_counter()
    # the exact verify: its greedy tokens do not depend on which slots
    # share a step, and the crashes change that
    chaos = serve_chaos(torch, params, cfg, ServingConfig(
        **base, **paged, spec_mode="ngram", spec_verify="exact",
        restart_backoff_s=0.05), donor, wave,
        [r["tokens"] for r in runs["paged-exact"]["replies"]])
    log(f"[serve-paged] chaos, paged exact verify, wave submitted twice: prefix_corrupt "
        f"at iteration {chaos['it0'] + 7}, serve_corrupt at {chaos['it0'] + 12}: "
        f"{chaos['ok']} served with the unfaulted tokens (greedy), {chaos['failed']} "
        f"failed typed, {chaos['restarts']} restarts = serving_engine_restarts_total; "
        f"reject storm at {chaos['it0'] + STORM[0]}-{chaos['it0'] + STORM[1]}: "
        f"(proposed, accepted) {chaos['storm']}, {chaos['would']} of its drafts "
        f"accepted by the unfaulted exact verify; after it {chaos['after']}; "
        f"{chaos['wall']:.2f} s for the wave, {time.perf_counter() - t_chaos:.1f} s "
        f"in all; {card}")
    expect(a["health"]["kv_pages"]["hits_total"] >= len(HITS),
           f"prefix hits {a['health']['kv_pages']['hits_total']} < {len(HITS)}")
    # (c) served every request to completion (serve_waves) through the
    # multi-row paged kernel, once a layer per verify step
    c_st, c_counts = runs["c"]["stats1"], runs["c"]["counts"]
    expect(c_counts["decode_attention_multi_paged"][0] == cfg.n_layer * c_st["spec_steps"] > 0,
           f"run (c): decode_attention_multi_paged launched "
           f"{c_counts['decode_attention_multi_paged'][0]} times over "
           f"{c_st['spec_steps']} verify steps")
    for key in ("a", "b", "c"):
        acc = runs[key]["stats1"]["spec_accepted"] - runs[key]["stats0"]["spec_accepted"]
        expect(acc > 0, f"run ({key}) accepted no draft")
    L = cfg.n_layer
    out = {}
    for key, run, l1_name, multi_name in (
            ("a", a, "decode_attention_paged", "decode_attention_multi_paged"),
            ("b", b, "decode_attention", "decode_attention_multi")):
        st = run["stats1"]
        l1 = st["decode_steps"] - st["spec_steps"]
        want = {l1_name: L * l1, multi_name: L * st["spec_steps"]}
        for name, n in want.items():
            total, int8 = run["counts"][name]
            expect(total == int8 == n and n > 0,
                   f"run ({key}): {name} launched {total} times ({int8} int8), "
                   f"expected {n} int8 launches")
        out["decode_attention_int8" if l1_name == "decode_attention" else l1_name] = \
            want[l1_name]
        out[multi_name] = want[multi_name]
    # steady-state decode steps (8 slots, 256-token contexts): the
    # contiguous bf16 step, the paged int8 step and the paged batched verify
    for kw in ({}, dict(kv_page_size=16, kv_cache_dtype="int8"),
               dict(kv_page_size=16, kv_cache_dtype="int8", spec_mode="ngram",
                    spec_verify="batched")):
        serving = ServingConfig(num_slots=decode_profile.SLOTS, prefill_chunk=128,
                                prefill_budget=4096, **kw)
        prof = decode_profile.profile(
            decode_profile.recipe_engine(serving),
            decode_profile.prompts_for(serving, cfg.vocab_size))
        log(f"[serve-paged] decode_profile {kw or 'contiguous bf16'}: "
            f"{prof['wall_ms_per_step']:.2f} ms wall per step, device busy "
            f"{prof['device_busy_ms_per_step']:.3f} ms, idle share "
            f"{prof['device_idle_share']:.3f}, {prof['tokens_per_step']:.2f} "
            f"tokens per step, accept rate {prof['accept_rate']}, "
            f"{prof['device_kernels_per_step']:.0f} kernels per step; top "
            f"{[(k['name'][:40], round(k['ms_per_step'], 3)) for k in prof['top_kernels'][:4]]}; "
            f"{card}")
        torch.cuda.empty_cache()
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    t_ab = time.perf_counter()
    ab = {}
    for tag in ("off", "on", "on", "off"):
        serving = ServingConfig(num_slots=decode_profile.SLOTS, prefill_chunk=128,
                                prefill_budget=4096, quality_telemetry=tag == "on")
        tracer = (SpanTracer(str(out_dir / "profile.trace.json"),
                             process_name="serving-engine") if tag == "on" else None)
        prof = decode_profile.profile(
            decode_profile.recipe_engine(serving, tracer),
            decode_profile.prompts_for(serving, cfg.vocab_size))
        if tracer is not None:
            tracer.close()
        ab.setdefault(tag, []).append(prof)
        torch.cuda.empty_cache()
    for tag, profs in ab.items():
        log(f"[serve-paged] decode_profile contiguous bf16, quality telemetry and "
            f"tracing {tag}: wall ms per step "
            f"{[round(p['wall_ms_per_step'], 3) for p in profs]}, device busy ms "
            f"{[round(p['device_busy_ms_per_step'], 4) for p in profs]}, kernels "
            f"per step {[p['device_kernels_per_step'] for p in profs]}, wrapper "
            f"launches per step {profs[0]['wrapper_launches_per_step']}; {card}")
    expect(all(p["wrapper_launches_per_step"] == ab["off"][0]["wrapper_launches_per_step"]
               for p in ab["on"] + ab["off"]),
           "telemetry changed the kernel launches of a decode step")
    log(f"[serve-paged] telemetry A B B A took {time.perf_counter() - t_ab:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 3c: KV state that leaves the card: the host tier, preemption,
# migration between two servers, the tier's fault drills, replay
# ---------------------------------------------------------------------------

TIER_SERVING = dict(num_slots=8, prefill_chunk=128, prefill_budget=4096,
                    kv_page_size=16, host_tier_bytes=4 << 30)
TIER_NEW = 32     # tokens a tier-wave request generates
MIG_NEW = 120     # tokens a migrated request generates (~1 s in flight)
LOW_NEW, HIGH_NEW = 100, 64  # the preemption run's low and high requests
TIER_COUNTS = ("decode_attention_paged", "decode_attention_multi_paged")


def tier_prompts(vocab: int) -> dict:
    """(a): a donor and a wave of four on one 256-token prefix (16 full
    pages; each wave prompt adds 16 tokens of its own), and a flood of
    eight distinct 400-token prompts; (b): six low-priority and two
    high-priority 200-token prompts; (c): 97-token prompts, so that a
    radix hit on six cached pages prefills the same one-token chunk that
    the first prefill ended with (64 + 32 + 1)."""
    import numpy as np

    rng = np.random.default_rng(11)
    draw = lambda n: rng.integers(0, vocab, n).tolist()  # noqa: E731
    prefix = draw(256)
    return dict(donor=prefix + draw(16), wave=[prefix + draw(16) for _ in range(4)],
                flood=[draw(400) for _ in range(8)], low=[draw(200) for _ in range(6)],
                high=[draw(200) for _ in range(2)], mig=[draw(97) for _ in range(3)])


def _arm_span(faults, name: str, it: int, n: int = 600) -> None:
    faults.arm(",".join(f"{name}@{i}" for i in range(it, it + n)))


def _tier_delta(engine, before: dict) -> dict:
    keys = ("tier_demotions", "tier_promotions", "tier_fallbacks", "preemptions",
            "resumes", "migrate_failed")
    return {k: engine.stats[k] - before.get(k, 0) for k in keys}


def tier_waves(engine, P: dict, faults, fault: str = "") -> dict:
    """(a) on one engine: the donor alone, the wave (its prompts hit the
    donor's prefix pages), the flood (which evicts and demotes them),
    then the wave again (whose prefix pages come back from the tier).
    ``fault`` arms ``page_demote_fail`` over the flood or
    ``page_promote_hang`` over the second wave."""
    kw = dict(max_new_tokens=TIER_NEW, temperature=0.0)
    engine.generate([P["donor"]], **kw)
    first = [o.tokens for o in engine.generate(P["wave"], **kw)]
    if fault == "page_demote_fail":
        _arm_span(faults, fault, engine.stats["iterations"])
    engine.generate(P["flood"], **kw)
    faults.reset()
    if fault == "page_promote_hang":
        _arm_span(faults, fault, engine.stats["iterations"])
    before = dict(engine.stats.snapshot())
    hits0 = engine.tier_stats()["hits_total"]
    outs = engine.generate(P["wave"], **kw)
    faults.reset()
    return dict(first=first, second=[o.tokens for o in outs],
                reasons=[o.finish_reason for o in outs],
                delta=_tier_delta(engine, before),
                hits=engine.tier_stats()["hits_total"] - hits0,
                demotions=engine.stats["tier_demotions"])


def _low_kw(i: int) -> dict:
    """Low request i: greedy, or sampled for odd i."""
    kw = dict(max_new_tokens=LOW_NEW, temperature=0.0, priority="batch")
    if i % 2:
        kw.update(temperature=0.8, top_k=50, seed=200 + i)
    return kw


def pressure(engine, P: dict, faults, fault: str = "") -> dict:
    """(b) on one engine: the six low-priority requests decode two
    tokens each, then the two high-priority ones arrive; the pool cannot
    hold them too, so low slots are preempted (stashed to the tier) and
    swapped back in later. ``fault`` arms ``page_swap_corrupt`` from the
    high requests' arrival."""
    rids = [engine.submit(p, **_low_kw(i)) for i, p in enumerate(P["low"])]
    outs = {}
    for _ in range(400):
        slots = [engine._slot_for(r) for r in rids]
        if all(s is not None and len(s.generated) >= 2 for s in slots):
            break
        outs.update({o.request_id: o for o in engine.step()})
    before = dict(engine.stats.snapshot())
    if fault:
        _arm_span(faults, fault, engine.stats["iterations"])
    hi = [engine.submit(p, max_new_tokens=HIGH_NEW, temperature=0.0, priority="high")
          for p in P["high"]]
    outs.update({o.request_id: o for o in engine.run()})
    faults.reset()
    return dict(low=[outs[r] for r in rids], high=[outs[r] for r in hi],
                delta=_tier_delta(engine, before))


def page_transfer_ms(torch, engine, n: int = 64) -> tuple:
    """(bytes of one page image, ms to extract one page, ms to inject
    one) over ``n`` pages of the engine's pool, each a synchronous
    device-to-host or host-to-device copy of the page's leaves."""
    from differential_transformer_replication_tpu_torch.models.decode import (
        extract_cache_page,
        inject_cache_page,
    )

    pages = range(1, n + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imgs = [extract_cache_page(engine.cache, p) for p in pages]
    t_ex = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p, img in zip(pages, imgs):
        inject_cache_page(engine.cache, p, img)
    torch.cuda.synchronize()
    t_in = (time.perf_counter() - t0) / n * 1e3
    nbytes = sum(t.numel() * t.element_size() for layer in imgs[0] for t in layer.values())
    return nbytes, t_ex, t_in


class TierServer:
    """A port server on a loopback port, in this process, whose engine's
    ``export_slot_state`` and ``import_state`` are timed."""

    def __init__(self, torch, params, cfg, serving):
        from differential_transformer_replication_tpu_torch.serving.engine import (
            ServingEngine,
        )
        from differential_transformer_replication_tpu_torch.serving.server import (
            ServingClient,
            serve,
        )

        self.engine = ServingEngine(params, cfg, serving, device="cuda")
        self.ms = {"export": [], "import": []}
        for name, attr in (("export", "export_slot_state"), ("import", "import_state")):
            fn = getattr(self.engine, attr)

            def timed(*a, _fn=fn, _out=self.ms[name], **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    _out.append((time.perf_counter() - t0) * 1e3)

            setattr(self.engine, attr, timed)
        self.client = ServingClient(self.engine)
        self.httpd = serve(self.client, port=0)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.client.close()
        self.thread.join(timeout=30)


def _post_any(url: str, body: dict) -> tuple:
    """POST JSON; (status, body) for error statuses too."""
    try:
        return _post(url, body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _wait_tokens(url: str, journal_id: str, n: int, timeout: float = 120.0) -> dict:
    """Poll ``/inflight`` until the request tagged ``journal_id`` shows n
    tokens; its entry."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        with urllib.request.urlopen(url + "/inflight", timeout=30) as r:
            for ent in json.load(r)["inflight"]:
                if ent.get("journal_id") == journal_id and len(ent["tokens"]) >= n:
                    return ent
        time.sleep(0.002)
    raise Failure(f"{journal_id} showed no {n} tokens on {url}/inflight")


def migrate_one(a, b, body: dict, tag: str) -> dict:
    """(c) one request: ``/generate`` on A, polled on A's ``/inflight``
    until it shows 8 tokens, then ``POST A/migrate/export`` to B. Returns
    the export's reply, the blocked call's reply and, when it migrated,
    B's ``/migrate/await`` reply."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        call = pool.submit(_post_any, a.url + "/generate", dict(body, journal_id=tag))
        ent = _wait_tokens(a.url, tag, 8)
        status, export = _post_any(a.url + "/migrate/export", {
            "request_id": ent["request_id"], "dest": b.url, "migrate_id": tag,
            "budget_s": 60})
        src = call.result(timeout=600)
    out = dict(export=(status, export), src=src, at=len(ent["tokens"]))
    if status == 200 and export.get("outcome") == "migrated":
        out["await"] = _post_any(b.url + "/migrate/await", {"migrate_id": tag})
    return out


def migrations(torch, params, cfg, kv: str, P: dict, dat, faults, card: str,
               full: bool) -> dict:
    """(c) with ``kv`` storage: a greedy and a sampled request migrate
    from server A to B and finish there with the tokens B gives them
    alone; with ``full``, also a migration against a B warmed on the
    prompt (dedup) and one with ``migrate_corrupt`` armed (B refuses it
    typed, A finishes it). Decode-attention launches over the migrations
    equal the paged formula over both engines' decode steps."""
    from differential_transformer_replication_tpu_torch.config import ServingConfig

    serving = ServingConfig(**{**TIER_SERVING, "kv_cache_dtype": kv})
    a, b = (TierServer(torch, params, cfg, serving) for _ in range(2))
    bodies = [{"prompt_ids": P["mig"][0], "max_new_tokens": MIG_NEW, "temperature": 0.0},
              {"prompt_ids": P["mig"][1], "max_new_tokens": MIG_NEW, "temperature": 0.8,
               "top_k": 50, "seed": 9}]
    res = {}
    try:
        counters = {k: getattr(dat, k) for k in TIER_COUNTS}
        for fn in counters.values():
            fn.launches = fn.int8_launches = 0
        steps0 = a.engine.steps["decode_steps"] + b.engine.steps["decode_steps"]
        res["moved"] = [migrate_one(a, b, body, f"{kv}-{i}") for i, body in enumerate(bodies)]
        steps = a.engine.steps["decode_steps"] + b.engine.steps["decode_steps"] - steps0
        counts = {k: (fn.launches, fn.int8_launches) for k, fn in counters.items()}
        res["alone"] = [_post(b.url + "/generate", body)[1]["tokens"] for body in bodies]
        if full:
            body = {"prompt_ids": P["mig"][2], "max_new_tokens": MIG_NEW, "temperature": 0.0}
            _post(b.url + "/generate", dict(body, max_new_tokens=4))  # warm B
            res["dedup"] = migrate_one(a, b, body, f"{kv}-dedup")
            res["dedup_ref"] = _post(b.url + "/generate", body)[1]["tokens"]
            failed0 = a.engine.stats["migrate_failed"]
            faults.arm("migrate_corrupt")
            res["corrupt"] = migrate_one(a, b, bodies[0], f"{kv}-corrupt")
            faults.reset()
            res["corrupt_failed"] = a.engine.stats["migrate_failed"] - failed0
        res["stats"] = (a.engine.stats.snapshot(), b.engine.stats.snapshot())
        res["ms"] = (a.ms["export"], b.ms["import"])
    finally:
        faults.reset()
        a.close()
        b.close()
    L = cfg.n_layer
    expect(counts["decode_attention_paged"][0] == L * steps > 0
           and counts["decode_attention_multi_paged"][0] == 0
           and counts["decode_attention_paged"][1] == (L * steps if kv == "int8" else 0),
           f"(c) {kv}: decode attention launches {counts}, {steps} decode steps "
           f"of {L} layers")
    for i, (m, alone) in enumerate(zip(res["moved"], res["alone"])):
        status, reply = m["export"]
        expect(status == 200 and reply.get("outcome") == "migrated",
               f"(c) {kv} request {i}: /migrate/export answered {status}: {reply}")
        expect(m["src"][0] == 200 and m["src"][1].get("code") == "migrated",
               f"(c) {kv} request {i}: the blocked /generate answered {m['src']}")
        st, out = m["await"]
        expect(st == 200 and out["tokens"] == alone and len(alone) == MIG_NEW,
               f"(c) {kv} request {i} ({'greedy' if i == 0 else 'sampled'}): the "
               f"migrated continuation differs from B alone at "
               f"{first_difference([out.get('tokens', [])], [alone])}")
    ex, im = res["ms"]
    sa, sb = res["stats"]
    log(f"[serve-tier] (c) migration, {kv} KV, A -> B over loopback HTTP at 8 "
        f"tokens: greedy and sampled continuations bit-equal to B alone "
        f"({len(res['alone'][0])} tokens each); blobs "
        f"{[m['export'][1]['bytes'] for m in res['moved']]} B, export ms "
        f"{[round(t, 3) for t in ex[:2]]}, import ms {[round(t, 3) for t in im[:2]]}; "
        f"launches {counts} over {steps} decode steps; {card}")
    if full:
        st, reply = res["dedup"]["export"]
        deduped = reply.get("dedup_pages", 0)
        expect(st == 200 and deduped > 0
               and sa["migrate_pages_deduped"] > 0,
               f"(c) dedup: /migrate/export answered {st}: {reply}, "
               f"{sa['migrate_pages_deduped']} pages deduped")
        expect(res["dedup"]["await"][1]["tokens"] == res["dedup_ref"],
               "(c) dedup: the continuation differs from B alone")
        st, reply = res["corrupt"]["export"]
        src_st, src = res["corrupt"]["src"]
        expect(st == 409 and reply.get("code") == "migrate_transfer"
               and "migrate_corrupt" in reply.get("error", "")
               and res["corrupt_failed"] == 1,
               f"(c) migrate_corrupt: /migrate/export answered {st}: {reply}")
        expect(src_st == 200 and src["tokens"] == res["alone"][0],
               f"(c) migrate_corrupt: A's own reply {src_st} differs from the "
               f"unmigrated tokens at {first_difference([src.get('tokens', [])], [res['alone'][0]])}")
        log(f"[serve-tier] (c) dedup against a warmed B: {deduped} "
            f"pages not shipped, blob {res['dedup']['export'][1]['bytes']} B, tokens "
            f"bit-equal to B alone; migrate_corrupt: B answered 409 migrate_corrupt, "
            f"A's export 409 migrate_transfer, A finished the request with its "
            f"unmigrated tokens; exports {sa['migrate_exports']}, pages shipped "
            f"{sa['migrate_pages_shipped']}, deduped {sa['migrate_pages_deduped']}, "
            f"imports on B {sb['migrate_imports']}; {card}")
    return res


def run_serve_tier(torch, card: str) -> None:
    """Phase 3c. The diff recipe (random weights from the serve phases'
    seed), pages of 16, bf16 compute: (a) the host tier, int8 and bf16
    KV; (b) preemption, int8 KV, greedy and sampled, and again under
    batched n-gram speculation (rows 6 and 8, its tokens reported);
    (c) migration between two port servers in this process, int8 (with
    dedup and ``migrate_corrupt``) and bf16; (d) the three tier faults;
    (e) replay by ``key_offset`` on the contiguous int8 pool under
    batched speculation (rows 5 and 7). Requires demotions, promotions,
    preemptions equal to resumes, bit-equal resumed and migrated tokens,
    counted fallbacks and the typed 409; reports the page and blob
    bytes, the transfer times and the replay's first difference."""
    import os

    from differential_transformer_replication_tpu_torch.config import (
        ModelConfig,
        ServingConfig,
    )
    from differential_transformer_replication_tpu_torch.models import init_model
    from differential_transformer_replication_tpu_torch.ops import (
        decode_attention as dat,
    )
    from differential_transformer_replication_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from differential_transformer_replication_tpu_torch.serving.request import (
        SamplingParams,
    )
    from differential_transformer_replication_tpu_torch.utils import faults

    cfg = ModelConfig(**RECIPE, compute_dtype="bfloat16", param_dtype="float32")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_model(gen, cfg)
    P = tier_prompts(cfg.vocab_size)
    low_params = [SamplingParams(**_low_kw(i)) for i in range(len(P["low"]))]
    L = cfg.n_layer
    counters = {k: getattr(dat, k) for k in TIER_COUNTS}

    def engine(**kw):
        return ServingEngine(params, cfg, ServingConfig(**{**TIER_SERVING, **kw}),
                             device="cuda")

    def counted(fn, eng):
        """Run ``fn()`` with the paged decode-attention counters from 0;
        its result, the launches and the engine's decode and verify
        steps over the run."""
        for c in counters.values():
            c.launches = c.int8_launches = 0
        s0 = dict(eng.steps)
        out = fn()
        return out, {k: (c.launches, c.int8_launches) for k, c in counters.items()}, \
            {k: eng.steps[k] - s0[k] for k in eng.steps}

    def expect_launches(label, counts, steps, int8):
        l1 = steps["decode_steps"] - steps["spec_steps"]
        want = {"decode_attention_paged": L * l1,
                "decode_attention_multi_paged": L * steps["spec_steps"]}
        for name, n in want.items():
            total, q = counts[name]
            expect(total == n and q == (n if int8 else 0),
                   f"{label}: {name} launched {counts[name]} (int8), expected {n}")
        expect(want["decode_attention_paged"] > 0, f"{label}: no decode step")

    t = time.perf_counter()
    unfaulted = {}
    for kv in ("int8", "bf16"):
        eng = engine(kv_cache_dtype=kv, kv_pool_pages=96)
        r, counts, steps = counted(lambda: tier_waves(eng, P, faults), eng)
        unfaulted[kv] = r
        expect_launches(f"(a) {kv}", counts, steps, kv == "int8")
        d = r["delta"]
        expect(r["demotions"] > 0 and d["tier_promotions"] > 0 and r["hits"] > 0
               and d["tier_fallbacks"] == 0,
               f"(a) {kv}: demotions {r['demotions']}, second wave {d}, tier hits {r['hits']}")
        expect(r["second"] == r["first"],
               f"(a) {kv}: the second wave's greedy tokens differ from the first's at "
               f"{first_difference(r['second'], r['first'])}")
        nbytes, t_ex, t_in = page_transfer_ms(torch, eng)
        prompt_tokens = sum(len(p) for p in P["wave"])
        log(f"[serve-tier] (a) host tier, {kv} KV, pool of 96 pages of 16: "
            f"{r['demotions']} pages demoted by the flood, {d['tier_promotions']} "
            f"promoted at the second wave ({d['tier_promotions'] * 16 / prompt_tokens:.3f} "
            f"of its {prompt_tokens} prompt tokens), {r['hits']} tier hits, greedy "
            f"tokens of both waves bit-equal; page image {nbytes} B, extract "
            f"{t_ex:.3f} ms and inject {t_in:.3f} ms a page; launches {counts}; {card}")
        del eng
        torch.cuda.empty_cache()
    log(f"[serve-tier] (a) took {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    ref_eng = engine(kv_cache_dtype="int8", host_tier_bytes=0)
    ref_outs = ref_eng.generate(P["low"], params=low_params)
    ref = [o.tokens for o in ref_outs]
    alone_hi = ref_eng.generate(P["high"], max_new_tokens=HIGH_NEW, temperature=0.0,
                                priority="high")
    del ref_eng
    eng = engine(kv_cache_dtype="int8", kv_pool_pages=128)
    r, counts, steps = counted(lambda: pressure(eng, P, faults), eng)
    expect_launches("(b)", counts, steps, True)
    d = r["delta"]
    expect(d["preemptions"] >= 1 and d["resumes"] == d["preemptions"]
           and d["tier_fallbacks"] == 0, f"(b): {d}")
    got = [o.tokens for o in r["low"]]
    expect(got == ref, f"(b): a preempted request's tokens differ from its run "
           f"without pressure at {first_difference(got, ref)}")
    expect(all(len(o.tokens) == HIGH_NEW for o in r["high"]), "(b) high requests")
    ttft = [round(o.ttft * 1e3, 1) for o in r["high"]]
    ttft0 = [round(o.ttft * 1e3, 1) for o in alone_hi]
    lat = [round((o.finish_time - o.submit_time) * 1e3) for o in r["low"]]
    lat0 = [round((o.finish_time - o.submit_time) * 1e3) for o in ref_outs]
    log(f"[serve-tier] (b) preemption, int8 KV, pool of 128 pages: {d['preemptions']} "
        f"preemptions = {d['resumes']} resumes, the six low requests (3 greedy, 3 "
        f"sampled) bit-equal to their run without pressure; high TTFT {ttft} ms "
        f"against {ttft0} ms without the low load; low requests' submit-to-finish "
        f"{lat} ms against {lat0} ms without pressure; launches {counts}; {card}")
    del eng
    eng = engine(kv_cache_dtype="int8", kv_pool_pages=128, spec_mode="ngram",
                 spec_verify="batched")
    ref_spec = [o.tokens for o in engine(
        kv_cache_dtype="int8", host_tier_bytes=0, spec_mode="ngram",
        spec_verify="batched").generate(P["low"], params=low_params)]
    r, counts, steps = counted(lambda: pressure(eng, P, faults), eng)
    expect_launches("(b) batched verify", counts, steps, True)
    expect(steps["spec_steps"] > 0 and r["delta"]["resumes"] == r["delta"]["preemptions"] >= 1,
           f"(b) batched verify: {steps}, {r['delta']}")
    got = [o.tokens for o in r["low"]]
    diff = first_difference(got, ref_spec)
    log(f"[serve-tier] (b) again under n-gram speculation, batched verify: "
        f"{r['delta']['preemptions']} preemptions = resumes, {steps['spec_steps']} verify "
        f"steps; low requests against their run without pressure: "
        f"{sum(x == y for x, y in zip(got, ref_spec))}/6 identical"
        + ("" if diff is None else f", first difference request {diff[0]} token {diff[1]}")
        + f" (reported, not required: which slots share a verify step changes its "
        f"products); launches {counts}; {card}")
    del eng
    torch.cuda.empty_cache()
    log(f"[serve-tier] (b) took {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    migrations(torch, params, cfg, "int8", P, dat, faults, card, full=True)
    migrations(torch, params, cfg, "bf16", P, dat, faults, card, full=False)
    torch.cuda.empty_cache()
    log(f"[serve-tier] (c) took {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    os.environ["DTX_TIER_HANG_S"] = "0.2"
    try:
        drills = {}
        for name in ("page_demote_fail", "page_promote_hang"):
            eng = engine(kv_cache_dtype="int8", kv_pool_pages=96)
            drills[name] = r = tier_waves(eng, P, faults, name)
            fell = (eng.stats["tier_fallbacks"] if name == "page_demote_fail"
                    else r["delta"]["tier_fallbacks"])
            expect(fell > 0 and all(x == "length" for x in r["reasons"]),
                   f"(d) {name}: {fell} fallbacks, reasons {r['reasons']}")
            drills[name]["fell"] = fell
        eng = engine(kv_cache_dtype="int8", kv_pool_pages=128)
        drills["page_swap_corrupt"] = r = pressure(eng, P, faults, "page_swap_corrupt")
        corrupt = eng.tier_stats()["corrupt_total"]
        expect(corrupt >= 1 and r["delta"]["tier_fallbacks"] >= 1
               and all(o.finish_reason == "length" for o in r["low"] + r["high"]),
               f"(d) page_swap_corrupt: corrupt {corrupt}, {r['delta']}")
        r["fell"] = r["delta"]["tier_fallbacks"]
    finally:
        os.environ.pop("DTX_TIER_HANG_S", None)
        faults.reset()
    same = {n: (drills[n]["second"] == unfaulted["int8"]["first"]) for n in
            ("page_demote_fail", "page_promote_hang")}
    same["page_swap_corrupt"] = [o.tokens for o in drills["page_swap_corrupt"]["low"]] == ref
    log(f"[serve-tier] (d) fault drills, int8 KV: fallbacks "
        f"{ {n: d['fell'] for n, d in drills.items()} }, no crash, every request "
        f"finished by length; tokens equal to the unfaulted run: {same}; "
        f"{time.perf_counter() - t:.1f} s; {card}")
    del eng
    torch.cuda.empty_cache()

    t = time.perf_counter()
    eng = ServingEngine(params, cfg, ServingConfig(
        num_slots=8, prefill_chunk=128, prefill_budget=4096, kv_cache_dtype="int8",
        spec_mode="ngram", spec_verify="batched"), device="cuda")
    motif = P["mig"][0][:5]
    prompt = (motif * 40)[:150]
    for fn in (dat.decode_attention, dat.decode_attention_multi):
        fn.launches = fn.int8_launches = 0
    full_run = eng.generate([prompt], max_new_tokens=96, temperature=0.0)[0].tokens
    tail = eng.generate([prompt + full_run[:32]], max_new_tokens=64, temperature=0.0,
                        key_offset=32)[0].tokens
    launches = {fn.__name__: fn.launches for fn in (dat.decode_attention,
                                                   dat.decode_attention_multi)}
    expect(all(launches.values()) and len(tail) == 64,
           f"(e) replay: launches {launches}, {len(tail)} tokens")
    diff = first_difference([tail], [full_run[32:]])
    log(f"[serve-tier] (e) replay, contiguous int8 pool, batched verify: prompt + the "
        f"first 32 tokens with key_offset 32 against the uninterrupted tail: "
        + ("identical" if diff is None else f"first difference at token {diff[1]}")
        + f" (reported: the replay prefills what the run decoded); launches "
        f"{launches}; {time.perf_counter() - t:.1f} s; {card}")
    del eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3d: what a request can ask of the server
# ---------------------------------------------------------------------------

REQ_SERVING = dict(num_slots=8, prefill_chunk=128, prefill_budget=4096)
REQ_NEW = 128        # greedy tokens a drafter-phase request generates
REQ_PROMPT = 64      # tokens of each of its prompts
REQ_K = 4            # draft length of the model-drafter runs
# kernels a contiguous bf16 decode step launches (serving/decode_profile.py
# on the parent tree, PERF.md section 5): an inert wave must keep it
PARENT_DECODE_KERNELS = 308
REQ_SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string"}, "age": {"type": "integer"}},
    "required": ["name", "age"]}


def _req_counters():
    from differential_transformer_replication_tpu_torch.ops import (
        decode_attention as dat,
        fused_ffn as ffn,
        fused_norm_residual as fnr,
    )

    return {"fused_add_norm": fnr.fused_add_norm, "fused_norm": fnr.fused_norm,
            "fused_swiglu": ffn.fused_swiglu,
            "decode_attention": dat.decode_attention,
            "decode_attention_multi": dat.decode_attention_multi,
            "decode_attention_paged": dat.decode_attention_paged,
            "decode_attention_multi_paged": dat.decode_attention_multi_paged}


def req_counted(torch, fn, engine, path: tuple):
    """Run ``fn()`` with every kernel wrapper's count set to 0 just
    before and read just after; fails when a kernel of ``path`` (the
    wrapper names the run must go through) was never launched. Returns
    the result, the counts and the engine's step counts over the run."""
    counters = _req_counters()
    for c in counters.values():
        c.launches = 0
    s0 = dict(engine.steps)
    out = fn()
    torch.cuda.synchronize()
    counts = {k: c.launches for k, c in counters.items()}
    for k in path:
        expect(counts[k] > 0, f"serve-requests: {k} never launched in the run "
               f"({counts})")
    return out, counts, {k: engine.steps[k] - s0[k] for k in engine.steps}


def drafter_pool_bytes(cfg, slots: int) -> int:
    """Device bytes of a contiguous drafter pool, from its config: per
    layer K (S, B, H, M, d) and V (B, H, M, dv) in the compute dtype."""
    S = {"control": 1, "diff": 2, "ndiff": cfg.n_terms}[cfg.model]
    per = (S * cfg.head_size + cfg.value_size) * slots * cfg.n_head * cfg.block_size
    return cfg.n_layer * per * (2 if cfg.compute_dtype == "bfloat16" else 4)


def to_device(tree, device):
    """A param tree with every leaf moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def _fsm_ok(fsm, tokens: list, reason: str) -> bool:
    """An output accepted by its FSM: every token allowed from the start
    state, and a completed constraint in an accepting state."""
    st = fsm.walk(tokens)
    return st >= 0 and (reason != "constraint_complete" or fsm.is_accepting(st))


def run_serve_requests(torch, card: str) -> None:
    """Phase 3d. The diff recipe (random weights from the serve phases'
    seed), 8 slots, bf16: (a) the model drafter on the contiguous pool,
    exact verify, greedy requests of 128 tokens: a self drafter and a
    random 2-layer control drafter, tokens bit-equal to the non-spec run,
    the self drafter's acceptance >= 0.9, decode-attention launches equal
    to the target's steps plus the drafter's rounds times its layers,
    ``serving_spec_drafter_kv_bytes`` equal to the pool's bytes; both again
    on the paged int8 pool with batched verify (first difference from
    non-spec reported); ``spec_drafter_crash``: one crash, tokens
    bit-equal, proposals after the rebuild. (b) int8 weights: the target
    and the control drafter saved with the port's checkpoint writer, a
    server started through the CLI parser with ``--quantize-weights int8
    --spec-drafter-ckpt``; dequantized weights within each channel's half
    step, the decode step's kernels those of bf16 weights, greedy
    agreement with bf16 weights reported. (c) constraints over HTTP with
    the smoke corpus's BPE: regex, choices and JSON-schema requests,
    greedy and sampled, each output accepted by its FSM, greedy
    constrained output under model speculation equal to the same without,
    ``constraint_compile_failed`` and ``constraint_dead_end`` (with its
    partial tokens), cache hits. (d) penalties and logprobs in one wave
    beside plain rows: the plain rows' tokens equal to their wave alone,
    an inert wave's kernels per decode step the parent's, presence
    penalty 100 repeating no token, every echoed top list sorted with the
    greedy token first."""
    import tempfile

    import numpy as np

    from differential_transformer_replication_tpu_torch.config import (
        ModelConfig,
        ServingConfig,
        TrainConfig,
    )
    from differential_transformer_replication_tpu_torch.data.corpus import (
        synthetic_corpus,
    )
    from differential_transformer_replication_tpu_torch.data.tokenizer import (
        train_bpe_tokenizer,
        vocab_strings,
    )
    from differential_transformer_replication_tpu_torch.models import init_model
    from differential_transformer_replication_tpu_torch.obs.registry import (
        parse_exposition,
    )
    from differential_transformer_replication_tpu_torch.serving import server as tserver
    from differential_transformer_replication_tpu_torch.serving.constrain import (
        compile_constraint,
        spec_key,
    )
    from differential_transformer_replication_tpu_torch.serving.engine import (
        ServingEngine,
    )
    from differential_transformer_replication_tpu_torch.serving.request import (
        SamplingParams,
    )
    from differential_transformer_replication_tpu_torch.train.checkpoint import (
        load_params_for_inference,
        save_checkpoint,
    )
    from differential_transformer_replication_tpu_torch.train.step import train_state
    from differential_transformer_replication_tpu_torch.utils import faults

    cfg = ModelConfig(**RECIPE, compute_dtype="bfloat16", param_dtype="float32")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_model(gen, cfg)
    d_train = TrainConfig(model=ModelConfig(**{**RECIPE, "model": "control",
                                               "n_layer": 2},
                                            compute_dtype="bfloat16"),
                          vocab_size=cfg.vocab_size)
    dcfg = d_train.resolved_model()
    gen.manual_seed(1)
    d_params = init_model(gen, dcfg)
    L, Ld = cfg.n_layer, dcfg.n_layer
    rng = np.random.default_rng(19)
    prompts = rng.integers(0, cfg.vocab_size, (8, REQ_PROMPT)).tolist()
    greedy = dict(max_new_tokens=REQ_NEW, temperature=0.0)

    def engine(drafter=None, vocab=None, **kw):
        return ServingEngine(params, cfg, ServingConfig(**{**REQ_SERVING, **kw}),
                             device="cuda", spec_drafter=drafter, vocab=vocab)

    def tokens_of(eng, ps=prompts, **kw):
        return [o.tokens for o in eng.generate(ps, **{**greedy, **kw})]

    path = ("fused_add_norm", "fused_norm", "fused_swiglu", "decode_attention")
    # (a) the model drafter
    t = time.perf_counter()
    ref_eng = engine()
    ref, counts, steps = req_counted(torch, lambda: tokens_of(ref_eng), ref_eng, path)
    expect(counts["decode_attention"] == L * steps["decode_steps"],
           f"(a) non-spec: decode attention {counts}, steps {steps}")
    for name, pair in (("self", (params, cfg)), ("control2", (d_params, dcfg))):
        eng = engine(pair, spec_mode="model", spec_draft_len=REQ_K)
        nd = pair[1].n_layer
        got, counts, steps = req_counted(torch, lambda: tokens_of(eng), eng, path)
        st = eng.spec_stats()
        rounds = eng.drafter.rounds_total
        l1 = steps["decode_steps"] - steps["spec_steps"]
        want = L * (l1 + (REQ_K + 1) * steps["spec_steps"]) + nd * rounds
        diff = first_difference(got, ref)
        expect(got == ref, f"(a) {name} drafter, exact verify: tokens differ from the "
               f"non-spec run at {diff}")
        expect(counts["decode_attention"] == want and rounds > 0
               and counts["decode_attention_multi"] == 0,
               f"(a) {name}: decode attention launched {counts['decode_attention']}, "
               f"expected {want} (target L={L}, {l1} plain + {steps['spec_steps']} "
               f"verify steps of {REQ_K + 1} rows; drafter {nd} layers x {rounds} rounds)")
        vals = {n: v for n, lab, v in parse_exposition(eng.registry.render())[1]}
        pool = drafter_pool_bytes(pair[1], REQ_SERVING["num_slots"])
        expect(vals["serving_spec_drafter_kv_bytes"] == pool == eng.drafter.bytes_total(),
               f"(a) {name}: serving_spec_drafter_kv_bytes "
               f"{vals['serving_spec_drafter_kv_bytes']}, pool {pool}")
        if name == "self":
            expect(st["acceptance_rate"] >= 0.9,
                   f"(a) self drafter acceptance {st['acceptance_rate']} < 0.9")
        log(f"[serve-requests] (a) {name} drafter ({nd} layers), contiguous bf16, "
            f"exact verify, k {REQ_K}, 8 greedy requests of {REQ_NEW}: tokens bit-equal "
            f"to non-spec; acceptance {st['acceptance_rate']} ({st['accepted']}/"
            f"{st['proposed']}), {steps['spec_steps']} verify + {l1} plain steps, "
            f"{rounds} drafter rounds, {eng.drafter.catchup_chunks} catch-up chunks; "
            f"decode attention {counts['decode_attention']} launches = formula; "
            f"drafter pool {pool} B; {card}")
        del eng
    paged = dict(kv_page_size=16, kv_cache_dtype="int8", spec_verify="batched")
    # the paged runs and the crash drill at half the tokens: a
    # greedy run's first 64 tokens are the 128-token run's
    half = dict(max_new_tokens=REQ_NEW // 2)
    pref_eng = engine(kv_page_size=16, kv_cache_dtype="int8")
    pref = tokens_of(pref_eng, **half)
    del pref_eng
    for name, pair in (("self", (params, cfg)), ("control2", (d_params, dcfg))):
        eng = engine(pair, spec_mode="model", spec_draft_len=REQ_K, **paged)
        got, counts, steps = req_counted(
            torch, lambda: tokens_of(eng, **half), eng,
            ("fused_add_norm", "fused_swiglu", "decode_attention",
             "decode_attention_multi_paged"))
        diff = first_difference(got, pref)
        log(f"[serve-requests] (a) {name} drafter, paged int8, batched verify, "
            f"{REQ_NEW // 2} tokens: "
            + ("tokens identical to the non-spec paged int8 run" if diff is None
               else f"first difference from non-spec at request {diff[0]} token {diff[1]}")
            + f" (reported, not required); acceptance "
            f"{eng.spec_stats()['acceptance_rate']}; launches {counts}")
        del eng
    eng = engine((params, cfg), spec_mode="model", spec_draft_len=REQ_K)
    crash_at = eng.stats["iterations"] + 3
    verify_its = []
    plain_spec = eng._decode_spec

    def spy(active, proposals, iteration, finished):
        verify_its.append(iteration)
        return plain_spec(active, proposals, iteration, finished)

    eng._decode_spec = spy
    faults.arm(f"spec_drafter_crash@{crash_at}")
    try:
        got = tokens_of(eng, **half)
    finally:
        faults.reset()
    crashes = eng.stats["spec_drafter_crashes"]
    after = [i for i in verify_its if i > crash_at]
    want = [r[:REQ_NEW // 2] for r in ref]
    expect(crashes == 1 and eng.drafter.stats()["drafter_crashes_total"] == 1
           and got == want and after and crash_at not in verify_its,
           f"(a) spec_drafter_crash@{crash_at}: {crashes} crashes, tokens "
           f"{'equal' if got == want else first_difference(got, want)}, verify "
           f"steps after it {len(after)}")
    log(f"[serve-requests] (a) spec_drafter_crash@{crash_at}, {REQ_NEW // 2} tokens: "
        f"1 crash counted, the "
        f"iteration ran the plain step, {len(after)} verify steps after the rebuild, "
        f"tokens bit-equal; {time.perf_counter() - t:.1f} s")
    del eng, ref_eng
    torch.cuda.empty_cache()

    # (b) int8 weights through the CLI
    t = time.perf_counter()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="serve_requests_", dir=build))
    try:
        tdir, ddir = str(work / "target.ckpt"), str(work / "drafter.ckpt")
        t_train = TrainConfig(model=cfg, vocab_size=cfg.vocab_size)
        save_checkpoint(tdir, train_state(params, t_train, "cuda"), 1.0, t_train)
        save_checkpoint(ddir, train_state(d_params, d_train, "cuda"), 1.0, d_train)
        t_save = time.perf_counter() - t
        args = tserver.build_parser().parse_args([
            "--checkpoint", tdir, "--spec-mode", "model", "--spec-drafter-ckpt", ddir,
            "--spec-draft-len", str(REQ_K), "--quantize-weights", "int8",
            "--device", "cuda", "--port", "0"])
        expect(tserver.refused_flags(["--quantize-weights", "--spec-drafter-ckpt"]) == [],
               "(b) the server still refuses --quantize-weights or --spec-drafter-ckpt")
        q_eng, _, _, _ = tserver.engine_from_args(args)
        # quantized on the host, as the CLI loads it
        qp, _, _ = load_params_for_inference(tdir, quantize="int8")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    checked = 0

    def half_step(node_q, node, name=None):
        nonlocal checked
        if isinstance(node, dict):
            for k in node:
                half_step(node_q[k], node[k], k)
        elif isinstance(node, list):
            for a, b in zip(node_q, node):
                half_step(a, b, name)
        elif name in ("wq", "wk", "wv") or (name == "w" and node.dim() == 2):
            axis = -3 if name != "w" else 0
            scale = node.abs().amax(dim=axis, keepdim=True).clamp(min=1e-12) / 127
            err = (node_q - node).abs()
            # half a step, up to the fp32 rounding of w / scale and
            # q * scale (a few ulps of values up to 127 steps)
            ratio = float((err / (scale / 2)).max())
            expect(not torch.equal(node_q, node) and ratio <= 1 + 1e-4,
                   f"(b) {name}: dequantized weight off by {ratio} half steps")
            checked += 1

    qp = to_device(qp, "cuda")
    half_step(qp, params)
    served_w = q_eng.params["lm_head"]["w"]
    expect(torch.equal(served_w, qp["lm_head"]["w"].to(served_w.dtype))
           and q_eng.drafter.kind == "model" and q_eng.drafter.cfg.n_layer == Ld,
           "(b) the CLI engine does not serve the quantized target and drafter")
    client = tserver.ServingClient(q_eng)
    httpd = tserver.serve(client, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(4) as pool:
            served = [r[1]["tokens"] for r in pool.map(
                lambda p: _post(url + "/generate", {
                    "prompt_ids": p, "max_new_tokens": 64, "temperature": 0.0}),
                prompts[:4])]
    finally:
        httpd.shutdown()
        httpd.server_close()
        client.close()
        server.join(timeout=30)
    q_plain = ServingEngine(qp, cfg, ServingConfig(**REQ_SERVING), device="cuda")
    bf_plain = engine()
    q_tok, q_counts, q_steps = req_counted(
        torch, lambda: tokens_of(q_plain, prompts[:4], max_new_tokens=64), q_plain, path)
    b_tok, b_counts, b_steps = req_counted(
        torch, lambda: tokens_of(bf_plain, prompts[:4], max_new_tokens=64), bf_plain, path)
    expect(served == q_tok, f"(b) the CLI server's tokens (int8 weights, model "
           f"drafter) differ from the int8 engine's at {first_difference(served, q_tok)}")
    expect(q_counts == b_counts and q_steps == b_steps,
           f"(b) int8 weights launch {q_counts} over {q_steps}, bf16 weights "
           f"{b_counts} over {b_steps}")
    agree = float(np.mean([a == b for x, y in zip(q_tok, b_tok) for a, b in zip(x, y)]))
    log(f"[serve-requests] (b) int8 weights: target and 2-layer control drafter "
        f"saved ({t_save:.1f} s) and served through the CLI parser with "
        f"--quantize-weights int8 --spec-drafter-ckpt; {checked} matmul weights each "
        f"within its channels' half steps; the served tokens equal the int8 engine's; "
        f"decode kernels as with bf16 weights ({q_counts}); greedy agreement with bf16 "
        f"weights over 4 prompts x 64 tokens: {agree:.4f}; "
        f"{time.perf_counter() - t:.1f} s; {card}")
    del q_eng, q_plain, bf_plain, qp
    torch.cuda.empty_cache()

    # (c) constraints over HTTP
    t = time.perf_counter()
    tok = train_bpe_tokenizer(synthetic_corpus(CKPT_DOCS, 0), cfg.vocab_size, 2, None)
    vocab = vocab_strings(tok, cfg.vocab_size)
    text_prompts = [tok.encode(s).ids for s in
                    ("One day, Tom", "The dog was very", "Sue and her mom", "Once")]
    specs = [{"regex": "[a-z ]+\\."},
             {"choices": ["Tom went home.", "Sue saw a big dog.", "yes"]},
             {"json_schema": REQ_SCHEMA}]
    bodies = []
    for i, spec in enumerate(specs):
        for j, p in enumerate(text_prompts[:2]):
            body = {"prompt_ids": p, "max_new_tokens": 24, "temperature": 0.0, **spec}
            if j:
                body.update(temperature=0.9, top_k=40, seed=3 + i)
            bodies.append(body)
    results = {}
    for name, kw in (("plain", {}), ("spec", dict(spec_mode="model",
                                                  spec_draft_len=REQ_K))):
        eng = engine((d_params, dcfg) if kw else None, vocab=vocab, **kw)
        client = tserver.ServingClient(eng)
        httpd = tserver.serve(client, port=0)
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        try:
            replies = [_post_any(url + "/generate", b) for b in bodies]
            replies += [_post_any(url + "/generate", b) for b in bodies[::2]]
            bad = _post_any(url + "/generate", {"prompt_ids": text_prompts[0],
                                                "json_schema": "{\"type\": ",
                                                "temperature": 0.0})
            # a regex that never closes: the request is still decoding
            # when the fault poisons its cursor
            faults.arm(f"constrain_dead_end@{eng.stats['iterations'] + 3}")
            dead = _post_any(url + "/generate", dict(bodies[0], regex="[a-z ]+"))
            faults.reset()
            health = json.load(urllib.request.urlopen(url + "/health", timeout=60))
        finally:
            faults.reset()
            httpd.shutdown()
            httpd.server_close()
            client.close()
            server.join(timeout=30)
        for (status, reply), body in zip(replies, bodies + bodies[::2]):
            key = spec_key(SamplingParams(**{k: (json.dumps(v) if k == "json_schema"
                                                 else v)
                                             for k, v in body.items()
                                             if k in ("regex", "choices",
                                                      "json_schema")}), None)
            fsm = compile_constraint(key, vocab)
            expect(status == 200 and _fsm_ok(fsm, reply["tokens"],
                                             reply["finish_reason"]),
                   f"(c) {name}: {status} {reply} not accepted by its FSM")
        expect(bad[0] == 400 and bad[1]["code"] == "constraint_compile_failed",
               f"(c) {name}: a malformed schema answered {bad}")
        expect(dead[0] == 400 and dead[1]["code"] == "constraint_dead_end"
               and dead[1]["partial_tokens"],
               f"(c) {name}: constrain_dead_end answered {dead}")
        cst = health["constraints"]
        expect(cst["hits_total"] >= len(bodies[::2]) and cst["active"] == 0,
               f"(c) {name}: constraint cache {cst}")
        results[name] = replies
        log(f"[serve-requests] (c) constraints over HTTP, {name}: "
            f"{len(replies)} regex/choices/schema requests (greedy and sampled), each "
            f"accepted by its FSM, finish reasons "
            f"{sorted({r['finish_reason'] for _, r in replies})}; a malformed "
            f"schema 400 constraint_compile_failed; constrain_dead_end 400 "
            f"constraint_dead_end after {len(dead[1]['partial_tokens'])} tokens; "
            f"cache {cst}; texts "
            f"{[tok.decode(r['tokens'])[:40] for _, r in replies[:6:2]]}")
        del eng
    greedy_ix = [i for i, b in enumerate(bodies + bodies[::2]) if b["temperature"] == 0]
    got = [results["spec"][i][1]["tokens"] for i in greedy_ix]
    want = [results["plain"][i][1]["tokens"] for i in greedy_ix]
    expect(got == want, f"(c) constrained greedy output under model speculation "
           f"differs from the same without at {first_difference(got, want)}")
    log(f"[serve-requests] (c) constrained greedy output with model speculation "
        f"equal to the same without; {time.perf_counter() - t:.1f} s; {card}")

    # (d) penalties and logprobs in one wave beside plain rows
    t = time.perf_counter()
    plain_kw = [dict(max_new_tokens=48, temperature=0.0)] * 4
    pipe_kw = [dict(max_new_tokens=48, temperature=0.0, presence_penalty=100.0),
               dict(max_new_tokens=48, temperature=0.0, frequency_penalty=0.5,
                    repetition_penalty=1.3, logprobs=3),
               dict(max_new_tokens=48, temperature=0.0, logprobs=5),
               dict(max_new_tokens=48, temperature=0.8, top_k=50, seed=5, logprobs=5)]
    eng = engine()
    wave, counts, steps = req_counted(
        torch, lambda: eng.generate(prompts, params=[
            SamplingParams(**kw) for kw in plain_kw + pipe_kw]), eng, path)
    alone = engine().generate(prompts[:4], params=[SamplingParams(**kw)
                                                   for kw in plain_kw])
    expect([o.tokens for o in wave[:4]] == [o.tokens for o in alone],
           "(d) plain rows beside pipeline rows differ from their wave alone at "
           f"{first_difference([o.tokens for o in wave[:4]], [o.tokens for o in alone])}")
    rep = wave[4].tokens
    expect(len(set(rep)) == len(rep), f"(d) presence_penalty 100 repeated a token: {rep}")
    for o, kw in zip(wave[5:], pipe_kw[1:]):
        expect(len(o.token_logprobs) == len(o.tokens) == len(o.top_logprobs),
               f"(d) echo lengths {len(o.token_logprobs)} / {len(o.tokens)}")
        for tokn, lp, top in zip(o.tokens, o.token_logprobs, o.top_logprobs):
            vals = [v for _, v in top]
            expect(len(top) == kw["logprobs"] and vals == sorted(vals, reverse=True),
                   f"(d) a top list is not sorted: {top}")
            if kw["temperature"] == 0:
                expect(top[0][0] == tokn and top[0][1] == lp,
                       f"(d) greedy token {tokn} ({lp}) is not first in {top}")
    # serving/decode_profile.py's steady decode step, as the parent's
    # number was measured (8 slots of 256-token prompts), in a process
    # of its own: late in this long process the profiler has come back
    # short of kernels (never over), in a fresh one it has not
    del eng
    torch.cuda.empty_cache()
    inert, active, constrained = fresh_decode_profiles(
        {}, dict(presence_penalty=0.5, frequency_penalty=0.1, logprobs=5),
        dict(regex="[a-z ,.]*"))
    expect(inert["device_kernels_per_step"] == PARENT_DECODE_KERNELS,
           f"(d) an inert wave's decode step launched "
           f"{inert['device_kernels_per_step']} kernels, the parent's "
           f"{PARENT_DECODE_KERNELS}")
    log(f"[serve-requests] (d) one wave of 4 plain rows beside presence 100, "
        f"frequency+repetition with logprobs 3, logprobs 5 greedy and sampled: plain "
        f"rows bit-equal to their wave alone; presence 100 repeated no token; every "
        f"top list sorted, the greedy token first with its chosen logprob; "
        f"launches {counts}")
    log(f"[serve-requests] (d) decode step, 8 slots, contiguous bf16, in a fresh "
        f"process: inert wave {inert['device_kernels_per_step']} kernels (the "
        f"parent's {PARENT_DECODE_KERNELS}), wall {inert['wall_ms_per_step']:.3f} ms, "
        f"busy {inert['device_busy_ms_per_step']:.3f} ms; "
        + "; ".join(f"{name} on every row: {p['device_kernels_per_step']} kernels, "
                    f"wall {p['wall_ms_per_step']:.3f} ms, busy "
                    f"{p['device_busy_ms_per_step']:.3f} ms, operands "
                    f"{p['pipeline_operands_ms']:.3f} ms"
                    for name, p in (("penalties + logprobs 5", active),
                                    ("a regex constraint", constrained)))
        + f"; {time.perf_counter() - t:.1f} s; {card}")


def fresh_decode_profiles(*requests: dict) -> list:
    """serving/decode_profile.py's ``profile`` of the diff recipe's
    steady decode step (8 slots of 256-token prompts, contiguous bf16),
    once per ``requests`` entry (further SamplingParams fields; a
    ``regex`` gets decode_profile's synthetic vocabulary), all in one
    new Python process; returns their measurements."""
    code = (
        "import json, sys\n"
        "from differential_transformer_replication_tpu_torch.config import ServingConfig\n"
        "from differential_transformer_replication_tpu_torch.serving import "
        "decode_profile as dp\n"
        "s = ServingConfig(num_slots=dp.SLOTS, prefill_chunk=128, prefill_budget=4096)\n"
        "V = dp.ModelConfig(model='diff').vocab_size\n"
        "for kw in json.loads(sys.argv[1]):\n"
        "    eng = dp.recipe_engine(s, vocab=dp.synthetic_vocab(V) if 'regex' in kw "
        "else None)\n"
        "    print(json.dumps(dp.profile(eng, dp.prompts_for(s, V), **kw)), flush=True)\n"
        "    del eng\n")
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(requests)],
                          cwd=Path(__file__).resolve().parent, capture_output=True,
                          text=True, timeout=300)
    expect(proc.returncode == 0, f"decode_profile process failed (exit "
           f"{proc.returncode}):\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines()[-len(requests):]]


# ---------------------------------------------------------------------------
# phase 3e: the fleet front: two port replicas behind the router
# ---------------------------------------------------------------------------

# every replica: the diff recipe (seed-0 weights), 8 slots, the paged pool
# with pages of 16 and the prefix cache, on the card
FLEET_ARGS = ["--model", "diff", "--recipe", "--num-slots", "8",
              "--kv-page-size", "16", "--drain-timeout", "60"]
FLEET_TTFT_N = 24      # requests timed direct and through the router
GATE_B_N = 2           # greedy requests the drain catches
GATE_B_NEW = 320       # tokens each generates
GATE_B_BUDGET_S = 2.0  # the drain's budget (RouterConfig.migrate_budget_s)
GATE_A_NEW = 96        # greedy tokens of each request the SIGKILL catches
GATE_A_PROMPT = 6      # their prompts' length (the load's are 8-64)
BURST = 96             # batch-class requests of the admission burst
BURST_NEW = 128        # greedy tokens of each
ADMIT_BOUND_S = 0.2    # admission_wait_bound_s (a batch request: half of it)
# (e) the control plane: the autoscaler steers on the windowed TTFT burn
# (its utilization gates off: util_high 1 is never exceeded and util_low
# above 1 always holds, since by (e) the replicas' prefix caches hold
# nearly every KV page, which the score reads as pressure); calm is 2
# client threads of short requests, pressure 32 threads of long ones
SCALE_POLL_S = 0.5
SCALE_TTFT_S = 0.5     # the objective's bound; slo_target 0.9
SCALE_FLAP_TICKS = 8   # the scale_flap window
CALM_CLIENTS, PRESS_CLIENTS, PRESS_NEW = 2, 32, 64
CANARY_WINDOW_S = 8.0
CANARY_REGRESS_S = "0.25"  # the canary's sleep per engine step (DTX_CANARY_REGRESS_S)
CANARY_TTFT_S = 0.2    # under every canary TTFT (one regress sleep at least)
CANARY_CLIENTS = 8


def _get_json(url: str, timeout: float = 30.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


def _ready(url: str) -> bool:
    try:
        with urllib.request.urlopen(url + "/ready", timeout=0.5) as r:
            return r.status == 200
    except (OSError, ValueError):
        return False


def _timed_post(url: str, body: dict) -> tuple:
    """(status, body, headers, seconds) of one POST, errors included."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            out = (r.status, json.load(r), dict(r.headers))
    except urllib.error.HTTPError as e:
        out = (e.code, json.loads(e.read() or b"{}"), dict(e.headers))
    except OSError as e:
        out = (-1, {"error": repr(e)}, {})
    return (*out, time.perf_counter() - t)


class _Load:
    """Client threads posting ``make(worker, k)`` bodies to ``url`` (no
    client-side retries) until stopped, or one each with ``once``; every
    reply is kept with its body and the monotonic time it arrived."""

    def __init__(self, url: str, n: int, make, once: bool = False,
                 stagger_s: float = 0.0):
        self.results, self._lock = [], threading.Lock()
        self._stop = threading.Event()

        def client(wid):
            # arrivals spread by stagger_s: the front's listen backlog is
            # the stdlib server's 5
            time.sleep(wid * stagger_s)
            k = 0
            while once or not self._stop.is_set():
                body = make(wid, k)
                status, reply, headers, _ = _timed_post(url, body)
                with self._lock:
                    self.results.append((body, status, reply, headers, time.monotonic()))
                k += 1
                if once:
                    return

        self.threads = [threading.Thread(target=client, args=(w,), daemon=True)
                        for w in range(n)]
        for t in self.threads:
            t.start()

    def join(self, timeout: float = 300.0) -> list:
        self._stop.set()
        for t in self.threads:
            t.join(timeout)
        expect(not any(t.is_alive() for t in self.threads),
               "serve-fleet: a client thread did not finish in time")
        return self.results


def _fleet_counts(work: Path) -> dict:
    """The kernel wrappers' launches summed over every replica process
    that ended on its own (a SIGKILLed process writes none)."""
    total, files = {}, sorted(work.glob("counts-*.json"))
    for f in files:
        for name, n in json.loads(f.read_text()).items():
            if name != "timeline":
                total[name] = total.get(name, 0) + n
    return {"files": len(files), **total}


def _timeline(work: Path, index: int, pid: int) -> dict:
    """The interpreter-start and torch-imported wall times that the
    replica process ``pid`` wrote when it ended."""
    f = work / f"counts-{index}-{pid}.json"
    return json.loads(f.read_text())["timeline"] if f.exists() else {}


def _watch_restart(fleet, router, idx: int, t_kill: float, url: str) -> dict:
    """Seconds from a SIGKILL to the router's ejection, the relaunch, the
    relaunched process's /ready, its first reply and the router's
    re-admission (the router's view is polled on a thread of its own, so
    the first reply's wait does not delay it); ``pid`` the new process."""
    from differential_transformer_replication_tpu_torch.serving.router import (
        EJECTED,
        UP,
    )

    rep = next(r for r in router.replicas if r.url == url)
    pid0 = fleet.replicas[idx].proc.pid
    t, end = {}, time.monotonic() + 240

    def router_view():
        while time.monotonic() < end and "readmitted" not in t:
            now = time.monotonic()
            if "ejected" not in t and rep.state == EJECTED:
                t["ejected"] = now - t_kill
            if "ejected" in t and rep.state == UP:
                t["readmitted"] = now - t_kill
            time.sleep(0.002)

    watcher = threading.Thread(target=router_view, daemon=True)
    watcher.start()
    while time.monotonic() < end and "first_reply" not in t:
        proc = fleet.replicas[idx].proc
        if "launch" not in t and proc is not None and proc.pid != pid0:
            t["launch"], t["pid"] = time.monotonic() - t_kill, proc.pid
        if "launch" in t and _ready(url):
            t["ready"] = time.monotonic() - t_kill
            _post(url + "/generate", {"prompt_ids": [1, 2, 3], "max_new_tokens": 1,
                                      "temperature": 0.0})
            t["first_reply"] = time.monotonic() - t_kill
        time.sleep(0.005)
    watcher.join(max(0.0, end - time.monotonic()))
    expect({"ejected", "launch", "ready", "first_reply", "readmitted"} <= set(t),
           f"serve-fleet: the killed replica's restart did not complete: {t}")
    return t


def _fmt_restart(t: dict, timeline: dict, t_kill_wall: float) -> str:
    """The restart's seconds after the SIGKILL, and its process's own
    split when it wrote one (interpreter start, torch imported)."""
    split = ""
    if timeline:
        start = t_kill_wall + t["launch"]
        split = (f" = interpreter start {timeline['module'] - start:.2f} s, torch "
                 f"import {timeline['torch'] - timeline['module']:.2f} s, the port's "
                 f"import, model, engine and HTTP up "
                 f"{t_kill_wall + t['ready'] - timeline['torch']:.2f} s")
    return (f"ejected {t['ejected']:.3f} s, relaunched {t['launch']:.2f} s, /ready "
            f"{t['ready']:.2f} s, first reply {t['first_reply']:.2f} s, re-admitted "
            f"{t['readmitted']:.2f} s after the SIGKILL (process start to ready "
            f"{t['ready'] - t['launch']:.2f} s{split}; ready to its first reply, the "
            f"kernels' first launches included, {t['first_reply'] - t['ready']:.2f} s)")


def _pin_and_load(router, rurl: str, src: str, tag: str, prompts: list, new: int) -> _Load:
    """One greedy request a prompt through the router's HTTP front, each
    on a session pinned to replica ``src``."""
    for i in range(len(prompts)):
        router.repin(f"{tag}{i}", src)
    return _Load(rurl, len(prompts), lambda w, k: {
        "prompt_ids": prompts[w], "max_new_tokens": new, "temperature": 0.0,
        "session_id": f"{tag}{w}"}, once=True)


def _inflight(url: str) -> list:
    try:
        return _get_json(url + "/inflight", 5.0).get("inflight", [])
    except OSError:
        return []


def run_serve_fleet(torch, card: str) -> None:
    """Phase 3e. Through ``serving/fleet.py``, two replicas of the port's
    server on this card (``FLEET_ARGS``; each replica runs the server's
    command line under ``--cli-worker`` so its kernel launches are
    written out when it ends), the port's router in this process with a
    50 ms probe interval. Both replicas report one ``config_hash`` and
    give one greedy reply to a probe prompt; the router's added latency
    is timed on idle replicas. (a) 4 client threads, greedy and sampled
    requests on sessions, through a rolling restart with
    ``pre_drain=router.migrate_out`` and then a SIGKILL: no failed
    reply, every reply attributed, the probe prompt's tokens unchanged
    on each replica. (c) gate A rides on that SIGKILL: greedy requests
    pinned to the victim and journaled mid-decode all finish by the
    replay rung (first differences from the run alone reported: replay
    rebuilds KV by prefill). (b) gate B: a drain by migration of greedy
    requests with far more decode left than its budget ends within the
    budget, every continuation bit-equal to its request run alone on the
    destination. (d) the four router faults
    in one plan, each seen in the router's counters and events, no
    request lost but the pick fault's typed 500; then a batch-class burst
    past capacity under ``admission_wait_bound_s``: every shed a 503
    ``admission_shed`` whose Retry-After is the controller's clamped
    predicted wait, and that wait beside the time the backlog took to
    clear. (e) the control plane on this fleet: ``fleet_autoscale`` (e1)
    and ``fleet_canary`` (e2); every replica slot, scaled-up and canary
    ones included, runs under ``--cli-worker``. Every kernel of the
    serving path launched in the replicas."""
    import random

    from differential_transformer_replication_tpu_torch.config import RouterConfig
    from differential_transformer_replication_tpu_torch.serving import fleet as tfleet
    from differential_transformer_replication_tpu_torch.serving.admission import (
        honest_retry_after,
    )
    from differential_transformer_replication_tpu_torch.serving.router import (
        UP,
        Router,
        serve_router,
    )
    from differential_transformer_replication_tpu_torch.utils import faults

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    work = Path(__file__).resolve().parent / "build" / "chip_smoke" / "fleet"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rng = random.Random(0)
    vocab = RECIPE["vocab_size"]

    def prompt(n):
        return [rng.randrange(vocab) for _ in range(n)]

    class CountedFleet(tfleet.Fleet):
        """Every replica slot the fleet builds, the first two, a scale-up's
        and a canary's alike (``_make_replica`` rebuilds a slot's command
        line for ``scale_up`` and ``relaunch_replica``), runs the server's
        command line under ``--cli-worker``, so its kernel launches are
        written out when it ends."""

        def _make_replica(self, index, port, server_args=None, extra_env=None):
            r = super()._make_replica(index, port, server_args=server_args,
                                      extra_env=extra_env)
            expect(r.argv[1:3] == ["-m", tfleet.SERVER_MODULE],
                   f"serve-fleet: replica {index} command line {r.argv}")
            r.argv = [sys.executable, str(Path(__file__).resolve()), "--cli-worker",
                      json.dumps({"cli": "serve", "argv": r.argv[3:],
                                  "out": str(work / f"counts-{index}-{{pid}}.json")})]
            return r

    fleet = CountedFleet(2, server_args=FLEET_ARGS, max_restarts=3, backoff_base=0.2,
                         backoff_max=2.0, ready_timeout_s=180.0,
                         fleet_log=str(work / "fleet.jsonl"))
    cfg = RouterConfig(probe_interval_s=0.05, probe_backoff_s=0.05,
                       probe_backoff_max_s=0.5, eject_after=2, readmit_after=2,
                       max_attempts=4, retry_base_s=0.02, retry_cap_s=0.2,
                       default_deadline_s=120.0, wait_for_replica_s=10.0,
                       migrate_budget_s=GATE_B_BUDGET_S)
    routers, servers = [], []

    def front(c, **kw):
        router = Router(fleet.urls, c, **kw)
        routers.append(router)
        httpd = serve_router(router, port=0)
        servers.append(httpd)
        threading.Thread(target=httpd.serve_forever, args=(0.05,), daemon=True).start()
        return router, f"http://127.0.0.1:{httpd.server_address[1]}/generate"

    try:
        t = time.perf_counter()
        fleet.start()
        t_start = time.perf_counter() - t
        urls = fleet.urls
        names = [u.split("//")[1] for u in urls]
        devices = [_get_json(u + "/health")["device"] for u in urls]
        expect(all(d.startswith("cuda") for d in devices),
               f"serve-fleet: replicas on {devices}, not the card")
        hashes = []
        for u in urls:
            info = [dict(lab) for (n, lab), _ in _metrics(u).items() if n == "build_info"]
            hashes.append(info[0]["config_hash"] if info else None)
        expect(hashes[0] is not None and hashes[0] == hashes[1],
               f"serve-fleet: config_hash {hashes}")
        probe = {"prompt_ids": prompt(16), "max_new_tokens": 24, "temperature": 0.0}
        before = [_post(u + "/generate", probe)[1]["tokens"] for u in urls]
        expect(before[0] == before[1],
               f"serve-fleet: the replicas' greedy replies differ {before}")
        log(f"[serve-fleet] 2 replicas of the port's server through serving/fleet.py "
            f"({' '.join(FLEET_ARGS)}), both up in {t_start:.1f} s from launch, on "
            f"{devices}, config_hash {hashes[0]} on both, one greedy reply to the "
            f"probe prompt; {card}")

        router, rurl = front(cfg)
        router.start()
        # the router's added latency: one-token requests on idle replica 0,
        # direct and through the router (its session pinned there), in turn
        router.repin("ttft", urls[0])
        direct, routed, d_ttft, r_ttft = [], [], [], []
        for i in range(FLEET_TTFT_N):
            body = {"prompt_ids": prompt(32), "max_new_tokens": 1, "temperature": 0.0}
            for which in ((0, 1) if i % 2 else (1, 0)):
                if which == 0:
                    s, b, _, dt = _timed_post(urls[0] + "/generate", body)
                    direct.append(dt)
                    d_ttft.append(b.get("ttft_ms", 0.0))
                else:
                    s, b, _, dt = _timed_post(rurl, dict(body, session_id="ttft"))
                    routed.append(dt)
                    r_ttft.append(b.get("ttft_ms", 0.0))
                    expect(b.get("replica") == names[0], f"serve-fleet: ttft reply {b}")
                expect(s == 200, f"serve-fleet: ttft request {s} {b}")
        md, mr = statistics.median(direct) * 1e3, statistics.median(routed) * 1e3
        log(f"[serve-fleet] router's added latency on an idle replica, {FLEET_TTFT_N} "
            f"one-token requests each way: client-side median {mr:.2f} ms through the "
            f"router vs {md:.2f} ms direct (+{mr - md:.2f} ms); the replica's own "
            f"ttft_ms median {statistics.median(r_ttft):.2f} vs "
            f"{statistics.median(d_ttft):.2f}; {card}")

        # (a) a rolling restart, then a SIGKILL, under load
        t_a = time.perf_counter()

        def load_body(wid, k):
            r = random.Random(wid * 1000 + k)
            return {"prompt_ids": [r.randrange(vocab) for _ in range(r.randint(8, 64))],
                    "max_new_tokens": 32, "temperature": 0.0 if k % 2 else 0.8,
                    "seed": wid * 1000 + k, "session_id": f"w{wid}"}

        load = _Load(rurl, 4, load_body)
        by_url = {rep.url: rep for rep in router.replicas}
        time.sleep(1.0)
        t = time.perf_counter()
        fleet.rolling_restart(ready_check=lambda r: by_url[r.url].eligible(),
                              pre_drain=router.migrate_out)
        t_roll = time.perf_counter() - t
        n_roll = len(load.results)
        # (c) gate A rides on this SIGKILL: greedy requests of a prompt
        # length the load never sends, pinned to replica 1, journaled
        ga = [prompt(GATE_A_PROMPT) for _ in range(4)]
        gate_a = _pin_and_load(router, rurl, urls[1], "ga", ga, GATE_A_NEW)

        def journaled():
            ents = [e for e in _inflight(urls[1])
                    if e.get("journal_id") and e.get("prompt_len") == GATE_A_PROMPT]
            return len(ents) == len(ga) and all(
                len(router.journal.tokens(e["journal_id"]) or []) >= 8 for e in ents)

        end = time.monotonic() + 60
        while time.monotonic() < end and not journaled():
            time.sleep(0.005)
        expect(journaled(), "serve-fleet (c): no journaled decode of gate A on replica 1")
        t_kill, wall_a = time.monotonic(), time.time()
        fleet.kill(1)
        kill_a = _watch_restart(fleet, router, 1, t_kill, urls[1])
        replayed = gate_a.join()
        time.sleep(1.0)
        results = load.join()
        bad = [(s, b) for _, s, b, _, _ in results if s != 200]
        expect(not bad and len(results) >= 20,
               f"serve-fleet (a): {len(bad)} failed of {len(results)}, first {bad[:3]}")
        unknown = [b for _, _, b, _, _ in results if b.get("replica") not in names]
        expect(not unknown, f"serve-fleet (a): unattributed replies {unknown[:2]}")
        after = [_post(u + "/generate", probe)[1]["tokens"] for u in urls]
        expect(after == before, "serve-fleet (a): the probe prompt's greedy tokens "
               f"changed across the restarts: {first_difference(before, after)}")
        rows = _fleet_ts(work)
        per = {}
        for i in range(2):
            drain = next(r["ts"] for r in rows
                         if r["event"] == "rolling_drain" and r["replica"] == i)
            up = next(r["ts"] for r in rows
                      if r["event"] == "launch" and r["replica"] == i and r["ts"] >= drain)
            done = next(r["ts"] for r in rows
                        if r["event"] == "rolling_done" and r["replica"] == i)
            per[i] = f"drain {up - drain:.2f} s, relaunch to re-admission {done - up:.2f} s"
        migr = {o: router._migration_counter.labels(outcome=o).value
                for o in ("migrated", "replayed", "migrate_failed")}
        log(f"[serve-fleet] (a) 4 client threads (greedy and sampled, 32 tokens, "
            f"sessions), no client retries: {len(results)} replies, all 200, every one "
            f"attributed; rolling restart with migrate_out pre-drain {t_roll:.1f} s "
            f"({n_roll} replies by its end; by replica {per}), then SIGKILL of replica 1 "
            f"(gate A's, below): {_fmt_restart(kill_a, {}, wall_a)}; router "
            f"retries {router._retry_counter.value:.0f}, ejections "
            f"{sum(router._eject_counter.labels(replica=n).value for n in names):.0f}, "
            f"ladder {migr}; the probe prompt's greedy tokens unchanged on both "
            f"replicas; {time.perf_counter() - t_a:.1f} s; {card}")

        expect(all(s == 200 and b.get("replayed") and b.get("replica") == names[0]
                   and len(b["tokens"]) == GATE_A_NEW for _, s, b, _, _ in replayed),
               f"serve-fleet (c): replies {[(s, b.get('code'), b.get('replayed')) for _, s, b, _, _ in replayed]}")
        got = {tuple(b["prompt_ids"]): b["tokens"] for _, _, b, _, _ in replayed}
        mine = [got[tuple(p)] for p in ga]
        ref = [_post(urls[0] + "/generate", {"prompt_ids": p, "max_new_tokens": GATE_A_NEW,
                                             "temperature": 0.0})[1]["tokens"] for p in ga]
        diffs = [first_difference([m], [r]) for m, r in zip(mine, ref)]
        log(f"[serve-fleet] (c) gate A: the SIGKILL of (a) caught {len(ga)} journaled "
            f"greedy requests of {GATE_A_NEW} tokens on replica 1: every one finished 200 "
            f"by the replay rung on replica 0; first difference from the request alone "
            f"there (request 0, position) {diffs} (replay rebuilds KV by prefill; None: "
            f"equal); {card}")

        # (b) gate B: drain replica 0 by migration
        t_b = time.perf_counter()
        for u in urls:  # the router sees both up before the drain
            rep = by_url[u]
            end = time.monotonic() + 60
            while rep.state != UP and time.monotonic() < end:
                time.sleep(0.01)
        gb = [prompt(12) for _ in range(GATE_B_N)]  # under a page: never a prefix hit
        m0 = [_metrics(u) for u in urls]
        load = _pin_and_load(router, rurl, urls[0], "gb", gb, GATE_B_NEW)
        end = time.monotonic() + 60
        while time.monotonic() < end and sum(
                len(e.get("tokens") or []) >= 8 for e in _inflight(urls[0])) < len(gb):
            time.sleep(0.005)
        drained = router.migrate_out(urls[0])
        t_drained = time.monotonic()
        results = load.join()
        m1 = [_metrics(u) for u in urls]

        def delta(i, name):
            return sum(v for (n, _), v in m1[i].items() if n == name) - \
                sum(v for (n, _), v in m0[i].items() if n == name)

        expect(drained["migrated"] == len(gb) and drained["drain_seconds"] <= GATE_B_BUDGET_S,
               f"serve-fleet (b): drain {drained} (budget {GATE_B_BUDGET_S} s)")
        expect(all(s == 200 and b.get("migrated") and b.get("replica") == names[1]
                   and len(b["tokens"]) == GATE_B_NEW for _, s, b, _, _ in results),
               f"serve-fleet (b): replies {[(s, b.get('code'), b.get('replica')) for _, s, b, _, _ in results]}")
        left = max(r[4] for r in results) - t_drained
        expect(left > GATE_B_BUDGET_S, f"serve-fleet (b): decode left after the drain "
               f"{left:.2f} s is not more than its budget {GATE_B_BUDGET_S} s")
        got = {tuple(b["prompt_ids"]): b["tokens"] for _, _, b, _, _ in results}
        t = time.perf_counter()
        ref = [_post(urls[1] + "/generate", {"prompt_ids": p, "max_new_tokens": GATE_B_NEW,
                                             "temperature": 0.0})[1]["tokens"] for p in gb]
        t_alone = (time.perf_counter() - t) / len(gb)
        mine = [got[tuple(p)] for p in gb]
        expect(mine == ref, "serve-fleet (b): a migrated continuation differs from its "
               f"request alone on the destination at {first_difference(mine, ref)}")
        pages = delta(0, "serving_migrate_pages_shipped_total")
        log(f"[serve-fleet] (b) gate B: replica 0 held {len(gb)} greedy requests of "
            f"{GATE_B_NEW} tokens; migrate_out moved {drained['migrated']} in "
            f"{drained['drain_seconds'] * 1e3:.1f} ms (budget {GATE_B_BUDGET_S * 1e3:.0f} "
            f"ms), {pages:.0f} pages shipped (+{delta(0, 'serving_migrate_pages_deduped_total'):.0f} "
            f"deduped), {delta(1, 'serving_migrate_imports_total'):.0f} imports on replica 1, "
            f"{drained['drain_seconds'] * 1e3 / max(pages, 1):.2f} ms a page; the "
            f"continuations decoded {left:.2f} s more on replica 1 (a request alone there: "
            f"{t_alone:.2f} s); every continuation bit-equal to its request alone on the "
            f"destination; {time.perf_counter() - t_b:.1f} s; {card}")

        # (d) the four router faults in one plan, hedging on (the main
        # router's prober stops first: the plan is this process's)
        t_d = time.perf_counter()
        router.close()
        end = time.monotonic() + 30
        while any(rep.probing for rep in router.replicas) and time.monotonic() < end:
            time.sleep(0.01)  # its last probes, each on a thread of its own
        events = _Recorder()
        os.environ[faults.ROUTER_HANG_ENV_VAR] = "0.5"
        router_d, durl = front(cfg.replace(hedge_factor=2.0, hedge_min_s=0.05,
                                           eject_after=1), events=events)
        faults.arm("router_probe_fail,router_stale_metrics,router_pick_raise,"
                   "router_replica_hang")
        for rep in router_d.replicas:  # one ejected by the probe fault, one unscraped
            router_d.probe(rep)
        states = [(rep.state, rep.metrics_t is None) for rep in router_d.replicas]
        router_d.start()
        end = time.monotonic() + 30
        while time.monotonic() < end and router_d.eligible_count() < 2:
            time.sleep(0.01)
        replies = [_timed_post(durl, {"prompt_ids": prompt(16), "max_new_tokens": 8,
                                      "temperature": 0.0}) for _ in range(8)]
        faults_left = faults.armed()
        faults.reset()
        os.environ.pop(faults.ROUTER_HANG_ENV_VAR, None)
        codes = [(s, b.get("code")) for s, b, _, _ in replies]
        ev = [e for e, _ in events.rows]
        hedged = [b for s, b, _, _ in replies if s == 200 and b.get("hedged")]
        expect(sorted(states) == [("ejected", True), ("up", True)]
               and router_d._eject_counter.labels(replica=names[0]).value
               + router_d._eject_counter.labels(replica=names[1]).value == 1
               and "replica_ejected" in ev and "replica_readmitted" in ev,
               f"serve-fleet (d): probe faults: states {states}, events {ev}")
        expect(codes[0] == (500, "internal") and all(c == (200, None) for c in codes[1:])
               and replies[1][1].get("hedged") and router_d._hedge_counter.value >= 1
               and router_d._hedge_win_counter.value >= 1 and "request_hedged" in ev
               and not faults_left,
               f"serve-fleet (d): replies {codes}, hedges {router_d._hedge_counter.value}, "
               f"events {ev}, plan left armed {faults_left}")
        log(f"[serve-fleet] (d) one plan of router_probe_fail, router_stale_metrics, "
            f"router_pick_raise and router_replica_hang (DTX_ROUTER_HANG_S 0.5, hedge "
            f"factor 2, floor 50 ms): first probes {states} ((state, body unscraped)), ejections 1, events "
            f"{sorted(set(ev))}; replies {codes}: the pick fault's typed 500, the hung "
            f"forward (the second request) rescued by its hedge, {len(hedged)} "
            f"replies hedged (hedges {router_d._hedge_counter.value:.0f}, wins "
            f"{router_d._hedge_win_counter.value:.0f}); no other request lost; {card}")

        # (d) admission: a batch-class burst past capacity
        router_e, eurl = front(cfg.replace(admission_wait_bound_s=ADMIT_BOUND_S,
                                           admission_rate_halflife_s=2.0))
        router_e.start()
        decisions = []
        admit = router_e.admission.admit

        def recording_admit(priority="normal"):
            d = admit(priority)
            decisions.append((time.monotonic(), priority, d))
            return d

        router_e.admission.admit = recording_admit
        # the warm wave goes to the replicas directly: the controller
        # measures the rate from their completion counters, and a bound
        # it already enforces must not shed the wave that measures it
        warm = [r for u in urls for r in _Load(
            u + "/generate", 16, lambda w, k: {"prompt_ids": prompt(32),
                                               "max_new_tokens": 64, "temperature": 0.0},
            once=True, stagger_s=0.005).join()]
        expect(all(s == 200 for _, s, _, _, _ in warm), "serve-fleet (d): warm wave "
               f"{sorted(set((s, b.get('code'), b.get('error', '')[:80]) for _, s, b, _, _ in warm))}")
        time.sleep(0.2)
        rate = router_e.admission.service_rate()
        t_burst = time.monotonic()
        burst = _Load(eurl, BURST, lambda w, k: {
            "prompt_ids": prompt(32), "max_new_tokens": BURST_NEW, "temperature": 0.0,
            "priority": "batch"}, once=True, stagger_s=0.005).join()
        shed = [(b, h) for _, s, b, h, _ in burst if s == 503]
        served = [r for r in burst if r[1] == 200]
        expect(len(shed) + len(served) == BURST and shed and served,
               f"serve-fleet (d): burst {sorted(set((s, b.get('code')) for _, s, b, _, _ in burst))}")
        sheds = [d for _, _, d in decisions if not d.admitted]
        for b, h in shed:
            # the decisions that gave this reply's reason (its wait to 2 places)
            mine = [d for d in sheds if "admission shed: " + d.reason == b.get("error")]
            expect(b.get("code") == "admission_shed" and any(
                d.retry_after_s == honest_retry_after(
                    d.predicted_wait_s, cfg.shed_retry_after_s,
                    cfg.admission_max_retry_after_s)
                and h.get("Retry-After") == str(max(1, int(d.retry_after_s)))
                for d in mine),
                f"serve-fleet (d): shed {b} with Retry-After {h.get('Retry-After')}, "
                f"decisions {mine}")
        first = min((t, d) for t, p, d in decisions if not d.admitted)
        cleared = max(r[4] for r in served) - first[0]
        log(f"[serve-fleet] (d) admission (admission_wait_bound_s {ADMIT_BOUND_S}, batch bound "
            f"{ADMIT_BOUND_S / 2} s, "
            f"rate halflife 2 s): measured rate {rate:.1f} req/s after a 32-request warm "
            f"wave sent to the replicas directly; a burst of {BURST} batch requests ({BURST_NEW} tokens): {len(served)} "
            f"served, "
            f"{len(shed)} shed 503 admission_shed, each with Retry-After equal to its "
            f"clamped predicted wait ({sorted(set(h['Retry-After'] for _, h in shed))} s); "
            f"at the first shed the predicted wait was {first[1].predicted_wait_s:.2f} s "
            f"and the admitted backlog cleared {cleared:.2f} s later "
            f"({time.monotonic() - t_burst:.1f} s after the burst began); "
            f"{time.perf_counter() - t_d:.1f} s for (d); {card}")

        # (e) the control plane over this fleet, through a router of its own
        t_e = time.perf_counter()
        for done in (router_d, router_e):
            done.close()
        router_f, furl = front(cfg)
        router_f.start()
        fleet_autoscale(fleet, router_f, furl, work, prompt, card)
        fleet_canary(fleet, router_f, furl, probe, before[0], prompt, card)
        log(f"[serve-fleet] (e) the control plane: {time.perf_counter() - t_e:.1f} s; "
            f"{card}")
    finally:
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()
        for router in routers:
            router.close()
        faults.reset()
        fleet.stop()
    log(f"[serve-fleet] restart after the SIGKILL of (a), replica 1: "
        f"{_fmt_restart(kill_a, _timeline(work, 1, kill_a['pid']), wall_a)}; {card}")
    counts = _fleet_counts(work)
    path = ("fused_add_norm", "fused_norm", "fused_swiglu", "decode_attention_paged")
    expect(counts["files"] >= 4 and all(counts.get(k, 0) > 0 for k in path),
           f"serve-fleet: replica launches {counts}")
    log(f"[serve-fleet] kernel launches in the replicas that ended by SIGTERM "
        f"({counts['files']} processes): " + ", ".join(f"{k} {counts[k]}" for k in path)
        + f"; phase {time.perf_counter() - t_phase:.1f} s; {card}")


def _fleet_ts(work: Path) -> list:
    """The fleet log's records (``fleet.jsonl``), each with its wall ``ts``."""
    return [json.loads(x) for x in (work / "fleet.jsonl").read_text().splitlines()]


def _streak(rows: list, tick: int, n: int) -> str:
    """The signals of the ``n`` ticks up to ``tick`` (the sustain that
    made its action)."""
    got = [r for r in rows if tick - n < r["tick"] <= tick]
    def burn(b):
        return "none" if b is None else f"{b:.3f}"

    return ", ".join(f"t{r['tick']} burn {burn(r['signals']['burn'])} util "
                     f"{r['signals']['util']:.3f}" for r in got)


def fleet_autoscale(fleet, router, furl: str, work: Path, prompt, card: str) -> None:
    """(e1) The port's ``Autoscaler`` in this process, polling ``router``'s
    ``/fleet/metrics`` over HTTP and acting through ``FleetActuator``,
    between 1 and 2 replicas, the router's registry, a ``--record`` file,
    under client load through the router in four stages: calm (it drains
    the least-loaded replica out by ``migrate_out`` and SIGTERM, no
    launch); ``scale_flap`` armed over a window of ticks (no scale action
    in it); pressure (one launch and ``add_replica``); pressure held at 2
    (it holds at max_replicas). No failed reply, one ``up`` and one
    ``down``, the ``autoscaler_*`` families on the router's ``/metrics``,
    and the record replaying to the live decisions byte for byte."""
    from differential_transformer_replication_tpu_torch.config import AutoscalerConfig
    from differential_transformer_replication_tpu_torch.serving import autoscaler as tas
    from differential_transformer_replication_tpu_torch.utils import faults

    base = furl.rsplit("/", 1)[0]
    t_e1 = time.perf_counter()
    end = time.monotonic() + 60
    while router.eligible_count() < 2 and time.monotonic() < end:
        time.sleep(0.01)
    expect(router.eligible_count() == 2, "serve-fleet (e1): the router never saw both up")
    acfg = AutoscalerConfig(
        poll_interval_s=SCALE_POLL_S, min_replicas=1, max_replicas=2,
        scale_up_burn=1.0, scale_down_burn=0.5, scale_up_sustain=2,
        scale_down_sustain=4, cooldown_up_s=2.0, cooldown_down_s=60.0,
        util_high=1.0, util_low=1.01, ttft_threshold_s=SCALE_TTFT_S,
        itl_threshold_s=1.0, slo_target=0.9)
    record = work / "scaler.jsonl"
    events = _Recorder()
    mono0, wall0 = time.monotonic(), time.time()
    n_logged = len(_fleet_ts(work))
    scaler = tas.Autoscaler(
        acfg, poll=lambda: tas._http_poll(base + "/fleet/metrics"),
        actuator=tas.FleetActuator(fleet, router), registry=router.registry,
        events=events, record_path=str(record))
    expect(scaler.current == 2, f"serve-fleet (e1): the scaler starts at {scaler.current}")
    stop = threading.Event()
    loop = threading.Thread(target=scaler.run, args=(stop,), daemon=True)
    calm = _Load(furl, CALM_CLIENTS, lambda w, k: {
        "prompt_ids": prompt(16), "max_new_tokens": 8, "temperature": 0.0},
        stagger_s=0.1)
    loads, press = [calm], None

    def scaled(action):
        return [t for (e, kw), t in zip(events.rows, events.times)
                if e == "autoscaler_scaled" and kw["action"] == action]

    def wait_for(cond, timeout, what):
        end = time.monotonic() + timeout
        while not cond() and time.monotonic() < end:
            failed = [kw for e, kw in events.rows if e == "autoscaler_scale_failed"]
            expect(not failed, f"serve-fleet (e1): a scale failed {failed}")
            time.sleep(0.005)
        expect(cond(), f"serve-fleet (e1): {what} within {timeout} s")

    try:
        loop.start()
        # 1. calm: one down, by drain, no launch
        wait_for(lambda: scaled("down"), 90, "no scale-down under calm")
        expect(len(fleet.replicas) == 1 and len(router.replicas) == 1
               and not any(r["event"] in ("launch", "scale_up")
                           for r in _fleet_ts(work)[n_logged:]),
               f"serve-fleet (e1): after the scale-down {fleet.urls}, router "
               f"{[r.url for r in router.replicas]}")
        # 2. scale_flap over a window of ticks
        flap_a = scaler._tick + 2
        flap_b = flap_a + SCALE_FLAP_TICKS - 1
        faults.arm(f"scale_flap@{flap_a}-{flap_b}")
        wait_for(lambda: scaler._tick > flap_b + 1, 30, "the flap window did not pass")
        faults.reset()
        # 3. pressure: one launch, added to the router and admitted
        press = _Load(furl, PRESS_CLIENTS, lambda w, k: {
            "prompt_ids": prompt(32), "max_new_tokens": PRESS_NEW, "temperature": 0.0},
            stagger_s=0.02)
        loads.append(press)
        wait_for(lambda: scaled("up"), 120, "no scale-up under pressure")
        new = max(fleet.replicas, key=lambda r: r.index)
        rep = next(x for x in router.replicas if x.url == new.url)
        wait_for(rep.eligible, 60, "the scaled-up replica was not admitted")
        t_admitted = time.monotonic()
        # 4. pressure held at max_replicas
        up_tick = next(kw["tick"] for e, kw in events.rows
                       if e == "autoscaler_decision" and kw["action"] == "up")
        wait_for(lambda: any(e == "autoscaler_decision" and kw["tick"] > up_tick
                             and "at max_replicas" in kw["reason"]
                             for e, kw in events.rows),
                 60, "no hold at max_replicas under held pressure")
    finally:
        stop.set()
        loop.join(60)
        scaler.close()
        faults.reset()
        results = [r for ld in loads for r in ld.join()]
    expect(not loop.is_alive(), "serve-fleet (e1): the scaler loop did not stop")
    bad = [(s, b.get("code"), b.get("error", "")[:80]) for _, s, b, _, _ in results if s != 200]
    expect(not bad, f"serve-fleet (e1): {len(bad)} failed of {len(results)}, first {bad[:3]}")
    decisions = [kw for e, kw in events.rows if e == "autoscaler_decision"]
    actions = [d["action"] for d in decisions]
    expect(actions.count("up") == 1 and actions.count("down") == 1,
           f"serve-fleet (e1): {actions.count('up')} up and {actions.count('down')} down "
           f"decisions")
    in_window = [d for d in decisions if flap_a <= d["tick"] <= flap_b]
    rows = [json.loads(x) for x in record.read_text().splitlines() if x]
    flapped = [(r["signals"]["burn"], r["signals"]["util"]) for r in rows
               if flap_a <= r["tick"] <= flap_b]
    expect(len(in_window) == SCALE_FLAP_TICKS and all(d["action"] == "hold" for d in in_window)
           and flapped == [(99.0, 1.0) if t % 2 == 0 else (0.0, 0.0)
                           for t in range(flap_a, flap_b + 1)],
           f"serve-fleet (e1): the flap window {in_window}, signals {flapped}")
    live = [json.dumps(r["decision"]) for r in rows]
    replayed = [json.dumps(d.to_row()) for d in tas.replay(rows, acfg, initial_replicas=2)]
    expect(len(rows) == len(decisions) and replayed == live,
           f"serve-fleet (e1): the record ({len(rows)} rows, {len(decisions)} decisions) "
           "does not replay to the live decisions")
    vals = _metrics(base)
    fams = {n for n, _ in vals}
    want = {"autoscaler_replicas_target", "autoscaler_burn_observed",
            "autoscaler_util_observed", "autoscaler_decisions_total"}
    expect(want <= fams and vals[("autoscaler_decisions_total", (("action", "up"),))] == 1
           and vals[("autoscaler_decisions_total", (("action", "down"),))] == 1
           and vals[("autoscaler_replicas_target", ())] == 2,
           f"serve-fleet (e1): the router's /metrics {sorted(f for f in fams if 'autoscaler' in f)}")
    # decision to effect: the fleet log's wall stamps against the record's clock
    log_rows = _fleet_ts(work)[n_logged:]
    down = next(r for r in rows if r["decision"]["action"] == "down")
    up = next(r for r in rows if r["decision"]["action"] == "up")

    def wall(t):
        return t - mono0 + wall0

    drain = next(r for r in log_rows if r["event"] == "scale_down_drain")
    done = next(r for r in log_rows if r["event"] == "scale_down_done")
    migr = next((r for r in log_rows if r["event"] == "drain_migrate"), {})
    launch = next(r for r in log_rows if r["event"] == "launch" and r["replica"] == new.index)
    log(f"[serve-fleet] (e1) autoscaler between 1 and 2 replicas (poll {SCALE_POLL_S} s, "
        f"up after 2 ticks over burn 1, down after 4 under burn 0.5, cooldowns 2 s up and "
        f"60 s down, TTFT objective {SCALE_TTFT_S} s at target 0.9, the utilization "
        f"gates off), {len(rows)} ticks; {card}")
    log(f"[serve-fleet] (e1) down at tick {down['tick']} on [{_streak(rows, down['tick'], 4)}]: "
        f"replica {drain['replica']} the victim {drain['ts'] - wall(down['now']):.3f} s after "
        f"the decision, migrate_out moved {migr.get('migrated', 0)}, drained and exited "
        f"{done['ts'] - wall(down['now']):.2f} s, out of the router "
        f"{scaled('down')[0] - down['now']:.2f} s after it; no launch; {card}")
    log(f"[serve-fleet] (e1) scale_flap@{flap_a}-{flap_b}: {len(in_window)} ticks, every "
        f"one a hold (burn, util alternating {flapped[:2]}); {card}")
    log(f"[serve-fleet] (e1) up at tick {up['tick']} on [{_streak(rows, up['tick'], 2)}] "
        f"({PRESS_CLIENTS} client threads of {PRESS_NEW} tokens): replica {new.index} "
        f"launched {launch['ts'] - wall(up['now']):.3f} s after the decision, ready and in "
        f"the router {scaled('up')[0] - up['now']:.2f} s, admitted "
        f"{t_admitted - up['now']:.2f} s after it; then at max_replicas: "
        f"{next(d['reason'] for d in decisions if d['tick'] > up['tick'] and 'at max_replicas' in d['reason'])}; {card}")
    log(f"[serve-fleet] (e1) {len(results)} replies, all 200; one up and one down of "
        f"{len(decisions)} decisions; autoscaler_* on the router's /metrics; the record "
        f"replayed to the live decisions byte for byte; {time.perf_counter() - t_e1:.1f} s; "
        f"{card}")


def fleet_canary(fleet, router, furl: str, probe: dict, want: list, prompt,
                 card: str) -> None:
    """(e2) ``CanaryController.run`` relaunches the highest-index replica
    with ``canary_regress`` in its ``DTX_FAULTS`` under load through the
    router: the verdict is a rollback for the burn or p95 regression, not
    thin evidence; the replica comes back on its exact previous argv and
    env, its probe tokens unchanged; no failed reply."""
    from differential_transformer_replication_tpu_torch.config import AutoscalerConfig
    from differential_transformer_replication_tpu_torch.serving import autoscaler as tas

    t_e2 = time.perf_counter()
    r = max(fleet.replicas, key=lambda x: x.index)
    end = time.monotonic() + 60
    while router.eligible_count() < 2 and time.monotonic() < end:
        time.sleep(0.01)
    before = _post(r.url + "/generate", probe)[1]["tokens"]
    expect(before == want, "serve-fleet (e2): the canary replica's probe tokens differ "
           f"from the fleet's at {first_difference([before], [want])}")
    argv0, env0 = list(r.argv), (dict(r.env) if r.env is not None else None)
    ccfg = AutoscalerConfig(canary_fraction=0.5, canary_window_s=CANARY_WINDOW_S,
                            canary_min_requests=8, ttft_threshold_s=CANARY_TTFT_S,
                            slo_target=0.9, canary_max_burn=1.0, canary_max_regress=0.5)
    events = _Recorder()
    load = _Load(furl, CANARY_CLIENTS, lambda w, k: {
        "prompt_ids": prompt(16), "max_new_tokens": 8, "temperature": 0.0},
        stagger_s=0.05)
    try:
        rec = tas.CanaryController(fleet, router, ccfg, events=events).run(
            index=r.index, extra_env={"DTX_FAULTS": "canary_regress",
                                      "DTX_CANARY_REGRESS_S": CANARY_REGRESS_S})
        time.sleep(1.0)  # serve a little while healed
    finally:
        results = load.join()
    at = {e: t for (e, _), t in zip(events.rows, events.times)}
    bad = [(s, b.get("code"), b.get("error", "")[:80]) for _, s, b, _, _ in results if s != 200]
    expect(not bad, f"serve-fleet (e2): {len(bad)} failed of {len(results)}, first {bad[:3]}")
    c, ctl = rec["canary"], rec["control"]
    expect(rec["verdict"] == "rollback" and c["count"] >= ccfg.canary_min_requests
           and not rec["reason"].startswith("inconclusive")
           and ("burn rate" in rec["reason"] or "p95" in rec["reason"]),
           f"serve-fleet (e2): verdict {rec['verdict']}: {rec['reason']} ({c['count']} "
           "canary requests)")
    expect(r.argv == argv0 and r.env == env0 and router.canary() == (None, 0.0)
           and "canary_rolled_back" in at,
           f"serve-fleet (e2): after the rollback argv {r.argv == argv0}, env "
           f"{r.env == env0}, split {router.canary()}, events {sorted(at)}")
    after = _post(r.url + "/generate", probe)[1]["tokens"]
    expect(after == before, "serve-fleet (e2): the probe tokens changed across the "
           f"rollout at {first_difference([before], [after])}")

    def num(x, unit=""):
        return "none" if x is None else f"{x:.3f}{unit}"

    log(f"[serve-fleet] (e2) canary on replica {r.index} (canary_regress, "
        f"DTX_CANARY_REGRESS_S {CANARY_REGRESS_S}, fraction 0.5, window "
        f"{CANARY_WINDOW_S:.0f} s, TTFT objective {CANARY_TTFT_S} s at target 0.9, "
        f"{CANARY_CLIENTS} client threads): window counts canary {c['count']:.0f}, control "
        f"{ctl['count']:.0f}; p95 TTFT canary {num(c['p95_ttft_s'], ' s')} against control "
        f"{num(ctl['p95_ttft_s'], ' s')} (histogram bucket edges); burn canary "
        f"{num(c['burn_rate'])}, control {num(ctl['burn_rate'])}; verdict {rec['verdict']}: {rec['reason']}; {card}")
    log(f"[serve-fleet] (e2) relaunch to the split {at['canary_judged'] - at['canary_started'] - CANARY_WINDOW_S:.2f} s "
        f"(the canary's drain, launch, ready and re-admission), the window "
        f"{CANARY_WINDOW_S:.0f} s; the judgment to the rollback ready and re-admitted "
        f"{at['canary_rolled_back'] - at['canary_judged']:.2f} s; back on its exact argv "
        f"and env (no DTX_FAULTS), the probe prompt's greedy tokens unchanged; "
        f"{len(results)} replies, all 200; {time.perf_counter() - t_e2:.1f} s; {card}")


class _Recorder:
    """An in-memory event sink (obs/events.py surface); ``times`` holds
    the monotonic time each row arrived."""

    def __init__(self):
        self.rows, self.times = [], []

    def emit(self, event, **fields):
        self.times.append(time.monotonic())
        self.rows.append((event, fields))

    def flush(self):
        pass

    def close(self):
        pass


# ---------------------------------------------------------------------------
# phase 4: the card's kernels against the CPU's plain versions, end to end
# ---------------------------------------------------------------------------


def run_e2e(torch) -> None:
    """Prefill of one 64-token prompt and 8 teacher-forced decode steps
    of the diff recipe in fp32, on the card (kernels) and on the CPU
    (plain versions), from the same weights."""
    import numpy as np

    from differential_transformer_replication_tpu_torch.config import ModelConfig
    from differential_transformer_replication_tpu_torch.models import common, init_model
    from differential_transformer_replication_tpu_torch.models.decode import (
        forward_chunk,
        forward_decode_pool,
        init_cache,
    )

    cfg = ModelConfig(**RECIPE, compute_dtype="float32")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    params = init_model(gen, cfg)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, 64)
    feed = rng.integers(0, cfg.vocab_size, 8)
    logits = {}
    for dev in ("cuda", "cpu"):
        p = common.inference_params(params, torch.float32, dev)
        cache = init_cache(cfg, 1, dev)
        out, _ = forward_chunk(p, torch.as_tensor(prompt, device=dev)[None],
                               0, cache, cfg)
        steps = [out[0, -1]]
        for t, tok in enumerate(feed):
            out, _ = forward_decode_pool(
                p, torch.as_tensor([tok], device=dev),
                torch.as_tensor([64 + t], dtype=torch.int32, device=dev),
                cache, cfg)
            steps.append(out[0])
        logits[dev] = torch.stack(steps).to("cpu", torch.float32)
    card, host = logits["cuda"], logits["cpu"]
    err = float((card - host).abs().max())
    scale = float(host.abs().max())
    tol = 1e-3  # fp32 through 8 layers, sums in another order on each side
    log(f"[e2e] diff recipe fp32, prefill 64 + 8 decode steps: max-abs logit "
        f"difference card vs CPU {err:.3g} (bound {tol:g}; max |logit| "
        f"{scale:.3g})")
    expect(bool(torch.isfinite(card).all()), "non-finite logits")
    expect(err <= tol, f"card and CPU logits differ by {err:.3g} > {tol:g}")
    run_e2e_paged(torch)


def run_e2e_paged(torch) -> None:
    """A 2-layer diff model at recipe width in fp32, one slot on a paged
    pool behind a scrambled table (pages of 16): prefill through
    gather/scatter_slot_cache, 4 paged L=1 steps
    (``forward_decode_pool_paged``), then 2 batched verify blocks of 5
    rows (``forward_decode_spec_paged``), on the card and on the CPU."""
    import numpy as np

    from differential_transformer_replication_tpu_torch.config import ModelConfig
    from differential_transformer_replication_tpu_torch.models import common, init_model
    from differential_transformer_replication_tpu_torch.models.decode import (
        forward_chunk,
        forward_decode_pool_paged,
        forward_decode_spec_paged,
        gather_slot_cache,
        init_cache_paged,
        scatter_slot_cache,
    )

    cfg = ModelConfig(**dict(RECIPE, n_layer=2), compute_dtype="float32")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)
    params = init_model(gen, cfg)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, 64)
    feed = rng.integers(0, cfg.vocab_size, 4)
    blocks = rng.integers(0, cfg.vocab_size, (2, 5))
    ps = 16
    pp = cfg.block_size // ps
    P = 1 + pp + 3
    tab = (1 + rng.permutation(P - 1)[:pp]).astype(np.int32)[None]
    logits = {}
    for dev in ("cuda", "cpu"):
        p = common.inference_params(params, torch.float32, dev)
        cache = init_cache_paged(cfg, P, ps, dev)
        t = torch.as_tensor(tab, device=dev)
        row = gather_slot_cache(cache, t[0])
        out, _ = forward_chunk(p, torch.as_tensor(prompt, device=dev)[None], 0, row, cfg)
        scatter_slot_cache(cache, row, t[0])
        steps, pos = [out[0, -1]], len(prompt)
        for tok in feed:
            out, _ = forward_decode_pool_paged(
                p, torch.as_tensor([tok], device=dev),
                torch.as_tensor([pos], dtype=torch.int32, device=dev), cache, t,
                torch.as_tensor([tab[0, pos // ps]], device=dev), cfg)
            steps.append(out[0])
            pos += 1
        for blk in blocks:
            vpos = pos + np.arange(len(blk), dtype=np.int32)
            out, _ = forward_decode_spec_paged(
                p, torch.as_tensor(blk, device=dev)[None],
                torch.as_tensor(vpos, device=dev)[None], cache, t,
                torch.as_tensor(tab[0, vpos // ps], device=dev)[None], cfg,
                batched=True)
            steps.extend(out[0])
            pos += len(blk)
        logits[dev] = torch.stack(steps).to("cpu", torch.float32)
    card, host = logits["cuda"], logits["cpu"]
    err = float((card - host).abs().max())
    tol = 1e-3  # fp32 through 2 layers, sums in another order on each side
    log(f"[e2e] paged: 2-layer diff at recipe width fp32, prefill 64, 4 paged "
        f"steps, 2 batched verify blocks of 5 rows: max-abs logit difference "
        f"card vs CPU {err:.3g} (bound {tol:g}; max |logit| "
        f"{float(host.abs().max()):.3g})")
    expect(bool(torch.isfinite(card).all()), "non-finite paged logits")
    expect(err <= tol, f"paged card and CPU logits differ by {err:.3g} > {tol:g}")


# ---------------------------------------------------------------------------
# phase 2, continued: the training kernels against their plain versions
# ---------------------------------------------------------------------------

SRC = "differential_transformer_replication_tpu_torch/"
TPU = "differential_transformer_replication_tpu/ops/"

# (name, S, H, d, dv, packed): the three recipes' attention shapes
TM_CONFIGS = (("diff", 2, 4, 96, 192, True), ("control", 1, 8, 96, 96, False),
              ("ndiff", 4, 4, 96, 192, False))


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def tm_operands(torch, gen, dtype, B, T, S, H, d, dv, packed):
    W = 2 * S * H * d + H * dv
    proj = torch.randn(B, T, W, generator=gen, device="cuda").to(dtype)
    Hd = H * d
    qs = [proj[..., s * Hd:(s + 1) * Hd] for s in range(S)]
    ks = [proj[..., (S + s) * Hd:(S + s + 1) * Hd] for s in range(S)]
    v = proj[..., 2 * S * Hd:]
    if not packed:
        qs = [t.contiguous() for t in qs]
        ks = [t.contiguous() for t in ks]
        v = v.contiguous()
    c = 0.5 * torch.randn(S, H, generator=gen, device="cuda")
    c[0] = 1.0
    return proj, qs, ks, v, c


def run_train_kernels(torch, ops) -> dict:
    """Phase 2 for the training kernels D, E, F, G. Returns {name: json
    entry sans launches}."""
    from differential_transformer_replication_tpu_torch import testing
    fnr, ffn, flash = ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    entries = {}
    B, T = TRAIN_B, RECIPE["block_size"]
    for name, S, H, d, dv, packed in TM_CONFIGS:
        for dtype in (torch.float32, torch.bfloat16):
            es = torch.finfo(dtype).bits // 8
            proj, qs, ks, v, c = tm_operands(torch, gen, dtype, B, T, S, H, d,
                                             dv, packed)
            out, o_all, lse = flash.flash_tm_fwd(qs, ks, v, c, H, True)
            r_out, r_oall, r_lse = flash.tm_attention_fwd_reference(qs, ks, v, c, H)
            g = torch.randn(B, T, H * dv, generator=gen, device="cuda").to(dtype)
            base = torch.einsum("bthd,bhstd->bths",
                                g.float().reshape(B, T, H, dv), r_oall.float())
            delta = (base * c.t()[None, None]).reshape(B, T, H * S).contiguous()
            grads = [torch.empty(B, T, H * d, dtype=dtype, device="cuda")
                     for _ in range(2 * S)]
            dv_ = torch.empty(B, T, H * dv, dtype=dtype, device="cuda")
            bwd_args = (qs, ks, v, g, r_lse, delta, c, H)
            flash.flash_tm_bwd(*bwd_args, grads[:S], grads[S:], dv_)
            rq, rk, rv = flash.tm_attention_bwd_reference(*bwd_args)
            torch.cuda.synchronize()
            f_err = max(max_err(out, r_out), max_err(o_all, r_oall))
            l_err = max_err(lse, r_lse)
            b_errs = [max_err(a, b) for a, b in zip([*grads, dv_], [*rq, *rk, rv])]
            # row by row (testing.py), one row per (token, head)
            def heads(t):
                return t.reshape(B, T, H, -1).transpose(1, 2).reshape(B * H, T, -1)
            f_ratio = max(testing.attention_fwd_ratios(
                heads(out), o_all.reshape(B * H, S, T, dv), heads(r_out),
                r_oall.reshape(B * H, S, T, dv), c.t().repeat(B, 1)))
            b_ratio = max(testing.grad_ratio(heads(a), heads(b))
                          for a, b in zip([*grads, dv_], [*rq, *rk, rv]))
            l_tol = 1e-5 * (1.0 if dtype == torch.float32 else float(r_lse.abs().max()))
            expect(f_ratio <= 1.0 and l_err <= l_tol,
                   f"flash_tm_fwd {name} {dtype}: worst row at {f_ratio:.3g} of its "
                   f"bound (max-abs {f_err:.3g}), lse {l_err:.3g} (bound {l_tol:.3g})")
            expect(b_ratio <= 1.0, f"flash_tm_bwd {name} {dtype}: worst row at "
                   f"{b_ratio:.3g} of its bound (max-abs {max(b_errs):.3g})")
            b_err = max(b_errs)
            log(f"[kernels] flash_tm {name} {str(dtype)[6:]} B={B} T={T} S={S} "
                f"H={H} d={d} dv={dv} {'packed' if packed else 'per-array'}: "
                f"fwd max-abs {f_err:.3g} (worst row at {f_ratio:.3g} of its bound), "
                f"lse {l_err:.3g}; bwd max-abs {b_err:.3g} (worst row at "
                f"{b_ratio:.3g} of its bound)")
            if dtype != torch.bfloat16:
                continue
            # times, bf16: forward with residuals and the backward
            _, fwd_bytes, fwd_flops = testing.attention_work(B, H, S, T, d, dv, 0, "fwd", es)
            lib = None
            if S == 1:  # one causal softmax stream: SDPA computes it
                qt, kt, vt = (t.reshape(B, T, H, -1).transpose(1, 2)
                              for t in (qs[0], ks[0], v))
                lib = [lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)]
            t = timings([lambda: flash.flash_tm_fwd(qs, ks, v, c, H, True)],
                        [lambda: flash.tm_attention_fwd_reference(qs, ks, v, c, H)],
                        lib, **few(True))
            bms, by = bound_ms(fwd_bytes, fwd_flops, dtype)
            log(f"[kernels] flash_tm_fwd {name} bf16: " + fmt_times(t, bms, by)
                + ("; one-call PyTorch is SDPA" if lib else
                   "; no one-call PyTorch equivalent (multi-stream combine)"))
            if name == "diff":
                entries["flash_tm_fwd"] = dict(
                    name="flash_tm_fwd", route="cuda", source=SRC + "csrc/flash_tm.cu",
                    replaces=TPU + "flash.py:1945", max_abs_err=f_err,
                    ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=bms,
                    bound_by=by, library_ms=t["library_ms"])
            _, bwd_bytes, bwd_flops = testing.attention_work(B, H, S, T, d, dv, 0, "bwd", es)
            t = timings([lambda: flash.flash_tm_bwd(*bwd_args, grads[:S], grads[S:], dv_)],
                        [lambda: flash.tm_attention_bwd_reference(*bwd_args)],
                        None, **few(True))
            bms, by = bound_ms(bwd_bytes, bwd_flops, dtype)
            lib_note = "; no one-call PyTorch equivalent"
            if S == 1:
                # SDPA's backward on the same operands, by CUDA-graph
                # replay like the kernel: the graph of forward + backward
                # (one autograd.grad) less the forward's device time
                qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
                gt = g.reshape(B, T, H, -1).transpose(1, 2)
                sdpa = torch.nn.functional.scaled_dot_product_attention
                lib_fb = device_ms([lambda: torch.autograd.grad(
                    sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg), gt)],
                    **few(True))
                lib_b = lib_fb - device_ms(
                    [lambda: sdpa(qt, kt, vt, is_causal=True)], **few(True))
                lib_note = (f"; one-call PyTorch (SDPA backward: graph of forward "
                            f"+ backward less the forward) {lib_b * 1e3:.2f} us")
                del qg, kg, vg, gt
            log(f"[kernels] flash_tm_bwd {name} bf16: " + fmt_times(t, bms, by)
                + lib_note)
            if name == "diff":
                entries["flash_tm_bwd"] = dict(
                    name="flash_tm_bwd", route="cuda", source=SRC + "csrc/flash_tm.cu",
                    replaces=TPU + "flash.py:2118", max_abs_err=b_err,
                    ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=bms,
                    bound_by=by, library_ms=None)
            del proj, qs, ks, v, out, o_all, lse, r_out, r_oall, r_lse, grads
            del base, delta, g, dv_, rq, rk, rv, bwd_args

    # F: add+LayerNorm backward (CUDA), with the carry cotangent (the
    # add+ln2 in front of each FFN) and without (ln1, the GroupLayerNorm,
    # ln_f), at the training rows; each form against its own byte bound,
    # two calls bit-equal, the launches of a call split by the profiler;
    # beside the form without the carry the yardstick
    # aten.native_layer_norm_backward fed native_layer_norm's mean and
    # rstd (it does not recompute the statistics: not the same function;
    # with params in the rows' dtype, as aten refuses bf16 rows with fp32
    # params)
    M, E = TRAIN_M, RECIPE["n_embd"]
    aten = torch.ops.aten
    # its quotients (one reciprocal a row, an FMA correction each) against
    # IEEE division, on 2^30 operand pairs per mode
    from differential_transformer_replication_tpu_torch.ops import _kernels
    for mode in (0, 1):
        bad = torch.zeros(1, dtype=torch.int64, device="cuda")
        _kernels.check(_kernels.load("fused_norm_residual").fused_norm_residual_quot_check(
            bad.data_ptr(), 65536, 7 + mode, mode, _kernels.stream_handle(bad.device)),
            "quotient check")
        expect(int(bad) == 0, f"add_norm_bwd quotients differ from IEEE division in "
               f"{int(bad)} of 2^30 pairs (mode {mode})")
        log(f"[kernels] add_norm_bwd quotients, mode {mode}: 2^30 pairs, all equal to "
            "IEEE division bit for bit")
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.finfo(dtype).bits // 8
        x, gn, gx = (torch.randn(M, E, generator=gen, device="cuda").to(dtype)
                     for _ in range(3))
        w = 1.0 + 0.1 * torch.randn(E, generator=gen, device="cuda")
        b = 0.1 * torch.randn(E, generator=gen, device="cuda")
        inst = fnr.add_norm_bwd_instance(dtype, E)
        for carry in (True, False):
            g2 = gx if carry else None
            form = "with the carry cotangent" if carry else "without the carry"
            i0 = fnr.add_norm_bwd.instances[inst]
            dx, dw, db = fnr.add_norm_bwd(x, w, gn, g2)
            expect(fnr.add_norm_bwd.instances[inst] - i0 == 1,
                   f"add_norm_bwd {dtype}: instance {inst} did not run")
            rdx, rdw, rdb = fnr.add_norm_bwd_reference(x, w, gn, g2)
            err = max_err(dx, rdx)
            p_err = max(max_err(dw, rdw) / float(rdw.abs().max()),
                        max_err(db, rdb) / float(rdb.abs().max()))
            tol = (1e-5 * float(rdx.abs().max()) if dtype == torch.float32
                   else bf16_ulp_bound(rdx.float()))
            expect(err <= tol and p_err <= 1e-4,
                   f"add_norm_bwd {dtype} {form}: dx max-abs {err:.3g} (bound "
                   f"{tol:.3g}), dw/db relative {p_err:.3g} (bound 1e-4)")
            # no float atomics: a second call gives the same results bit for bit
            again = fnr.add_norm_bwd(x, w, gn, g2)
            expect(all(torch.equal(a, b_) for a, b_ in zip((dx, dw, db), again)),
                   f"add_norm_bwd {dtype} {form}: two calls differ")
            lib_calls = None
            if not carry:
                wl, bl = w.to(dtype), b.to(dtype)
                mean, rstd = aten.native_layer_norm(x, (E,), wl, bl, 1e-5)[1:]
                lib_calls = [lambda: aten.native_layer_norm_backward(
                    gn, x, (E,), mean, rstd, wl, bl, [True, True, True])]
            t = timings([lambda: fnr.add_norm_bwd(x, w, gn, g2)],
                        [lambda: fnr.add_norm_bwd_reference(x, w, gn, g2)], lib_calls)
            parts = kernel_us([lambda: fnr.add_norm_bwd(x, w, gn, g2)],
                              ("addnorm_bwd_warp", "addnorm_bwd_block",
                               "addnorm_bwd_finish"))
            # x, gn (, gx) read and dx written once, w read, dw and db
            # written; ~16 flops an element
            nbytes = (4 if carry else 3) * M * E * es + 3 * E * 4
            bms, by = bound_ms(nbytes, 16 * M * E, dtype)
            lib = ("; the yardstick above is aten.native_layer_norm_backward with "
                   "saved mean and rstd (not the same function)" if lib_calls else
                   "; no one-call PyTorch equivalent (a carry term, no saved stats)")
            log(f"[kernels] add_norm_bwd {str(dtype)[6:]} ({M},{E}) {form} ({inst}): "
                f"dx max-abs {err:.3g} (bound {tol:.3g}), dw/db relative {p_err:.3g} "
                f"(bound 1e-4), two calls bit-equal; " + fmt_times(t, bms, by) + lib
                + "; launches (torch.profiler): "
                + ", ".join(f"{k} {v:.2f} us" for k, v in parts.items() if v))
            if dtype == torch.bfloat16:
                name = "add_norm_bwd" if carry else "add_norm_bwd_nocarry"
                entries[name] = dict(
                    name=name, route="cuda", source=SRC + "csrc/fused_norm_residual.cu",
                    replaces=TPU + "fused_norm_residual.py:153", max_abs_err=err,
                    ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=bms, bound_by=by,
                    library_ms=t["library_ms"])
            del dx, rdx, again
        del x, gn, gx

    # G: SwiGLU backward
    F = 4 * E
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.finfo(dtype).bits // 8
        x = torch.randn(M, E, generator=gen, device="cuda").to(dtype)
        ws = [(0.02 * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)
              for shape in ((E, F), (F,), (E, F), (F,))]
        gh = torch.randn(M, F, generator=gen, device="cuda").to(dtype)
        dgt, dw, db = ffn.swiglu_bwd(x, *ws, gh)
        rdgt, rdw, rdb = ffn.swiglu_bwd_reference(x, *ws, gh)
        err = max_err(dgt, rdgt)
        w_err = max(max_err(dw, rdw) / float(rdw.abs().max()),
                    max_err(db, rdb) / float(rdb.abs().max()))
        if dtype == torch.float32:
            tol, w_tol = 1e-5 * float(rdgt.abs().max()), 1e-4
        else:
            # dg/dt one bf16 step; a flipped dg/dt rounding moves a weight
            # grad by 2^-8 of one of its M terms
            tol, w_tol = bf16_ulp_bound(rdgt.float()), 2.0 ** -7
        expect(err <= tol and w_err <= w_tol,
               f"swiglu_bwd {dtype}: dg/dt max-abs {err:.3g} (bound {tol:.3g}), "
               f"dW/db relative {w_err:.3g} (bound {w_tol:.3g})")
        # no atomics: a second call gives the same results bit for bit
        again = ffn.swiglu_bwd(x, *ws, gh)
        expect(all(torch.equal(a, b) for a, b in zip((dgt, dw, db), again)),
               f"swiglu_bwd {dtype}: two calls differ")
        inst = ffn.swiglu_instance(dtype, M, E, F, backward=True)
        t = timings([lambda: ffn.swiglu_bwd(x, *ws, gh)],
                    [lambda: ffn.swiglu_bwd_reference(x, *ws, gh)], None,
                    **few(True))
        yard = ""
        if dtype == torch.bfloat16:
            wcat = torch.cat([ws[0], ws[2]], dim=1)
            cub = device_ms([lambda: (x @ wcat, x.t() @ dgt)], **few(True))
            parts = kernel_us([lambda: ffn.swiglu_bwd(x, *ws, gh)],
                              ("swiglu_act_wgmma", "swiglu_wgrad_wgmma", "finish"), n=6)
            yard = (f"; cuBLAS x @ [Wg | Wx] + x^T @ [dg | dt] alone {cub * 1e3:.2f} us "
                    f"(a yardstick, not the function); launches (torch.profiler): "
                    + ", ".join(f"{k} {v:.1f} us" for k, v in parts.items()))
        nbytes = (M * E + 2 * E * F + 2 * F + M * F + 2 * M * F) * es + 2 * E * F * 4 + 2 * F * 4
        bms, by = bound_ms(nbytes, 8 * M * E * F + 20 * M * F, dtype)
        log(f"[kernels] swiglu_bwd {str(dtype)[6:]} M={M} E={E} F={F} ({inst}): dg/dt "
            f"max-abs {err:.3g} (bound {tol:.3g}), dW/db relative {w_err:.3g} "
            f"(bound {w_tol:.3g}), two calls bit-equal; " + fmt_times(t, bms, by)
            + yard + "; no one-call PyTorch equivalent")
        if dtype == torch.bfloat16:
            entries["swiglu_bwd"] = dict(
                name="swiglu_bwd", route="cuda", source=SRC + "csrc/fused_swiglu.cu",
                replaces=TPU + "fused_ffn.py:169", max_abs_err=err, ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=bms, bound_by=by, library_ms=None)
        del x, ws, gh, dgt, rdgt, again
    torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# phase 2, continued: the head-major attention kernels K1-K4 against their
# plain versions, at the train-hm phase's shapes
# ---------------------------------------------------------------------------

HM_RATE = 0.1      # the attention dropout of the train-hm runs
HM_WORDS = (0x51F00D, 0x2A7E11)
# (label, S, B, T, H, d, dv, kernels, JSON entry names or None): diff at
# T = 2048 (routes resident + split), diff and control at T = 512 (fused),
# ndiff at T = 512 (split: S * T^2 past the fused budget), diff at T =
# 8192 (tiled)
HM_CONFIGS = (
    ("diff T=2048", 2, 8, 2048, 4, 96, 192, ("fwd", "dq", "dkv"),
     {"fwd": "flash_bh_fwd", "dq": "flash_bh_bwd_dq", "dkv": "flash_bh_bwd_dkv"}),
    ("diff T=512", 2, 32, 512, 4, 96, 192, ("fwd", "fused"),
     {"fused": "flash_bh_bwd_fused"}),
    ("control T=512", 1, 32, 512, 8, 96, 96, ("fwd", "fused"), {}),
    ("ndiff T=512", 4, 32, 512, 4, 96, 192, ("fwd", "dq", "dkv"), {}),
    ("diff T=8192", 2, 2, 8192, 4, 96, 192, ("fwd", "dq", "dkv"),
     {"fwd": "flash_bh_fwd_tiled", "dq": "flash_bh_bwd_dq_tiled",
      "dkv": "flash_bh_bwd_dkv_tiled"}),
)
HM_SOURCES = {"fwd": "csrc/flash_bh_fwd.cu", "dq": "csrc/flash_bh_bwd_dq.cu",
              "dkv": "csrc/flash_bh_bwd_dkv.cu", "fused": "csrc/flash_bh_bwd_fused.cu"}
# the SDPA yardsticks (control width, S 1, dropout 0): (T, B, backward
# kernels timed beside SDPA's backward)
YARD_SHAPES = ((512, 32, "fused"), (2048, 8, "split"), (8192, 2, "tiled"))
# the control-width entries, whose ms, plain_ms and library_ms (SDPA) are
# timed on the same operands: T -> {kernel: entry}. K1 computes SDPA's
# function there, and K4 the whole backward as SDPA's backward does; K2
# and K3 each compute half of it, so SDPA's backward stands beside their
# sum in the log only
HM_CONTROL = {512: {"fwd": "flash_bh_fwd_control", "fused": "flash_bh_bwd_fused_control"},
              8192: {"fwd": "flash_bh_fwd_tiled_control"}}
HM_REPLACES = {  # the TPU kernel bodies (ops/flash.py) each entry stands for
    "flash_bh_fwd": 339, "flash_bh_fwd_tiled": 572, "flash_bh_bwd_dq": 1011,
    "flash_bh_bwd_dkv": 1108, "flash_bh_bwd_dq_tiled": 721,
    "flash_bh_bwd_dkv_tiled": 795, "flash_bh_bwd_fused": 1238,
    "flash_bh_fwd_control": 339, "flash_bh_fwd_tiled_control": 572,
    "flash_bh_bwd_fused_control": 1238,
}
# the wrapper and route each entry's launches are counted under (a
# control-width entry: its kernel's, over every train-hm run)
HM_COUNTS = {
    "flash_bh_fwd": ("flash_bh_fwd", "resident"),
    "flash_bh_fwd_tiled": ("flash_bh_fwd", "tiled"),
    "flash_bh_bwd_dq": ("flash_bh_bwd_dq", "split"),
    "flash_bh_bwd_dkv": ("flash_bh_bwd_dkv", "split"),
    "flash_bh_bwd_dq_tiled": ("flash_bh_bwd_dq", "tiled"),
    "flash_bh_bwd_dkv_tiled": ("flash_bh_bwd_dkv", "tiled"),
    "flash_bh_bwd_fused": ("flash_bh_bwd_fused", "fused"),
    "flash_bh_fwd_control": ("flash_bh_fwd", "resident"),
    "flash_bh_fwd_tiled_control": ("flash_bh_fwd", "tiled"),
    "flash_bh_bwd_fused_control": ("flash_bh_bwd_fused", "fused"),
}


def hm_operands(torch, gen, dtype, S, B, T, H, d, dv):
    BH = B * H
    q, k = (torch.randn(BH, S, T, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    v, g = (torch.randn(BH, T, dv, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    c = 0.5 * torch.randn(S, H, generator=gen, device="cuda")
    c[0] = 1.0
    return q, k, v, g, c


def _zero_late(got, T):
    """(name, the kernel's result with its rows from T/2 on zeroed, the
    plain result) for K2's dq and K3's dk and dv in ``got`` (hm_check's
    {kernel: [(kernel's result, plain result)]})."""
    out = []
    for kern, names in (("dq", ("dq",)), ("dkv", ("dk", "dv"))):
        for name, (res, ref) in zip(names, got.get(kern, ())):
            z = res.clone()
            z[..., T // 2:, :] = 0
            out.append((name, z, ref))
    return out


def hm_check(torch, flash, dtype, S, T, q, k, v, g, c, H, rate, kernels,
             plant=False):
    """Each listed kernel against its plain version, row by row (each
    query row of out/o_all/dq, each key row of dk/dv against its own
    scale: ``testing.py``). Returns (max-abs error per kernel, worst
    row's share of its bound per kernel, (the plain lse, delta)). With
    ``plant``, faults planted in the results (dq and dk zero past T/2,
    in the plain results and in the kernels' own; dv zero past T/2 in
    K3's; the keep mask left out of the plain forward and backward) must
    fail the same bounds."""
    from differential_transformer_replication_tpu_torch import testing
    words = HM_WORDS if rate > 0 else (0, 0)
    out, o_all, lse = flash.flash_bh_fwd(q, k, v, c, H, rate, words, True)
    r_out, r_oall, r_lse = flash.bh_attention_fwd_reference(q, k, v, c, rate, words)
    c_bh = flash._coeffs_bh(c, q.shape[0])
    base = torch.einsum("btd,bstd->bst", g.float(), r_oall.float())
    delta = (base * c_bh[:, :, None]).contiguous()
    bwd = (q, k, v, g, r_lse, delta, c, H, rate, words)
    rq, rk, rv = flash.bh_attention_bwd_reference(q, k, v, g, r_lse, delta, c,
                                                  rate, words)
    got = {}
    if "dq" in kernels:
        got["dq"] = [(flash.flash_bh_bwd_dq(*bwd), rq)]
    if "dkv" in kernels:
        got["dkv"] = list(zip(flash.flash_bh_bwd_dkv(*bwd), (rk, rv)))
    if "fused" in kernels:
        got["fused"] = list(zip(flash.flash_bh_bwd_fused(*bwd), (rq, rk, rv)))
    torch.cuda.synchronize()
    errs = {"fwd": max(max_err(out, r_out), max_err(o_all, r_oall))}
    ratios = {"fwd": max(testing.attention_fwd_ratios(out, o_all, r_out, r_oall, c_bh))}
    l_err = max_err(lse, r_lse)
    expect(ratios["fwd"] <= 1.0 and l_err <= 1e-5 * float(r_lse.abs().max()),
           f"flash_bh_fwd {dtype} S={S} T={T}: worst row at {ratios['fwd']:.3g} of "
           f"its bound (max-abs {errs['fwd']:.3g}), lse {l_err:.3g}")
    for name, pairs in got.items():
        for a, b in pairs:
            r = testing.grad_ratio(a, b)
            expect(r <= 1.0, f"flash_bh {name} {dtype} S={S} T={T}: worst row at "
                   f"{r:.3g} of its bound (max-abs {max_err(a, b):.3g})")
            errs[name] = max(errs.get(name, 0.0), max_err(a, b))
            ratios[name] = max(ratios.get(name, 0.0), r)
    if plant:
        zq, zk = rq.clone(), rk.clone()
        zq[:, :, T // 2:] = 0
        zk[:, :, T // 2:] = 0
        nq, nk, nv = flash.bh_attention_bwd_reference(q, k, v, g, r_lse, delta, c,
                                                      0.0, words)
        n_out, n_oall, _ = flash.bh_attention_fwd_reference(q, k, v, c, 0.0, words)
        planted = {
            "dq zero past T/2": testing.grad_ratio(zq, rq),
            "dk zero past T/2": testing.grad_ratio(zk, rk),
            **{f"kernel {name} zero past T/2": testing.grad_ratio(z, ref)
               for name, z, ref in _zero_late(got, T)},
            "backward without the mask (dq)": testing.grad_ratio(nq, rq),
            "backward without the mask (dk)": testing.grad_ratio(nk, rk),
            "backward without the mask (dv)": testing.grad_ratio(nv, rv),
            "forward without the mask": min(testing.attention_fwd_ratios(
                n_out, n_oall, r_out, r_oall, c_bh)),
        }
        log(f"[kernels-hm] planted faults {dtype} S={S} T={T}, worst row's share of "
            "its bound (each must exceed 1): "
            + ", ".join(f"{n} {r:.3g}" for n, r in planted.items()))
        expect(min(planted.values()) > 1.0, "a planted fault passed the row bounds")
        del zq, zk, nq, nk, nv, n_out, n_oall
    return errs, ratios, (r_lse, delta)


def run_bh_kernels(torch, flash) -> dict:
    """Phase 2 for the head-major kernels K1-K4. Returns {name: json entry
    sans launches}."""
    from differential_transformer_replication_tpu_torch import testing
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    entries = {}
    # fp32 (SIMT path): every kernel at one shape per route, small batch;
    # and S = 5 (two passes over the streams: 4 + 1) in both dtypes
    for dtype, S, T, H, dv in ((torch.float32, 2, 2048, 2, 192),
                               (torch.float32, 1, 512, 2, 96),
                               (torch.float32, 2, 8192, 1, 192),
                               (torch.float32, 5, 520, 2, 192),
                               (torch.bfloat16, 5, 520, 2, 192)):
        q, k, v, g, c = hm_operands(torch, gen, dtype, S, 1, T, H, 96, dv)
        errs, ratios, _ = hm_check(torch, flash, dtype, S, T, q, k, v, g, c,
                                   H, HM_RATE, ("dq", "dkv") if T > 2048
                                   else ("dq", "dkv", "fused"))
        log(f"[kernels-hm] flash_bh {dtype} S={S} B=1 T={T} H={H} d=96 dv={dv} "
            f"rate {HM_RATE} (K4 instance {flash.fused_bwd_instance(S, 96, dv, dtype)}): "
            + ", ".join(
                f"{n} max-abs {e:.3g} (worst row at {ratios[n]:.3g} of its bound)"
                for n, e in errs.items()))
        del q, k, v, g, c
    for label, S, B, T, H, d, dv, kernels, names in HM_CONFIGS:
        dtype = torch.bfloat16
        es = 2
        q, k, v, g, c = hm_operands(torch, gen, dtype, S, B, T, H, d, dv)
        errs, ratios, (lse, delta) = hm_check(torch, flash, dtype, S, T, q, k, v,
                                              g, c, H, HM_RATE, kernels,
                                              plant=T == 2048)
        log(f"[kernels-hm] flash_bh bf16 {label} S={S} B={B} H={H} d={d} dv={dv} "
            f"rate {HM_RATE} (routes {flash.fwd_route(T)}, {flash.bwd_route(S, T)}; K4 "
            f"instance {flash.fused_bwd_instance(S, d, dv, dtype)}): "
            + ", ".join(f"{n} max-abs {e:.3g} (worst row at {ratios[n]:.3g} of its "
                        "bound)" for n, e in errs.items()))
        long = T >= 2048
        kw = dict(iters=2, reps=3) if T > 4096 else few(long)
        words = HM_WORDS
        work = {
            "fwd": (lambda: flash.flash_bh_fwd(q, k, v, c, H, HM_RATE, words, True),
                    lambda: flash.bh_attention_fwd_reference(q, k, v, c, HM_RATE, words)),
            "dq": (lambda: flash.flash_bh_bwd_dq(q, k, v, g, lse, delta, c, H,
                                                 HM_RATE, words), None),
            "dkv": (lambda: flash.flash_bh_bwd_dkv(q, k, v, g, lse, delta, c, H,
                                                   HM_RATE, words), None),
            "fused": (lambda: flash.flash_bh_bwd_fused(q, k, v, g, lse, delta, c, H,
                                                       HM_RATE, words),
                      lambda: flash.bh_attention_bwd_reference(
                          q, k, v, g, lse, delta, c, HM_RATE, words)),
        }
        plain_bwd = lambda: flash.bh_attention_bwd_reference(  # noqa: E731
            q, k, v, g, lse, delta, c, HM_RATE, words)
        for kern in kernels:
            k_call, p_call = work[kern]
            _, nbytes, flops = testing.attention_work(
                B, H, S, T, d, dv, 0, "bwd" if kern == "fused" else kern, es)
            t = timings([k_call], [p_call or plain_bwd], None, **kw)
            bms, by = bound_ms(nbytes, flops, dtype)
            note = ("" if p_call else "; plain is the whole plain backward")
            log(f"[kernels-hm] flash_bh {kern} bf16 {label}: " + fmt_times(t, bms, by)
                + note + "; one-call PyTorch: none at this shape (dropout, "
                "multi-stream); SDPA at S 1, dropout 0 below")
            name = names.get(kern)
            if name:
                entries[name] = dict(
                    name=name, route="cuda", source=SRC + HM_SOURCES[kern],
                    replaces=TPU + f"flash.py:{HM_REPLACES[name]}",
                    max_abs_err=errs[kern], ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=bms, bound_by=by, library_ms=None)
        del q, k, v, g, c, lse, delta, work
        torch.cuda.empty_cache()

    # the one-call yardsticks: SDPA (causal) at dropout 0 and S 1, the
    # control width, on the same (B, H, T, d) operands as the kernels timed
    # beside it (device time, CUDA-graph replay; SDPA's backward is the
    # graph of forward + backward less the forward): K1 (rows 9, 10), K4
    # (row 12), K2 + K3 (split, row 13; tiled, row 11). The diff entries
    # above keep library_ms None: no one call computes S streams with
    # dropout. The HM_CONTROL entries are held against their plain
    # versions and timed beside SDPA on these operands.
    S, H, d, dv = 1, 8, 96, 96
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for T, B, bwd_kernels in YARD_SHAPES:
        q, k, v, g, c = hm_operands(torch, gen, dtype, S, B, T, H, d, dv)
        _, o_all, lse = flash.flash_bh_fwd(q, k, v, c, H, 0.0, (0, 0), True)
        delta = torch.einsum("btd,bstd->bst", g.float(), o_all.float()).contiguous()
        kw = dict(iters=2, reps=3) if T > 4096 else few(True)
        qt, kt, vt, gt = (x.reshape(B, H, T, -1) for x in (q, k, v, g))
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        bwd = (q, k, v, g, lse, delta, c, H, 0.0, (0, 0))
        if bwd_kernels == "fused":
            k_bwd = [lambda: flash.flash_bh_bwd_fused(*bwd)]
        else:
            k_bwd = [lambda: (flash.flash_bh_bwd_dq(*bwd), flash.flash_bh_bwd_dkv(*bwd))]
        named = HM_CONTROL.get(T, {})
        errs = {}
        if named:
            errs, ratios, _ = hm_check(torch, flash, dtype, S, T, q, k, v, g, c, H, 0.0,
                                       tuple(kern for kern in named if kern != "fwd"))
            log(f"[kernels-hm] flash_bh bf16 control T={T} B={B} H={H} d={d} dv={dv} "
                "dropout 0: " + ", ".join(
                    f"{n} max-abs {e:.3g} (worst row at {ratios[n]:.3g} of its bound)"
                    for n, e in errs.items()))
        t_f = timings([lambda: flash.flash_bh_fwd(q, k, v, c, H, 0.0, (0, 0), True)],
                      [lambda: flash.bh_attention_fwd_reference(q, k, v, c, 0.0, (0, 0))],
                      [lambda: sdpa(qt, kt, vt, is_causal=True)], **kw)
        k_f, lib_f = t_f["ms"], t_f["library_ms"]
        k_b = device_ms(k_bwd, **kw)
        lib_b = device_ms([lambda: torch.autograd.grad(
            sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg), gt)], **kw) - lib_f
        log(f"[kernels-hm] control T={T} B={B} H={H} at dropout 0 (routes "
            f"{flash.fwd_route(T)}, {flash.bwd_route(S, T)}): SDPA forward "
            f"{lib_f * 1e3:.2f} us (K1 {k_f * 1e3:.2f} us); SDPA backward "
            f"{lib_b * 1e3:.2f} us ({'K4' if bwd_kernels == 'fused' else 'K2 + K3'} "
            f"{k_b * 1e3:.2f} us); device")
        for kern, name in named.items():
            if kern == "fwd":
                t = t_f
            else:  # K4: the whole backward, as SDPA's
                t = {"ms": k_b, "library_ms": lib_b, "plain_ms": device_ms(
                    [lambda: flash.bh_attention_bwd_reference(*bwd[:7], 0.0, (0, 0))],
                    **kw)}
            _, nbytes, flops = testing.attention_work(
                B, H, S, T, d, dv, 0, "bwd" if kern == "fused" else kern, 2)
            bms, by = bound_ms(nbytes, flops, dtype)
            entries[name] = dict(
                name=name, route="cuda", source=SRC + HM_SOURCES[kern],
                replaces=TPU + f"flash.py:{HM_REPLACES[name]}", max_abs_err=errs[kern],
                ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=bms, bound_by=by,
                library_ms=t["library_ms"])
            log(f"[kernels-hm] {name} (T={T} B={B}): device {t['ms'] * 1e3:.2f} us, "
                f"plain {t['plain_ms'] * 1e3:.2f} us, SDPA {t['library_ms'] * 1e3:.2f} us, "
                f"bound {bms * 1e3:.3f} us ({by})")
        del q, k, v, g, c, o_all, lse, delta, qt, kt, vt, gt, qg, kg, vg, bwd, k_bwd
        torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# phase 5: train the diff and control recipes through the trainer
# ---------------------------------------------------------------------------

# the best checkpoint of the train, train-hm and train-ring runs (each
# writes its best at its eval, over the one before; removed at the end).
# The train-ring launches at each P run side by side, so each P writes
# its own: two writers of one path race on its files' ".tmp" names
SMOKE_BEST = Path(__file__).resolve().parent / "build" / "chip_smoke" / "best.ckpt"


def ring_best(P: int) -> Path:
    return SMOKE_BEST.with_name(f"best-ring-P{P}.ckpt")
TRAIN_STEPS = 6     # trainer steps per recipe
REPEAT_STEPS = 4    # steps on one repeated batch, whose loss must fall
PIPE_M = 4          # the pipeline recipe's microbatches (grad-acc) a step
TRAIN_COUNTERS = ("fused_norm", "fused_add_norm", "fused_swiglu",
                  "flash_tm_fwd", "flash_tm_bwd", "add_norm_bwd", "swiglu_bwd")


def _train_counters():
    from differential_transformer_replication_tpu_torch.ops import (
        flash,
        fused_ffn as ffn,
        fused_norm_residual as fnr,
    )

    return {"fused_norm": fnr.fused_norm, "fused_add_norm": fnr.fused_add_norm,
            "fused_swiglu": ffn.fused_swiglu, "flash_tm_fwd": flash.flash_tm_fwd,
            "flash_tm_bwd": flash.flash_tm_bwd, "add_norm_bwd": fnr.add_norm_bwd,
            "swiglu_bwd": ffn.swiglu_bwd}


def expect_norm_bwd_instances(torch, label: str, launches: int, instances: dict) -> None:
    """Every add+norm backward call of a run at recipe width in bf16 ran
    the bf16 warp instance (``launches`` and ``instances``: the wrapper's
    counts over the run)."""
    from differential_transformer_replication_tpu_torch.ops import (
        fused_norm_residual as fnr,
    )

    inst = fnr.add_norm_bwd_instance(torch.bfloat16, RECIPE["n_embd"])
    expect(launches > 0 and instances == {inst: launches},
           f"{label}: add_norm_bwd instances {instances}, expected {launches} {inst}")


def synthetic_tokens(path, n: int, vocab: int, seed: int) -> None:
    """A seeded Zipf-distributed token stream (skewed like text, so a few
    steps visibly lower the loss), saved as the trainer's tokens.npy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tokens = (rng.zipf(1.3, n) - 1) % vocab
    np.save(path, tokens.astype(np.int32))


def run_train(torch, card: str) -> dict:
    """Phase 5. Returns the launch count of each training kernel wrapper
    over the diff recipe's trainer run."""
    from pathlib import Path

    from differential_transformer_replication_tpu_torch.config import (
        ModelConfig,
        TrainConfig,
    )
    from differential_transformer_replication_tpu_torch.train.trainer import train
    from differential_transformer_replication_tpu_torch.train.step import (
        make_eval_step,
        make_train_step,
    )

    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    tokens = out_dir / "tokens.npy"
    synthetic_tokens(tokens, 2_000_000, RECIPE["vocab_size"], seed=0)
    counters = _train_counters()
    diff_counts = None
    for model, n_layer in (("diff", 8), ("control", 8)):
        cfg = TrainConfig(
            model=ModelConfig(**dict(RECIPE, model=model, n_layer=n_layer),
                              compute_dtype="bfloat16", param_dtype="float32"),
            vocab_size=RECIPE["vocab_size"], micro_batch_size=TRAIN_B,
            max_iters=TRAIN_STEPS, eval_interval=TRAIN_STEPS, eval_iters=2,
            log_interval=1, learning_rate=1e-3, warmup_iters=2,
            sampler="replacement", seed=0,
            metrics_path=str(out_dir / f"metrics_{model}.jsonl"),
            checkpoint_path=str(SMOKE_BEST), last_checkpoint_path=None)
        mcfg = cfg.resolved_model()
        for fn in counters.values():
            fn.launches = 0
        swiglu = (counters["fused_swiglu"], counters["swiglu_bwd"])
        for fn in swiglu:
            fn.instances.clear()
        norm_bwd = counters["add_norm_bwd"]
        norm_bwd.carry_launches = 0
        norm_bwd.instances.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, history = train(cfg, str(tokens), device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in counters.items()}
        counts["add_norm_bwd_carry"] = norm_bwd.carry_launches
        # every SwiGLU call of the run (M = 16384 rows, bf16) on the mma
        # instance, forward and backward; every add+norm backward on the
        # bf16 warp instance
        for fn in swiglu:
            expect(dict(fn.instances) == {"mma": fn.launches},
                   f"{model}: SwiGLU instances {dict(fn.instances)}, expected "
                   f"{fn.launches} mma")
        expect_norm_bwd_instances(torch, model, norm_bwd.launches, dict(norm_bwd.instances))
        losses = [m["loss"] for m in history]
        expect(len(history) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
               f"{model}: non-finite or missing losses {losses}")
        expect(all(m["bad"] == 0 for m in history), f"{model}: a step was skipped")
        L = mcfg.n_layer
        # backward kernels run once per layer (norm: ln1, GroupLN for
        # diff, ln2 carry, ln_f) per train step and never in eval
        per_step_bwd = {"flash_tm_bwd": L, "swiglu_bwd": L,
                        "add_norm_bwd": L * (3 if model == "diff" else 2) + 1,
                        "add_norm_bwd_carry": L}
        for name, per in per_step_bwd.items():
            expect(counts[name] == per * TRAIN_STEPS,
                   f"{model}: {name} launched {counts[name]} times, expected "
                   f"{per * TRAIN_STEPS}")
        for name in TRAIN_COUNTERS:
            expect(counts[name] > 0, f"{model}: {name} never launched")
        step_ms = statistics.median(m["step_time_ms"] for m in history[1:])
        toks = TRAIN_B * mcfg.block_size
        log(f"[train] {model} recipe: {L} layers, width {mcfg.n_embd}, "
            f"{mcfg.n_head} heads (d {mcfg.head_size}, dv {mcfg.value_size}), "
            f"T {mcfg.block_size}, micro-batch {TRAIN_B}, vocab "
            f"{mcfg.vocab_size}, bf16 compute, fp32 params, AdamW; "
            f"{TRAIN_STEPS} trainer steps in {wall:.1f} s (eval included)")
        log(f"[train] {model}: losses {[round(x, 4) for x in losses]}; median "
            f"step {step_ms:.1f} ms = {toks / step_ms * 1e3:.0f} tok/s (steps 2..); "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB; launches {counts}; {card}")
        # a few more steps on ONE repeated batch: its loss must fall (a
        # schedule whose cosine has not decayed yet: lr stays ~1e-3)
        step = make_train_step(cfg.replace(max_iters=1000))
        eval_step = make_eval_step(cfg)
        g = torch.Generator(device="cuda")
        g.manual_seed(1)
        idx = torch.randint(0, mcfg.vocab_size, (1, TRAIN_B, mcfg.block_size + 1),
                            generator=g, device="cuda")
        batch = {"x": idx[..., :-1], "y": idx[..., 1:]}
        before = float(eval_step(state["params"], batch["x"][0], batch["y"][0]))
        rep = []
        for _ in range(REPEAT_STEPS):
            state, m = step(state, batch)
            rep.append(m["loss"])
        after = float(eval_step(state["params"], batch["x"][0], batch["y"][0]))
        log(f"[train] {model}: one repeated batch, loss {before:.4f} -> "
            f"{[round(x, 4) for x in rep]} -> {after:.4f}")
        expect(math.isfinite(after) and after < before and rep[-1] < rep[0],
               f"{model}: the loss on a repeated batch did not fall "
               f"({before} -> {rep} -> {after})")
        if model == "diff":
            diff_counts = counts
        del state, history, step
        torch.cuda.empty_cache()
    return diff_counts


# ---------------------------------------------------------------------------
# phase 5b (train-hm): training through the head-major kernels: attention
# dropout and long context
# ---------------------------------------------------------------------------

# (label, model, T, micro-batch, steps, n_layer): diff at T = 2048 (routes
# resident + split), diff and control at T = 512 (resident + fused), diff at
# T = 8192 (tiled). Every run has 16,384 tokens per step, as the recipe.
HM_RUNS = (("diff T=2048", "diff", 2048, 8, 6, 8),
           ("diff T=512", "diff", 512, 32, 6, 8),
           ("control T=512", "control", 512, 32, 6, 8),
           ("diff T=8192", "diff", 8192, 2, 3, 8))
HM_EVAL_ITERS = 2


def run_train_hm(torch, card: str, tokens) -> dict:
    """Phase train-hm. Returns the launch count of each head-major JSON
    entry (wrapper and route) over the four runs."""
    from differential_transformer_replication_tpu_torch.config import (
        ModelConfig,
        TrainConfig,
    )
    from differential_transformer_replication_tpu_torch.ops import flash
    from differential_transformer_replication_tpu_torch.ops import (
        fused_norm_residual as fnr,
    )
    from differential_transformer_replication_tpu_torch.ops.dropout import fold_seed
    from differential_transformer_replication_tpu_torch.train import step_profile
    from differential_transformer_replication_tpu_torch.train.step import (
        make_eval_step,
        make_train_step,
    )
    from differential_transformer_replication_tpu_torch.train.trainer import train

    totals = {name: 0 for name in HM_COUNTS}
    for label, model, T, B, steps, n_layer in HM_RUNS:
        cfg = TrainConfig(
            model=ModelConfig(**dict(RECIPE, model=model, n_layer=n_layer,
                                     block_size=T, dropout=HM_RATE),
                              compute_dtype="bfloat16", param_dtype="float32"),
            vocab_size=RECIPE["vocab_size"], micro_batch_size=B, max_iters=steps,
            eval_interval=steps, eval_iters=HM_EVAL_ITERS, log_interval=1,
            learning_rate=1e-3, warmup_iters=2, sampler="replacement", seed=0,
            checkpoint_path=str(SMOKE_BEST), last_checkpoint_path=None)
        mcfg = cfg.resolved_model()
        L, S = mcfg.n_layer, {"control": 1, "diff": 2}[model]
        flash.reset_bh_counters()
        flash.flash_tm_fwd.launches = flash.flash_tm_bwd.launches = 0
        fnr.add_norm_bwd.launches = 0
        fnr.add_norm_bwd.instances.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, history = train(cfg, str(tokens), device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [m["loss"] for m in history]
        expect(len(history) == steps and all(math.isfinite(x) for x in losses),
               f"{label}: non-finite or missing losses {losses}")
        expect(all(m["bad"] == 0 for m in history), f"{label}: a step was skipped")
        # per train step: one forward (with dropout: head-major) and one
        # backward per layer; eval runs 2 * eval_iters forwards without
        # dropout, head-major past T = 512 and token-major at T = 512
        fr, br = flash.fwd_route(T), flash.bwd_route(S, T)
        n_eval = 2 * HM_EVAL_ITERS
        want = {("flash_bh_fwd", fr): L * (steps + (n_eval if T > 512 else 0))}
        if br == "fused":
            want[("flash_bh_bwd_fused", "fused")] = L * steps
        else:
            want[("flash_bh_bwd_dq", br)] = L * steps
            want[("flash_bh_bwd_dkv", br)] = L * steps
        got = {(fn.__name__, r): n for fn in flash.BH_WRAPPERS
               for r, n in fn.routes.items()}
        expect(got == want, f"{label}: head-major launches by route {got}, "
               f"expected {want}")
        expect_norm_bwd_instances(torch, label, fnr.add_norm_bwd.launches,
                                  dict(fnr.add_norm_bwd.instances))
        tm_want = (L * n_eval if T <= 512 else 0, 0)
        tm_got = (flash.flash_tm_fwd.launches, flash.flash_tm_bwd.launches)
        expect(tm_got == tm_want, f"{label}: token-major launches {tm_got}, "
               f"expected {tm_want} (eval only)")
        for name, (fn, route) in HM_COUNTS.items():
            totals[name] += got.get((fn, route), 0)
        step_ms = statistics.median(m["step_time_ms"] for m in history[1:])
        log(f"[train-hm] {label}: {model}, {L} layers, width {mcfg.n_embd}, "
            f"{mcfg.n_head} heads, T {T}, micro-batch {B}, attention/residual/FFN "
            f"dropout {HM_RATE}, bf16; {steps} trainer steps in {wall:.1f} s (eval "
            f"included); losses {[round(x, 4) for x in losses]}; median step "
            f"{step_ms:.1f} ms = {B * T / step_ms * 1e3:.0f} tok/s (steps 2..); peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"launches by route {got} (per step: fwd {fr}, bwd {br}); {card}")
        # a few steps on ONE repeated batch, each with its own dropout seed:
        # the dropout-free eval loss on it must fall
        step = make_train_step(cfg.replace(max_iters=1000))
        eval_step = make_eval_step(cfg)
        g = torch.Generator(device="cuda")
        g.manual_seed(1)
        idx = torch.randint(0, mcfg.vocab_size, (1, B, T + 1), generator=g,
                            device="cuda")
        batch = {"x": idx[..., :-1], "y": idx[..., 1:]}
        before = float(eval_step(state["params"], batch["x"][0], batch["y"][0]))
        rep = []
        for i in range(REPEAT_STEPS):
            state, m = step(state, batch, fold_seed(99, i))
            rep.append(m["loss"])
        after = float(eval_step(state["params"], batch["x"][0], batch["y"][0]))
        log(f"[train-hm] {label}: one repeated batch, loss {before:.4f} -> "
            f"{[round(x, 4) for x in rep]} -> {after:.4f}")
        expect(math.isfinite(after) and after < before,
               f"{label}: the loss on a repeated batch did not fall "
               f"({before} -> {rep} -> {after})")
        del state, history, step
        torch.cuda.empty_cache()
    run_hm_memory(torch, card)
    # where a dropout step's time goes (train/step_profile.py): the fused
    # route at T 512, the split and tiled routes at long context
    for T, B in ((512, 32), (2048, 8), (8192, 2)):
        prof = step_profile.profile("diff", T, B, HM_RATE)
        top = ", ".join(f"{k['name'][:48]} {k['ms_per_step']:.2f}"
                        for k in prof["top_kernels"][:8])
        log(f"[train-hm] step_profile diff T={T} B={B} dropout {HM_RATE}: wall "
            f"{prof['wall_ms_per_step']:.1f} ms ({prof['tokens_per_s']:.0f} tok/s), "
            f"busy {prof['device_busy_ms_per_step']:.1f} ms, idle "
            f"{100 * prof['device_idle_share']:.1f}%, peak "
            f"{prof['peak_device_memory_gib']:.2f} GiB, "
            f"{prof['device_kernels_per_step']:.0f} kernels/step, routes "
            f"{prof['head_major_routes_per_step']}; top device ms/step: {top}")
        torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# train-hm, continued: memory for compute. Remat (models/common.py:
# remat_block) under each policy against the unremat step, bit for bit,
# and the chunked loss (ops/losses.py:fused_linear_cross_entropy) against
# the dense loss within its bounds, each beside the other's peak memory
# and time. Its launches are counted and held here, apart from the
# train-hm runs' counts above.
# ---------------------------------------------------------------------------

# (label, T, micro-batch): the tiled and the split route, both dropout 0.1
REMAT_SHAPES = (("diff T=8192", 8192, 2), ("diff T=2048", 2048, 8))
LOSS_CHUNK = 2048
MEM_TIMED = 3          # timed forward+backward calls per variant
# the chunked loss against the dense one: the same bf16 logits, fp32 sums
# in another order (the loss); each chunk's dW rounded to bf16 before its
# fp32 sum and d from softmax in place of exp(x - lse), carried through
# the model's bf16 backward (every gradient, as test_torch_gpu.py holds
# the fused and split backwards to each other)
CHUNK_LOSS_REL, CHUNK_GRAD_REL = 1e-5, 2.0 ** -5
MEM_COUNTERS = ("fused_norm", "fused_add_norm", "fused_swiglu", "flash_bh_fwd",
                "flash_bh_bwd_dq", "flash_bh_bwd_dkv", "flash_bh_bwd_fused",
                "flash_tm_fwd", "flash_tm_bwd", "add_norm_bwd", "swiglu_bwd")


def mem_launches_want(L: int, fwd: str, bwd: tuple, recompute: bool) -> dict:
    """The exact launches of one forward+backward of the diff model: its
    forward kernels once more per block under remat (every policy but
    ``everything``: the kernels are opaque to a policy), the backward
    kernels once; ``fwd`` the attention forward's wrapper, ``bwd`` the
    backward's."""
    r = 2 if recompute else 1
    want = dict.fromkeys(MEM_COUNTERS, 0)
    want.update(fused_norm=2 * L * r + 1, fused_add_norm=L * r, fused_swiglu=L * r,
                add_norm_bwd=3 * L + 1, swiglu_bwd=L)
    want[fwd] = L * r
    for name in bwd:
        want[name] = L
    return want


def run_hm_memory(torch, card: str) -> None:
    from differential_transformer_replication_tpu_torch.config import (
        REMAT_POLICIES,
        ModelConfig,
        TrainConfig,
    )
    from differential_transformer_replication_tpu_torch.models import init_model
    from differential_transformer_replication_tpu_torch.ops import flash
    from differential_transformer_replication_tpu_torch.ops.dropout import fold_seed
    from differential_transformer_replication_tpu_torch.train.optim import leaves
    from differential_transformer_replication_tpu_torch.train.step import make_grad_fn

    counters = {**_train_counters(), **{fn.__name__: fn for fn in flash.BH_WRAPPERS}}
    t_all = time.perf_counter()

    def measure(tcfg, params, batch, seed):
        """One forward+backward (loss, grads on the host, peak GiB,
        launches), then MEM_TIMED more timed by the host clock."""
        grads_fn = make_grad_fn(tcfg)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = grads_fn(params, batch, seed)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = {k: counters[k].launches for k in MEM_COUNTERS}
        out = (loss.cpu(), [g.cpu() for g in grads])
        del loss, grads
        wall = []
        for _ in range(MEM_TIMED):
            t0 = time.perf_counter()
            grads_fn(params, batch, seed)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        return out, peak, statistics.median(wall), counts

    def setup(T, B, rate):
        mcfg = ModelConfig(**dict(RECIPE, block_size=T, dropout=rate),
                           compute_dtype="bfloat16", param_dtype="float32")
        tcfg = TrainConfig(model=mcfg, vocab_size=RECIPE["vocab_size"],
                           micro_batch_size=B, sampler="replacement")
        g = torch.Generator(device="cuda")
        g.manual_seed(T)
        params = init_model(g, mcfg)  # fp32 on the card; no optimizer state
        for t in leaves(params):
            t.requires_grad_(True)
        idx = torch.randint(0, RECIPE["vocab_size"], (1, B, T + 1), generator=g,
                            device="cuda")
        return tcfg, params, {"x": idx[..., :-1], "y": idx[..., 1:]}

    def with_model(tcfg, **kw):
        return tcfg.replace(model=tcfg.model.replace(**kw))

    def chunk_vs_dense(label, params, ref, got):
        (l0, g0), (l1, g1) = ref, got
        head = [i for i, t in enumerate(leaves(params)) if t is params["lm_head"]["w"]]
        dl = abs(float(l1) - float(l0))
        rel = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(g1, g0)]
        expect(dl <= CHUNK_LOSS_REL * abs(float(l0)),
               f"{label}: chunked loss {float(l1)} vs dense {float(l0)}")
        expect(max(rel) <= CHUNK_GRAD_REL, f"{label}: a gradient differs by "
               f"{max(rel):.3g} of its max (bound {CHUNK_GRAD_REL:.3g})")
        return (f"loss {float(l1):.6f} vs {float(l0):.6f} (|diff| {dl:.3g}, bound "
                f"{CHUNK_LOSS_REL:g} of the loss), worst gradient {max(rel):.3g} of its "
                f"max (lm_head.w {rel[head[0]]:.3g}; bound {CHUNK_GRAD_REL:.3g})")

    L = RECIPE["n_layer"]
    dense_8192 = None
    for label, T, B in REMAT_SHAPES:
        tcfg, params, batch = setup(T, B, HM_RATE)
        fwd = ("flash_bh_fwd", flash.fwd_route(T))
        br = flash.bwd_route(2, T)
        bwd = ("flash_bh_bwd_fused",) if br == "fused" else ("flash_bh_bwd_dq",
                                                             "flash_bh_bwd_dkv")
        seed = fold_seed(7, T)
        flash.reset_bh_counters()
        ref, peak0, ms0, counts = measure(tcfg, params, batch, seed)
        want = mem_launches_want(L, "flash_bh_fwd", bwd, False)
        expect(counts == want, f"{label} unremat: launches {counts}, expected {want}")
        counts = {k: n for k, n in counts.items() if n}
        log(f"[train-hm] remat {label} B={B} dropout {HM_RATE} (fwd {fwd[1]}, bwd "
            f"{br}), one forward+backward, no update: unremat peak {peak0:.2f} GiB, "
            f"{ms0:.1f} ms; launches {counts}; {card}")
        for policy in REMAT_POLICIES:
            flash.reset_bh_counters()
            got, peak, ms, counts = measure(with_model(tcfg, remat=True,
                                                       remat_policy=policy),
                                            params, batch, seed)
            want = mem_launches_want(L, "flash_bh_fwd", bwd, policy != "everything")
            expect(counts == want, f"{label} remat {policy}: launches {counts}, "
                   f"expected {want}")
            counts = {k: n for k, n in counts.items() if n}
            routes = {(fn.__name__, r) for fn in flash.BH_WRAPPERS for r in fn.routes}
            expect(routes == {fwd} | {(n, br) for n in bwd},
                   f"{label} remat {policy}: routes {routes}")
            equal = (torch.equal(got[0], ref[0])
                     and all(torch.equal(a, b) for a, b in zip(got[1], ref[1])))
            expect(equal, f"{label} remat {policy}: loss or a gradient differs from "
                   "the unremat step's")
            log(f"[train-hm] remat {label} policy {policy}: loss and every gradient "
                f"bit-equal to unremat; peak {peak:.2f} GiB vs {peak0:.2f} "
                f"({peak - peak0:+.2f}), {ms:.1f} ms vs {ms0:.1f} "
                f"({100 * (ms / ms0 - 1):+.1f}%); launches {counts}; {card}")
        if T == 8192:
            flash.reset_bh_counters()
            got, peak, ms, counts = measure(
                with_model(tcfg, remat=True, remat_policy="nothing",
                           loss_chunk=LOSS_CHUNK), params, batch, seed)
            want = mem_launches_want(L, "flash_bh_fwd", bwd, True)
            expect(counts == want, f"{label} remat+chunk: launches {counts}, "
                   f"expected {want}")
            log(f"[train-hm] remat nothing + loss_chunk {LOSS_CHUNK} {label} vs "
                f"unremat dense: {chunk_vs_dense(label, params, ref, got)}; peak {peak:.2f} "
                f"GiB vs {peak0:.2f} ({peak - peak0:+.2f}), {ms:.1f} ms vs {ms0:.1f} "
                f"({100 * (ms / ms0 - 1):+.1f}%); {card}")
            dense_8192 = (peak0, ms0)
        del params, batch, ref
        torch.cuda.empty_cache()
    expect(dense_8192 is not None, "no T 8192 run")
    # the chunked loss alone at the recipe's T 512, dropout 0 (kernels D/E)
    tcfg, params, batch = setup(512, 32, 0.0)
    ref, peak0, ms0, c0 = measure(tcfg, params, batch, None)
    got, peak, ms, c1 = measure(with_model(tcfg, loss_chunk=LOSS_CHUNK), params,
                                batch, None)
    expect(c0 == c1 and c0["flash_tm_fwd"] == L and c0["flash_tm_bwd"] == L,
           f"diff T=512 loss_chunk: launches {c1} vs dense {c0}")
    log(f"[train-hm] loss_chunk {LOSS_CHUNK} diff T=512 B=32 dropout 0 (D/E) vs "
        f"dense: {chunk_vs_dense('diff T=512 loss_chunk', params, ref, got)}; peak "
        f"{peak:.2f} GiB vs {peak0:.2f} ({peak - peak0:+.2f}), {ms:.1f} ms vs "
        f"{ms0:.1f} ({100 * (ms / ms0 - 1):+.1f}%), one forward+backward, no "
        f"update; launches {c1}; {card}")
    del params, batch, ref
    torch.cuda.empty_cache()
    log(f"[train-hm] remat and the chunked loss took {time.perf_counter() - t_all:.1f} s")


# ---------------------------------------------------------------------------
# phase 2, continued (kernels-ring): the ring chunk's kernel modes, K1
# without the combine and K2/K3 with per-stream cotangents, under causal
# offsets, against their plain versions
# ---------------------------------------------------------------------------

RING_RATE = 0.1
# (family, S, H, d, dv) at recipe width
RING_FAMILIES = (("diff", 2, 4, 96, 192), ("control", 1, 8, 96, 96),
                 ("ndiff", 4, 4, 96, 192))
RING_TLS = (2048, 4096, 8192)         # chunk lengths: both sides of 4096
RING_OFFS = (0, 1, 3, -1)             # offsets in chunk lengths
RING_DTYPE_RATES = (("bfloat16", RING_RATE), ("float32", 0.0),
                    ("bfloat16", 0.0), ("float32", RING_RATE))
# JSON entries of the ring path: (name, Tl, kernel, TPU function line)
RING_ENTRIES = (
    ("flash_chunk_fwd", 4096, "fwd", 1579), ("flash_chunk_fwd_tiled", 8192, "fwd", 572),
    ("flash_chunk_bwd_dq", 4096, "dq", 1011), ("flash_chunk_bwd_dkv", 4096, "dkv", 1108),
    ("flash_chunk_bwd_dq_tiled", 8192, "dq", 721),
    ("flash_chunk_bwd_dkv_tiled", 8192, "dkv", 795),
)
# the wrapper and route each entry's launches are counted under
RING_COUNTS = {
    "flash_chunk_fwd": ("flash_chunk_fwd", "chunk-resident"),
    "flash_chunk_fwd_tiled": ("flash_chunk_fwd", "chunk-tiled"),
    "flash_chunk_bwd_dq": ("flash_chunk_bwd_dq", "chunk-split"),
    "flash_chunk_bwd_dkv": ("flash_chunk_bwd_dkv", "chunk-split"),
    "flash_chunk_bwd_dq_tiled": ("flash_chunk_bwd_dq", "chunk-tiled"),
    "flash_chunk_bwd_dkv_tiled": ("flash_chunk_bwd_dkv", "chunk-tiled"),
    "flash_chunk_fwd_control": ("flash_chunk_fwd", "chunk-resident"),
    "flash_chunk_fwd_tiled_control": ("flash_chunk_fwd", "chunk-tiled"),
}


def chunk_operands(torch, gen, dtype, S, BH, T, d, dv):
    q, k = (torch.randn(BH, S, T, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    v = torch.randn(BH, T, dv, generator=gen, device="cuda").to(dtype)
    do = torch.randn(BH, S, T, dv, generator=gen, device="cuda").to(dtype)
    return q, k, v, do


def chunk_check(torch, flash, dtype, q, k, v, do, off, rate):
    """K1 (no combine), K2 and K3 (per-stream cotangents) at offset
    ``off`` against their plain versions, row by row (``testing.py``).
    Returns ({kernel: max-abs error}, {kernel: worst row's share of its
    bound}, (the plain lse, delta))."""
    from differential_transformer_replication_tpu_torch import testing

    words = HM_WORDS if rate > 0 else (0, 0)
    o_all, lse = flash.flash_chunk_fwd(q, k, v, off, rate, words)
    _, r_o, r_lse = flash.bh_attention_fwd_reference(q, k, v, None, rate, words, off)
    # delta as the chunk backward forms it (rowsum(do . o)), lse cotangent 0
    delta = torch.einsum("bstd,bstd->bst", do.float(), r_o.float()).contiguous()
    bwd = (q, k, v, do, r_lse, delta, off, rate, words)
    dq = flash.flash_chunk_bwd_dq(*bwd)
    dk, dv = flash.flash_chunk_bwd_dkv(*bwd)
    rq, rk, rv = flash.bh_attention_bwd_reference(q, k, v, do, r_lse, delta, None,
                                                  rate, words, off)
    torch.cuda.synchronize()
    fwd_bounds = ((testing.FP32_FWD_ROW, testing.FP32_FWD_FLOOR)
                  if dtype == torch.float32 else (testing.BF16_ROW, testing.BF16_FLOOR))
    ratios = {"fwd": testing.row_ratio(o_all, r_o, *fwd_bounds),
              "dq": testing.grad_ratio(dq, rq),
              "dkv": max(testing.grad_ratio(dk, rk), testing.grad_ratio(dv, rv))}
    errs = {"fwd": max_err(o_all, r_o), "dq": max_err(dq, rq),
            "dkv": max(max_err(dk, rk), max_err(dv, rv))}
    masked = r_lse < -1e29  # rows with no visible key: lse = -1e30 exactly
    live = ~masked
    l_err = max_err(lse[live], r_lse[live]) if bool(live.any()) else 0.0
    expect(bool(torch.isfinite(lse).all()) and torch.equal(lse[masked], r_lse[masked])
           and l_err <= 1e-5 * max(float(r_lse[live].abs().max()) if bool(live.any())
                                   else 1.0, 1.0),
           f"flash_chunk_fwd {dtype} off={off}: lse {l_err:.3g} from the plain lse, "
           "or a masked row's lse is not -1e30")
    for name, r in ratios.items():
        expect(r <= 1.0, f"flash_chunk {name} {dtype} off={off}: worst row at {r:.3g} "
               f"of its bound (max-abs {errs[name]:.3g})")
    return errs, ratios, (r_lse, delta)


def run_ring_kernels(torch, flash) -> dict:
    """Phase kernels-ring. Returns {name: json entry sans launches}."""
    from differential_transformer_replication_tpu_torch import testing
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    # correctness: each chunk length, offset, dtype and rate, the family
    # cycling, at 2 heads (B*H = 2); past 4096 fp32 (the exact SIMT loop)
    # takes one rate per offset, both rates over the offsets
    worst = {}
    n = 0
    for Tl in RING_TLS:
        for oi, om in enumerate(RING_OFFS):
            for di, (dname, rate) in enumerate(RING_DTYPE_RATES):
                if Tl > 4096 and dname == "float32" and (rate > 0) != (oi % 2 == 1):
                    continue
                fam, S, _, d, dv = RING_FAMILIES[(oi + di) % len(RING_FAMILIES)]
                dtype = getattr(torch, dname)
                q, k, v, do = chunk_operands(torch, gen, dtype, S, 2, Tl, d, dv)
                errs, ratios, _ = chunk_check(torch, flash, dtype, q, k, v, do,
                                              om * Tl, rate)
                for kern, r in ratios.items():
                    key = (kern, dname)
                    worst[key] = max(worst.get(key, 0.0), r)
                n += 1
                del q, k, v, do
        log(f"[kernels-ring] Tl={Tl} (routes {flash.chunk_fwd_route(Tl)}, "
            f"{flash.chunk_bwd_route(Tl)}): offsets {[o * Tl for o in RING_OFFS]}, "
            "bf16 and fp32 at dropout 0 and 0.1, diff/control/ndiff widths: held")
        torch.cuda.empty_cache()
    log(f"[kernels-ring] {n} checks; worst row's share of its bound per kernel and "
        "dtype: " + ", ".join(f"{k} {d} {r:.3g}" for (k, d), r in sorted(worst.items())))

    # each train-ring run's own chunk shapes (its B*H, S, Tl, d, dv; bf16,
    # dropout 0.1) at every offset its ranks meet: k*Tl, |k| < P
    fams = {f[0]: f for f in RING_FAMILIES}
    for label, model, P, T, B, _ in RING_RUNS:
        _, S, H, d, dv = fams[model]
        Tl = T // P
        q, k, v, do = chunk_operands(torch, gen, torch.bfloat16, S, B * H, Tl, d, dv)
        run_worst = {}
        for m in range(1 - P, P):
            _, ratios, _ = chunk_check(torch, flash, torch.bfloat16, q, k, v, do,
                                       m * Tl, RING_RATE)
            for kern, r in ratios.items():
                run_worst[kern] = max(run_worst.get(kern, 0.0), r)
        log(f"[kernels-ring] {label} shapes (B*H {B * H}, S {S}, Tl {Tl}, d {d}, dv {dv}"
            f", bf16, dropout {RING_RATE}) at offsets {[m * Tl for m in range(1 - P, P)]}:"
            " held; worst row's share of its bound "
            + ", ".join(f"{kern} {r:.3g}" for kern, r in run_worst.items()))
        del q, k, v, do
        torch.cuda.empty_cache()

    # times at the ring's shapes: diff, B 2, H 4, bf16, dropout 0.1
    entries = {}
    fam, S, H, d, dv = RING_FAMILIES[0]
    B, es, dtype = 2, 2, torch.bfloat16
    BH = B * H
    for Tl in (4096, 8192):
        q, k, v, do = chunk_operands(torch, gen, dtype, S, BH, Tl, d, dv)
        kw = dict(iters=2, reps=3) if Tl > 4096 else few(True)
        times = {}
        for om in (1, 0, -1):
            off = om * Tl
            errs, ratios, (lse, delta) = chunk_check(torch, flash, dtype, q, k, v, do,
                                                     off, RING_RATE)
            words = HM_WORDS
            work = {
                "fwd": (lambda: flash.flash_chunk_fwd(q, k, v, off, RING_RATE, words),
                        lambda: flash.bh_attention_fwd_reference(
                            q, k, v, None, RING_RATE, words, off)),
                "dq": (lambda: flash.flash_chunk_bwd_dq(q, k, v, do, lse, delta, off,
                                                        RING_RATE, words), None),
                "dkv": (lambda: flash.flash_chunk_bwd_dkv(q, k, v, do, lse, delta, off,
                                                          RING_RATE, words), None),
            }
            plain_bwd = lambda: flash.bh_attention_bwd_reference(  # noqa: E731
                q, k, v, do, lse, delta, None, RING_RATE, words, off)
            for kern, (k_call, p_call) in work.items():
                # the bound of the visible pairs and the operands they read
                _, nbytes, flops = testing.attention_work(B, H, S, Tl, d, dv, off,
                                                          "chunk_" + kern, es)
                t = timings([k_call], [p_call or plain_bwd], None, **kw)
                bms, by = bound_ms(nbytes, flops, dtype)
                times[(kern, om)] = (t, bms, by, errs[kern])
                log(f"[kernels-ring] flash_chunk {kern} bf16 diff Tl={Tl} B={B} off="
                    f"{off} ({flash.chunk_fwd_route(Tl) if kern == 'fwd' else flash.chunk_bwd_route(Tl)}"
                    f", dropout {RING_RATE}): " + fmt_times(t, bms, by)
                    + ("" if p_call else "; plain is the whole plain backward")
                    + "; worst row at " + f"{ratios[kern]:.3g} of its bound")
            del lse, delta, work
        for name, eTl, kern, line in RING_ENTRIES:
            if eTl != Tl:
                continue
            t, bms, by, err = times[(kern, 1)]  # the full chunk (off = +Tl)
            entries[name] = dict(
                name=name, route="cuda", source=SRC + HM_SOURCES[kern],
                replaces=TPU + f"flash.py:{line}", max_abs_err=err, ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=bms, bound_by=by, library_ms=None)
        del q, k, v, do
        torch.cuda.empty_cache()

    # the one-call yardstick, S = 1 at dropout 0 (control width, Tl 4096
    # and 8192): SDPA causal against off 0, non-causal against off +Tl.
    # The diff entries above keep library_ms None (S streams with
    # dropout); the full chunk at the control width is an entry of its
    # own, held against its plain version and timed beside SDPA on the
    # same operands
    fam, S, H, d, dv = RING_FAMILIES[1]
    for Tl, name in ((4096, "flash_chunk_fwd_control"),
                     (8192, "flash_chunk_fwd_tiled_control")):
        q, k, v, do = chunk_operands(torch, gen, dtype, S, B * H, Tl, d, dv)
        qt, kt, vt = (x.reshape(B, H, Tl, -1) for x in (q, k, v))
        kw = dict(iters=2, reps=3) if Tl > 4096 else few(True)
        for om, causal in ((0, True), (1, False)):
            off = om * Tl
            sdpa = [lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal)]
            kern = [lambda: flash.flash_chunk_fwd(q, k, v, off, 0.0, (0, 0))]
            if causal:
                t = {"ms": device_ms(kern, **kw), "library_ms": device_ms(sdpa, **kw)}
            else:
                errs, ratios, _ = chunk_check(torch, flash, dtype, q, k, v, do, off, 0.0)
                t = timings(kern, [lambda: flash.bh_attention_fwd_reference(
                    q, k, v, None, 0.0, (0, 0), off)], sdpa, **kw)
                _, nbytes, flops = testing.attention_work(B, H, S, Tl, d, dv, off,
                                                          "chunk_fwd", 2)
                bms, by = bound_ms(nbytes, flops, dtype)
                entries[name] = dict(
                    name=name, route="cuda", source=SRC + HM_SOURCES["fwd"],
                    replaces=TPU + f"flash.py:{1579 if Tl == 4096 else 572}",
                    max_abs_err=errs["fwd"], ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=bms, bound_by=by, library_ms=t["library_ms"])
            log(f"[kernels-ring] control Tl={Tl} B={B} H={H} off={off} at dropout 0: "
                f"chunk K1 {t['ms'] * 1e3:.2f} us, SDPA "
                f"({'causal' if causal else 'non-causal'}) {t['library_ms'] * 1e3:.2f} us "
                "(device)" + ("" if causal else
                              f"; plain {t['plain_ms'] * 1e3:.2f} us, bound "
                              f"{bms * 1e3:.3f} us ({by}), worst row at "
                              f"{ratios['fwd']:.3g} of its bound"))
        del q, k, v, do, qt, kt, vt
        torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# phase 5c (train-ring): sequence-parallel training through the ring, P
# ranks sharing this card over gloo (the ranks are processes started with
# torch.distributed.run, each running this script as a worker)
# ---------------------------------------------------------------------------

# (label, model, P, T, micro-batch, steps): 16,384 tokens per step
RING_RUNS = (("diff P=2 T=8192", "diff", 2, 8192, 2, 3),
             ("diff P=4 T=8192", "diff", 4, 8192, 2, 3),
             ("diff P=2 T=16384", "diff", 2, 16384, 1, 3),
             ("control P=2 T=8192", "control", 2, 8192, 2, 3))
RING_EVAL_ITERS = 1
RING_LAYERS = 2     # the train-ring runs' depth: the recipe's width, a quarter
                    # of its depth (the smoke's time limit)
RING_TIMEOUT_S = 900  # a launch: all the runs at one P (the P = 2 launch
                      # waits for train-ckpt and train-full beside it)


def _port_counters():
    from differential_transformer_replication_tpu_torch.ops import flash

    counters = _train_counters()
    for fn in flash.BH_WRAPPERS + flash.CHUNK_WRAPPERS:
        counters[fn.__name__] = fn
    return counters


def launch_ranks(P: int, backend: str, tasks: list, timeout: float = RING_TIMEOUT_S,
                 procs: list = None) -> list:
    """Run ``tasks`` in turn on P rank processes of this script
    (``--ring-worker``) under one torch.distributed.run launch, so the
    ranks start and join the group once for all of them; every rank must
    exit 0 in time (else the launch is stopped). The launch's process
    goes into ``procs``, for a caller that must stop it. Returns, per
    task, each rank's JSON record."""
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke" / "ring"
    out_dir.mkdir(parents=True, exist_ok=True)
    tasks = [dict(t, out=str(out_dir / t["label"].replace(" ", "_").replace("=", "")))
             for t in tasks]
    for t in tasks:
        for r in range(P):
            Path(f"{t['out']}.rank{r}.json").unlink(missing_ok=True)
    spec = {"backend": backend, "tasks": tasks}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={P}", str(Path(__file__).resolve()),
           "--ring-worker", json.dumps(spec)]
    label = f"P={P} {backend} launch ({', '.join(t['label'] for t in tasks)})"
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    if procs is not None:
        procs.append(proc)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        stop_process(proc)
        raise Failure(f"{label}: no end within {timeout} s")
    expect(proc.returncode == 0, f"{label}: a rank failed (exit "
           f"{proc.returncode}):\n{out[-4000:]}\n{err[-6000:]}")
    return [[json.loads(Path(f"{t['out']}.rank{r}.json").read_text())
             for r in range(P)] for t in tasks]


def stop_process(proc: subprocess.Popen) -> None:
    """SIGTERM (torch.distributed.run stops its workers on it), then
    SIGKILL if it has not ended within 30 s."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()


def ring_worker(spec: dict) -> int:
    """One rank of a train-ring launch (see launch_ranks): joins the ring
    once, then runs each task of ``spec["tasks"]`` in turn, a trainer run
    (``train``, or ``mesh`` on a mesh of the same ranks) or the fp32 step
    against one card (``e2e``, ``mesh_e2e``), and writes each task's
    record."""
    import torch
    import torch.distributed as dist

    from differential_transformer_replication_tpu_torch.parallel import init_sequence_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the ring's group, joined here so that it outlives the trainer's runs
    # (the trainer joins it rather than making its own)
    sg = init_sequence_group(spec["backend"], "cuda")
    for task in spec["tasks"]:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        rec = {"train": ring_train_task, "e2e": ring_e2e_task,
               "profile": ring_profile_task, "mesh": mesh_train_task,
               "mesh_e2e": mesh_e2e_task}[task["task"]](torch, sg, task)
        torch.cuda.synchronize()
        dist.barrier()
        rec.update(rank=sg.rank, device=str(sg.device),
                   task_s=time.perf_counter() - t0)
        Path(f"{task['out']}.rank{sg.rank}.json").write_text(json.dumps(rec))
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return 0


def ring_train_task(torch, sg, spec: dict) -> dict:
    """A trainer run on this rank (the CLI's ``run``), its launches by
    route and losses, then steps on one repeated batch."""
    import hashlib

    from differential_transformer_replication_tpu_torch.ops import flash
    from differential_transformer_replication_tpu_torch.ops import (
        fused_norm_residual as fnr,
    )
    from differential_transformer_replication_tpu_torch.ops.dropout import fold_seed
    from differential_transformer_replication_tpu_torch.train import __main__ as cli
    from differential_transformer_replication_tpu_torch.train.optim import leaves
    from differential_transformer_replication_tpu_torch.train.step import (
        make_eval_step,
        make_train_step,
    )

    def checksum(params):
        flat = torch.cat([t.detach().reshape(-1) for t in leaves(params)])
        return hashlib.sha1(flat.cpu().numpy().tobytes()).hexdigest()

    rec = {}
    counters = _port_counters()
    for fn in counters.values():
        fn.launches = 0
    flash.reset_bh_counters()
    fnr.add_norm_bwd.instances.clear()
    state, history = cli.run(spec["argv"])
    torch.cuda.synchronize()
    rec["launches"] = {k: fn.launches for k, fn in counters.items()}
    rec["norm_bwd_instances"] = dict(fnr.add_norm_bwd.instances)
    rec["routes"] = {f"{fn.__name__}/{r}": n
                     for fn in flash.BH_WRAPPERS + flash.CHUNK_WRAPPERS
                     for r, n in fn.routes.items()}
    rec["losses"] = [m["loss"] for m in history]
    rec["bad"] = [m["bad"] for m in history]
    rec["step_ms"] = [m["step_time_ms"] for m in history]
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    rec["checksum"] = checksum(state["params"])
    # a few steps on ONE repeated batch, each with its own dropout seed:
    # the dropout-free eval loss on it must fall
    args = cli.build_parser().parse_args(spec["argv"])
    cfg = cli.config_from_args(args)
    step = make_train_step(cfg.replace(max_iters=1000), sg)
    eval_step = make_eval_step(cfg, sg)
    g = torch.Generator(device=sg.device)
    g.manual_seed(1)
    T = cfg.model.block_size
    idx = torch.randint(0, cfg.vocab_size, (1, args.micro_batch_size, T + 1),
                        generator=g, device=sg.device)
    batch = {"x": idx[..., :-1], "y": idx[..., 1:]}
    rec["before"] = float(eval_step(state["params"], batch["x"][0], batch["y"][0]))
    rec["repeat"] = []
    for i in range(REPEAT_STEPS):
        state, m = step(state, batch, fold_seed(99, i))
        rec["repeat"].append(m["loss"])
    rec["after"] = float(eval_step(state["params"], batch["x"][0], batch["y"][0]))
    rec["checksum_after"] = checksum(state["params"])
    return rec


def ring_profile_task(torch, sg, spec: dict) -> dict:
    """Where the ring step's time goes: train/step_profile.py on these
    ranks (rank 0 profiled; it joins this group) at the trainer run's
    model, T and micro-batch, once the file ``spec["after"]`` exists (the
    other launch has ended: the card is this launch's alone)."""
    from differential_transformer_replication_tpu_torch.train import __main__ as cli
    from differential_transformer_replication_tpu_torch.train import step_profile

    t0 = time.perf_counter()
    while not Path(spec["after"]).exists():
        expect(time.perf_counter() - t0 < RING_TIMEOUT_S,
               f"{spec['label']}: {spec['after']} never appeared")
        time.sleep(0.2)
    args = cli.build_parser().parse_args(spec["argv"])
    return {"profile": step_profile.profile(
        args.model, args.block_size, args.micro_batch_size, HM_RATE, sg.size,
        sg.backend, n_layer=RING_LAYERS)}


def ring_e2e_task(torch, sg, spec: dict) -> dict:
    """One fp32 step from a seeded init over the ring: its loss, grad
    norm and params (rank 0 saves grads and params for the comparison)."""
    from differential_transformer_replication_tpu_torch.config import (
        MeshConfig,
        ModelConfig,
        TrainConfig,
    )
    from differential_transformer_replication_tpu_torch.train.optim import leaves
    from differential_transformer_replication_tpu_torch.train.step import (
        make_grad_fn,
        make_train_step,
        train_state,
    )
    import hashlib

    rec = {}
    for kind, extra in E2E_KINDS.items():
        mcfg = ModelConfig(**dict(RECIPE, n_layer=2, block_size=1024, **extra),
                           compute_dtype="float32")
        tcfg = TrainConfig(model=mcfg, mesh=MeshConfig(sequence=sg.size),
                           vocab_size=RECIPE["vocab_size"], micro_batch_size=1,
                           warmup_iters=0, learning_rate=1e-3, sampler="replacement")
        params, batch = e2e_inputs(torch, tcfg)
        state = train_state(params, tcfg, sg.device)
        batch = {k: t.to(sg.device) for k, t in batch.items()}
        loss, grads = make_grad_fn(tcfg, sg)(state["params"], batch)
        state, m = make_train_step(tcfg, sg)(state, batch)
        flat = torch.cat([t.detach().reshape(-1) for t in leaves(state["params"])])
        rec[kind] = {"loss": m["loss"], "grad_norm": m["grad_norm"],
                     "checksum": hashlib.sha1(flat.cpu().numpy().tobytes()).hexdigest()}
        if sg.rank == 0:
            torch.save({"grads": [t.cpu() for t in grads],
                        "params": [t.detach().cpu() for t in leaves(state["params"])]},
                       f"{spec['out']}.{kind}.pt")
    return rec


def ring_argv(model: str, P: int, T: int, B: int, steps: int, tokens, backend: str,
              metrics: str, layers: int = RING_LAYERS, rate: float = HM_RATE,
              mesh: tuple = None) -> list:
    """The trainer's command line for one train-ring run (what a user runs
    under torchrun); ``mesh``: the mesh flags in place of
    ``--sequence-parallel P``."""
    return ["--model", model, "--tokens", str(tokens), "--sampler", "replacement",
            "--device", "cuda", "--n-embd", str(RECIPE["n_embd"]),
            "--n-head", str(RECIPE["n_head"]), "--n-layer", str(layers),
            "--block-size", str(T), "--vocab-size", str(RECIPE["vocab_size"]),
            "--micro-batch-size", str(B), "--max-iters", str(steps),
            "--eval-interval", str(steps), "--eval-iters", str(RING_EVAL_ITERS),
            "--warmup-iters", "2", "--learning-rate", "1e-3", "--dropout", str(rate),
            "--compute-dtype", "bfloat16", "--log-interval", "1", "--seed", "0",
            "--metrics-path", metrics, *(mesh or ("--sequence-parallel", str(P))),
            "--dist-backend", backend, "--checkpoint-path", str(ring_best(P)),
            "--last-checkpoint-path", ""]


def check_ring_run(torch, card: str, label: str, model: str, P: int, T: int, B: int,
                   steps: int, backend: str, recs: list, totals: dict) -> None:
    """The checks of one train-ring trainer run, on its ranks' records."""
    from differential_transformer_replication_tpu_torch.ops import flash

    Tl, L = T // P, RING_LAYERS
    r0 = recs[0]
    losses = r0["losses"]
    expect(len(losses) == steps and all(math.isfinite(x) for x in losses),
           f"{label}: non-finite or missing losses {losses}")
    expect(all(b == 0 for b in r0["bad"]), f"{label}: a step was skipped")
    expect(all(r["losses"] == losses for r in recs),
           f"{label}: the ranks report different losses")
    expect(len({r["checksum"] for r in recs}) == 1
           and len({r["checksum_after"] for r in recs}) == 1,
           f"{label}: the params differ between ranks")
    # per rank and layer: P chunk forwards per forward (train steps and
    # 2 * eval_iters eval batches), P chunk backwards (dq, dk/dv) per
    # train step; the last rotation is skipped (P - 1 per layer and
    # direction) but no chunk is: masked chunks launch and write zeros
    fr, br = flash.chunk_fwd_route(Tl), flash.chunk_bwd_route(Tl)
    n_fwd = steps + 2 * RING_EVAL_ITERS
    want = {f"flash_chunk_fwd/{fr}": L * P * n_fwd,
            f"flash_chunk_bwd_dq/{br}": L * P * steps,
            f"flash_chunk_bwd_dkv/{br}": L * P * steps}
    for r in recs:
        expect(r["routes"] == want, f"{label} rank {r['rank']}: launches by route "
               f"{r['routes']}, expected {want}")
        for name in ("fused_norm", "fused_add_norm", "fused_swiglu", "add_norm_bwd",
                     "swiglu_bwd"):
            expect(r["launches"][name] > 0, f"{label}: {name} never launched")
        expect_norm_bwd_instances(torch, f"{label} rank {r['rank']}",
                                  r["launches"]["add_norm_bwd"], r["norm_bwd_instances"])
    if backend == "gloo":
        for name, (fn, route) in RING_COUNTS.items():
            totals[name] += sum(r["routes"].get(f"{fn}/{route}", 0) for r in recs)
    log(f"[train-ring] {label}: {model}, {L} layers, width {RECIPE['n_embd']}, "
        f"T {T} over {P} ranks (Tl {Tl}), micro-batch {B}, attention/residual/FFN "
        f"dropout {HM_RATE}, bf16, {backend}; {steps} trainer steps, the task "
        f"{r0['task_s']:.1f} s in its launch (eval and the repeated batch included); "
        f"losses {[round(x, 4) for x in losses]}; "
        f"rank 0 step ms {[round(x, 1) for x in r0['step_ms']]}; peak device memory "
        f"per rank {[round(r['peak_gib'], 2) for r in recs]} GiB; launches per rank "
        f"by route {want} (fwd {fr}, bwd {br}); params equal on all ranks "
        f"({r0['checksum'][:12]}); {card}; ranks share one card: not a multi-card "
        "ring")
    log(f"[train-ring] {label}: one repeated batch, loss {r0['before']:.4f} -> "
        f"{[round(x, 4) for x in r0['repeat']]} -> {r0['after']:.4f}")
    expect(math.isfinite(r0["after"]) and r0["after"] < r0["before"],
           f"{label}: the loss on a repeated batch did not fall "
           f"({r0['before']} -> {r0['repeat']} -> {r0['after']})")


# the train-ring-e2e steps: each family, and the diff step under remat
# (its recompute runs the ring's exchanges again inside the backward),
# each over the ring against the same step on one card
E2E_KINDS = {"diff": {"model": "diff"}, "control": {"model": "control"},
             "diff_remat": {"model": "diff", "remat": True, "remat_policy": "nothing"}}


def e2e_inputs(torch, tcfg):
    """The seeded params and batch of the train-ring-e2e step (the same in
    every process that asks)."""
    from differential_transformer_replication_tpu_torch.models import init_model

    mcfg = tcfg.resolved_model()
    gen = torch.Generator()
    gen.manual_seed(21)
    params = init_model(gen, mcfg)
    idx = torch.randint(0, mcfg.vocab_size, (tcfg.grad_acc_steps, tcfg.micro_batch_size,
                                             mcfg.block_size + 1), generator=gen)
    return params, {"x": idx[..., :-1], "y": idx[..., 1:]}


def ring_e2e_reference(torch) -> dict:
    """The single-card head-major fp32 step of a 2-layer diff and control
    at recipe width, T 1024, and of the diff under remat, from
    e2e_inputs: the ring's reference."""
    from differential_transformer_replication_tpu_torch.config import (
        ModelConfig,
        TrainConfig,
    )
    from differential_transformer_replication_tpu_torch.train.optim import leaves
    from differential_transformer_replication_tpu_torch.train.step import (
        make_grad_fn,
        make_train_step,
        train_state,
    )

    ref = {}
    for kind, extra in E2E_KINDS.items():
        mcfg = ModelConfig(**dict(RECIPE, n_layer=2, block_size=1024, **extra),
                           compute_dtype="float32")
        tcfg = TrainConfig(model=mcfg, vocab_size=RECIPE["vocab_size"],
                           micro_batch_size=1, warmup_iters=0, learning_rate=1e-3,
                           sampler="replacement")
        params, batch = e2e_inputs(torch, tcfg)
        state = train_state(params, tcfg, "cuda")
        batch = {k: t.cuda() for k, t in batch.items()}
        _, grads = make_grad_fn(tcfg)(state["params"], batch)
        state, m = make_train_step(tcfg)(state, batch)
        ref[kind] = (m, [g.cpu() for g in grads],
                     [t.detach().cpu() for t in leaves(state["params"])])
    return ref


def check_ring_e2e(torch, P: int, ref: dict, recs: list, out: str) -> None:
    """train-ring-e2e: one fp32 step over P gloo ranks against one card."""
    lr = 1e-3
    for kind, (m, grads, params) in ref.items():
        got = torch.load(f"{out}.{kind}.pt")
        r0 = recs[0][kind]
        rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(got["grads"], grads))
        p_max = max(float((a - b).abs().max()) for a, b in zip(got["params"], params))
        p_mean = max(float((a - b).abs().mean()) for a, b in zip(got["params"], params))
        log(f"[train-ring-e2e] {kind} recipe width, 2 layers, fp32, T 1024 over P={P} "
            f"gloo ranks vs one card (head-major): loss {r0['loss']:.6f} vs "
            f"{m['loss']:.6f} (bound 1e-5), grad norm {r0['grad_norm']:.6f} vs "
            f"{m['grad_norm']:.6f} (1e-4 relative), worst gradient {rel:.3g} of its "
            f"leaf's max (1e-3), params after the step max {p_max:.3g} (2 lr = "
            f"{2 * lr}), mean {p_mean:.3g} (1e-6); params equal on all ranks; the "
            f"task {recs[0]['task_s']:.1f} s in its launch")
        expect(abs(r0["loss"] - m["loss"]) <= 1e-5, f"e2e P={P} {kind}: loss")
        expect(abs(r0["grad_norm"] - m["grad_norm"]) <= 1e-4 * m["grad_norm"],
               f"e2e P={P} {kind}: grad norm")
        expect(rel <= 1e-3, f"e2e P={P} {kind}: gradients differ: {rel:.3g}")
        expect(p_max <= 2 * lr and p_mean <= 1e-6, f"e2e P={P} {kind}: params")
        expect(len({r[kind]["checksum"] for r in recs}) == 1,
               f"e2e P={P} {kind}: the params differ between ranks")


# ---------------------------------------------------------------------------
# train-mesh: data parallelism, FSDP and Ulysses on the train-ring
# launches' ranks (parallel/dp_step.py, parallel/ulysses.py)
# ---------------------------------------------------------------------------

# (label, mesh flags, T, global micro-batch, steps, layers, dropout, alone,
# model): the runs of each launch, by its P; "alone" runs after the P = 4
# launch ended, the card theirs alone (their times are the ones to read)
MESH_RUNS = {
    2: (("ulysses P=2 T=8192", ("--sequence-parallel", "2", "--sequence-impl", "ulysses"),
         8192, 2, 3, RING_LAYERS, HM_RATE, False, "diff"),
        ("tensor=2 control dropout", ("--tensor-parallel", "2"), 512, TRAIN_B, 3,
         RING_LAYERS, HM_RATE, False, "control"),
        ("data=2 recipe", ("--data-parallel", "2"), 512, TRAIN_B, 3, 8, 0.0, True, "diff"),
        ("data=2 no-overlap recipe", ("--data-parallel", "2", "--no-dp-overlap"), 512,
         TRAIN_B, 3, 8, 0.0, True, "diff"),
        ("fsdp=2 recipe", ("--fsdp", "2"), 512, TRAIN_B, 3, 8, 0.0, True, "diff"),
        ("tensor=2 recipe", ("--tensor-parallel", "2"), 512, TRAIN_B, 3, 8, 0.0, True,
         "diff"),
        # the recipe's 16,384 tokens a step as 4 microbatches of 8, 4 of its
        # 8 layers a stage
        ("pipeline=2 recipe", ("--pipeline-parallel", "2", "--grad-acc-steps",
                               str(PIPE_M)), 512, TRAIN_B // PIPE_M, 3, 8, 0.0, True,
         "diff")),
    # the P = 4 runs at 1 of the 8 layers (pipeline=4 at all 8, 2 a
    # stage; the pipelines x data and x tensor at 2): they hold up the
    # P = 2 launch's runs alone on the card (the smoke's time limit)
    4: (("data=2 sequence=2 T=8192", ("--data-parallel", "2", "--sequence-parallel", "2"),
         8192, 2, 3, 1, HM_RATE, False, "diff"),
        ("tensor=2 sequence=2 T=8192", ("--tensor-parallel", "2", "--sequence-parallel",
                                         "2"), 8192, 2, 3, 1, HM_RATE, False, "diff"),
        ("data=2 fsdp=2 recipe", ("--data-parallel", "2", "--fsdp", "2"), 512, TRAIN_B,
         3, 1, 0.0, False, "diff"),
        ("data=2 tensor=2 recipe", ("--data-parallel", "2", "--tensor-parallel", "2"), 512,
         TRAIN_B, 3, 1, 0.0, False, "diff"),
        ("pipeline=4 recipe", ("--pipeline-parallel", "4", "--grad-acc-steps",
                               str(PIPE_M)), 512, TRAIN_B // PIPE_M, 3, 8, 0.0, False,
         "diff"),
        ("pipeline=2 data=2", ("--pipeline-parallel", "2", "--data-parallel", "2",
                               "--grad-acc-steps", str(PIPE_M)), 512, TRAIN_B // PIPE_M,
         3, 2, 0.0, False, "diff"),
        ("pipeline=2 tensor=2", ("--pipeline-parallel", "2", "--tensor-parallel", "2",
                                 "--grad-acc-steps", str(PIPE_M)), 512, TRAIN_B // PIPE_M,
         3, 2, 0.0, False, "diff")),
}
# the train-mesh-e2e steps: (label, mesh, micro-batch, sequence_impl,
# grad-acc microbatches, layers) per P; the pipelines at 4 layers, against
# the single-card step with grad-acc M
MESH_E2E = {2: (("data=2", {"data": 2}, 2, "ring", 1, 2),
                ("fsdp=2", {"fsdp": 2}, 2, "ring", 1, 2),
                ("ulysses sequence=2", {"sequence": 2}, 1, "ulysses", 1, 2),
                ("tensor=2", {"tensor": 2}, 2, "ring", 1, 2),
                ("pipeline=2", {"pipeline": 2}, 1, "ring", 2, 4)),
            4: (("data=2 sequence=2", {"data": 2, "sequence": 2}, 2, "ring", 1, 2),
                ("ulysses sequence=4", {"sequence": 4}, 1, "ulysses", 1, 2),
                ("data=2 tensor=2", {"data": 2, "tensor": 2}, 2, "ring", 1, 2),
                ("fsdp=2 tensor=2", {"fsdp": 2, "tensor": 2}, 2, "ring", 1, 2),
                ("tensor=2 sequence=2", {"tensor": 2, "sequence": 2}, 1, "ring", 1, 2),
                ("ulysses tensor=2 sequence=2", {"tensor": 2, "sequence": 2}, 1,
                 "ulysses", 1, 2),
                ("pipeline=4", {"pipeline": 4}, 1, "ring", 4, 4),
                ("pipeline=2 data=2", {"pipeline": 2, "data": 2}, 2, "ring", 2, 4),
                ("pipeline=2 tensor=2", {"pipeline": 2, "tensor": 2}, 1, "ring", 2, 4),
                ("pipeline=2 sequence=2", {"pipeline": 2, "sequence": 2}, 1, "ring", 2, 4))}


def _mesh_of(torch, cfg, backend: str):
    """This rank's mesh for ``cfg`` over the launch's world, and the FSDP
    layout of ``cfg``'s params (None without fsdp; under tensor, of the
    rank's tensor shard)."""
    from differential_transformer_replication_tpu_torch.models import init_model
    from differential_transformer_replication_tpu_torch.parallel import create_mesh
    from differential_transformer_replication_tpu_torch.parallel.dp_step import fsdp_layout
    from differential_transformer_replication_tpu_torch.parallel.sharding import (
        tensor_layout,
    )

    mesh = create_mesh(cfg.mesh, backend, "cuda")
    layout = None
    if cfg.mesh.fsdp > 1:  # the layout reads only the tree's shapes
        params = init_model(torch.Generator(), cfg.resolved_model())
        tl = tensor_layout(mesh)
        layout = fsdp_layout(cfg, mesh, params if tl is None else tl.shard_tree(params))
    return mesh, layout


def _params_checksum(torch, params) -> str:
    import hashlib

    from differential_transformer_replication_tpu_torch.train.optim import leaves

    flat = torch.cat([t.detach().reshape(-1) for t in leaves(params)])
    return hashlib.sha1(flat.cpu().numpy().tobytes()).hexdigest()


def mesh_train_task(torch, sg, spec: dict) -> dict:
    """A trainer run on this rank of a mesh (the CLI's ``run``): launches
    by kernel and route, losses, peak and state at rest, the params'
    checksum (gathered under tensor and fsdp: a tensor line's replicated
    leaves are each rank's own copies; under pipeline ``train`` returns
    the gathered state, which is then cut to the rank's stage again);
    then steps on one repeated batch (``grad_acc_steps`` microbatches of
    it), each timed with its collectives' and its sends' host time; with
    ``spec["after"]``, once that file exists (the card this launch's
    alone)."""
    from differential_transformer_replication_tpu_torch.ops import flash
    from differential_transformer_replication_tpu_torch.ops import (
        fused_norm_residual as fnr,
    )
    from differential_transformer_replication_tpu_torch.ops.dropout import fold_seed
    from differential_transformer_replication_tpu_torch.parallel import (
        destroy_mesh,
        make_sharded_train_step,
        mesh as pmesh,
        pipeline,
        ring,
        ulysses,
    )
    from differential_transformer_replication_tpu_torch.parallel.dp_step import (
        full_params,
        model_params,
        shard_train_state,
    )
    from differential_transformer_replication_tpu_torch.train import __main__ as cli
    from differential_transformer_replication_tpu_torch.train.optim import leaves
    from differential_transformer_replication_tpu_torch.train.step import make_eval_step

    if spec.get("after"):
        t0 = time.perf_counter()
        while not Path(spec["after"]).exists():
            expect(time.perf_counter() - t0 < RING_TIMEOUT_S,
                   f"{spec['label']}: {spec['after']} never appeared")
            time.sleep(0.2)
        torch.cuda.reset_peak_memory_stats()
    rec = {}
    counters = _port_counters()
    for fn in counters.values():
        fn.launches = 0
    flash.reset_bh_counters()
    fnr.add_norm_bwd.instances.clear()
    state, history = cli.run(spec["argv"])
    torch.cuda.synchronize()
    rec["launches"] = {k: fn.launches for k, fn in counters.items()}
    rec["norm_bwd_instances"] = dict(fnr.add_norm_bwd.instances)
    rec["routes"] = {f"{fn.__name__}/{r}": n
                     for fn in flash.BH_WRAPPERS + flash.CHUNK_WRAPPERS
                     for r, n in fn.routes.items()}
    rec["losses"] = [m["loss"] for m in history]
    # the pipeline step carries no anomaly guard (as JAX's)
    rec["bad"] = [m.get("bad", 0) for m in history]
    rec["step_ms"] = [m["step_time_ms"] for m in history]
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    args = cli.build_parser().parse_args(spec["argv"])
    cfg = cli.config_from_args(args)
    mesh, layout = _mesh_of(torch, cfg, sg.backend)
    pipelined = cfg.mesh.pipeline > 1
    try:
        if pipelined:
            rec["checksum"] = _params_checksum(torch, state["params"])
            state, _ = shard_train_state(cfg, mesh, state)
            for t in leaves(state["params"]):  # a gathered state's are snapshots
                t.requires_grad_(True)
            step = pipeline.make_pipeline_train_step(cfg.replace(max_iters=1000), mesh)
            eval_step = pipeline.make_pipeline_eval_step(cfg, mesh)
        else:
            rec["checksum"] = _params_checksum(torch, full_params(state["params"], mesh,
                                                                  layout))
            step = make_sharded_train_step(cfg.replace(max_iters=1000), mesh, layout)
            eval_step = make_eval_step(cfg, mesh)
        opt = state["opt_state"]
        rec["rest_gib"] = sum(t.numel() * t.element_size() for part in (
            state["params"], opt["mu"], opt["nu"]) for t in leaves(part)) / 2 ** 30
        # steps on ONE repeated batch: the dropout-free eval loss on it
        # must fall; each step timed (synced) with its collectives
        g = torch.Generator(device=mesh.device)
        g.manual_seed(1)
        T = cfg.model.block_size
        idx = torch.randint(0, cfg.vocab_size, (cfg.grad_acc_steps, args.micro_batch_size,
                                                T + 1), generator=g, device=mesh.device)
        batch = {"x": idx[..., :-1], "y": idx[..., 1:]}
        rec["before"] = float(eval_step(model_params(state["params"], layout),
                                        batch["x"][0], batch["y"][0]))
        rec["repeat"], rec["repeat_ms"], rec["coll"], rec["a2a"] = [], [], [], []
        rec["rot"], rec["send"] = [], []
        for i in range(REPEAT_STEPS):
            torch.cuda.synchronize()
            pmesh.reset_collective_stats()
            pmesh.reset_send_stats()
            ulysses.reset_exchange_stats()
            ring.reset_rotation_stats()
            t0 = time.perf_counter()
            state, m = step(state, batch, fold_seed(99, i))
            torch.cuda.synchronize()
            rec["repeat_ms"].append(1e3 * (time.perf_counter() - t0))
            rec["coll"].append(dict(pmesh.STATS))
            rec["send"].append(dict(pmesh.SEND))
            rec["a2a"].append(dict(ulysses.EXCHANGE))
            rec["rot"].append(dict(ring.ROTATION))
            rec["repeat"].append(m["loss"])
        rec["after"] = float(eval_step(model_params(state["params"], layout),
                                       batch["x"][0], batch["y"][0]))
        rec["checksum_after"] = _params_checksum(
            torch, full_params(state["params"], mesh, layout))
        rec["coords"] = list(mesh.coords)
    finally:
        destroy_mesh(mesh)
    return rec


def mesh_grads(tcfg, mesh, layout, state, batch) -> list:
    """The full gradients (``leaves`` order) of one step of ``tcfg`` on
    this rank, through the path its sharded step takes: the overlap
    path's bucket means, the fsdp gather and reduce-scatter (the shards'
    gradients then gathered), the flat all-reduce, or the pipeline's
    schedule (each stage's gradients then gathered over the pipeline
    line); under tensor the tensor shards' gradients then gathered over
    the line."""
    from differential_transformer_replication_tpu_torch.parallel import (
        dp_step,
        pipeline,
        shard_batch,
    )
    from differential_transformer_replication_tpu_torch.train.optim import leaves, unflatten
    from differential_transformer_replication_tpu_torch.train.step import make_grad_fn

    if tcfg.mesh.pipeline > 1:
        local = shard_batch(batch, mesh)
        grads = pipeline.make_pipeline_loss(tcfg.resolved_model(), mesh)(
            state["params"], local["x"], local["y"], grads=True)[1]
        return leaves(dp_step.full_params(unflatten(state["params"], grads), mesh, None))
    if dp_step.overlap_eligible(tcfg):
        line = mesh.line("data")
        fn = make_grad_fn(tcfg, None, dp_step.make_param_sync(line, tcfg.dp_bucket_layers),
                          dp_step.tree_mean(line))
        return fn(state["params"], shard_batch(batch, mesh))[1]
    if layout is not None:
        fn = make_grad_fn(tcfg, mesh, dp_step.make_param_gather(layout))
        tree = fn(state["params"], batch)[1]
    else:
        grads = make_grad_fn(tcfg, mesh)(state["params"], batch)[1]
        tree = unflatten(state["params"], grads)
    return leaves(dp_step.full_params(tree, mesh, layout))


def _e2e_cfg(mesh: dict, B: int, impl: str, M: int = 1, L: int = 2):
    from differential_transformer_replication_tpu_torch.config import (
        MeshConfig,
        ModelConfig,
        TrainConfig,
    )

    mcfg = ModelConfig(**dict(RECIPE, n_layer=L, block_size=1024, sequence_impl=impl),
                       compute_dtype="float32")
    return TrainConfig(model=mcfg, mesh=MeshConfig(**mesh), vocab_size=RECIPE["vocab_size"],
                       micro_batch_size=B, grad_acc_steps=M, warmup_iters=0,
                       learning_rate=1e-3, sampler="replacement")


def mesh_e2e_task(torch, sg, spec: dict) -> dict:
    """One fp32 diff step from a seeded init on each mesh of
    ``MESH_E2E[P]``: loss, grad norm, the params' checksum (rank 0 saves
    the full grads and params for the comparison)."""
    from differential_transformer_replication_tpu_torch.parallel import (
        create_mesh,
        destroy_mesh,
        make_sharded_train_step,
        pipeline,
    )
    from differential_transformer_replication_tpu_torch.parallel.dp_step import (
        full_params,
        shard_train_state,
    )
    from differential_transformer_replication_tpu_torch.train.optim import leaves
    from differential_transformer_replication_tpu_torch.train.step import train_state

    rec = {}
    for label, mesh_axes, B, impl, M, L in MESH_E2E[sg.size]:
        tcfg = _e2e_cfg(mesh_axes, B, impl, M, L)
        mesh = create_mesh(tcfg.mesh, sg.backend, "cuda")
        try:
            params, batch = e2e_inputs(torch, tcfg)
            state, layout = shard_train_state(tcfg, mesh,
                                              train_state(params, tcfg, mesh.device))
            batch = {k: t.to(mesh.device) for k, t in batch.items()}
            grads = mesh_grads(tcfg, mesh, layout, state, batch)
            step = (pipeline.make_pipeline_train_step(tcfg, mesh) if tcfg.mesh.pipeline > 1
                    else make_sharded_train_step(tcfg, mesh, layout))
            state, m = step(state, batch)
            full = full_params(state["params"], mesh, layout)
            rec[label] = {"loss": m["loss"], "grad_norm": m["grad_norm"],
                          "checksum": _params_checksum(torch, full)}
            if sg.rank == 0:
                torch.save({"grads": [t.cpu() for t in grads],
                            "params": [t.detach().cpu() for t in leaves(full)]},
                           f"{spec['out']}.{label.replace(' ', '_')}.pt")
        finally:
            destroy_mesh(mesh)
    return rec


def mesh_e2e_reference(torch) -> dict:
    """The single-card fp32 diff step of train-mesh-e2e at each
    (micro-batch, grad-acc, layers) it uses (e2e_inputs), keyed by them."""
    from differential_transformer_replication_tpu_torch.train.optim import leaves
    from differential_transformer_replication_tpu_torch.train.step import (
        make_grad_fn,
        make_train_step,
        train_state,
    )

    ref = {}
    for B, M, L in sorted({(c[2], c[4], c[5]) for cases in MESH_E2E.values()
                           for c in cases}):
        tcfg = _e2e_cfg({}, B, "ring", M, L)
        params, batch = e2e_inputs(torch, tcfg)
        state = train_state(params, tcfg, "cuda")
        batch = {k: t.cuda() for k, t in batch.items()}
        _, grads = make_grad_fn(tcfg)(state["params"], batch)
        state, m = make_train_step(tcfg)(state, batch)
        ref[(B, M, L)] = (m, [g.cpu() for g in grads],
                  [t.detach().cpu() for t in leaves(state["params"])])
    return ref


def check_mesh_e2e(torch, P: int, ref: dict, recs: list, out: str) -> None:
    """train-mesh-e2e: each mesh's fp32 step against one card, the ring's
    bounds (check_ring_e2e)."""
    lr = 1e-3
    for label, _, B, _, M, L in MESH_E2E[P]:
        m, grads, params = ref[(B, M, L)]
        got = torch.load(f"{out}.{label.replace(' ', '_')}.pt")
        r0 = recs[0][label]
        rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(got["grads"], grads))
        p_max = max(float((a - b).abs().max()) for a, b in zip(got["params"], params))
        p_mean = max(float((a - b).abs().mean()) for a, b in zip(got["params"], params))
        log(f"[train-mesh-e2e] diff recipe width, {L} layers, fp32, T 1024, micro-batch "
            f"{B} x {M} grad-acc, {label} over {P} gloo ranks vs one card (grad-acc "
            f"{M}): loss {r0['loss']:.6f} vs "
            f"{m['loss']:.6f} (bound 1e-5), grad norm {r0['grad_norm']:.6f} vs "
            f"{m['grad_norm']:.6f} (1e-4 relative), worst gradient {rel:.3g} of its "
            f"leaf's max (1e-3), params after the step max {p_max:.3g} (2 lr = "
            f"{2 * lr}), mean {p_mean:.3g} (1e-6); params equal on all ranks")
        expect(abs(r0["loss"] - m["loss"]) <= 1e-5, f"mesh e2e {label}: loss")
        expect(abs(r0["grad_norm"] - m["grad_norm"]) <= 1e-4 * m["grad_norm"],
               f"mesh e2e {label}: grad norm")
        expect(rel <= 1e-3, f"mesh e2e {label}: gradients differ: {rel:.3g}")
        expect(p_max <= 2 * lr and p_mean <= 1e-6, f"mesh e2e {label}: params")
        expect(len({r[label]["checksum"] for r in recs}) == 1,
               f"mesh e2e {label}: the params differ between ranks")


def check_mesh_run(torch, card: str, label: str, P: int, run: tuple, backend: str,
                   recs: list, totals: dict) -> dict:
    """The checks of one train-mesh run on its ranks' records; returns its
    figures for the summary lines."""
    from differential_transformer_replication_tpu_torch.ops import flash

    _, flags, T, B, steps, L, rate, _, model = run

    def flag(name: str) -> int:
        return int(flags[flags.index(name) + 1]) if name in flags else 1

    seq, pp, M = flag("--sequence-parallel"), flag("--pipeline-parallel"), \
        flag("--grad-acc-steps")
    ulysses = "ulysses" in flags
    S = 1 if model == "control" else 2
    r0 = recs[0]
    losses = r0["losses"]
    expect(len(losses) == steps and all(math.isfinite(x) for x in losses),
           f"{label}: non-finite or missing losses {losses}")
    expect(all(b == 0 for b in r0["bad"]), f"{label}: a step was skipped")
    expect(all(r["losses"] == losses for r in recs),
           f"{label}: the ranks report different losses")
    expect(len({r["checksum"] for r in recs}) == 1
           and len({r["checksum_after"] for r in recs}) == 1,
           f"{label}: the params differ between ranks")
    n_fwd = steps + 2 * RING_EVAL_ITERS
    Tl = T // seq
    if seq > 1 and not ulysses:  # the ring over the sequence line
        fr, br = flash.chunk_fwd_route(Tl), flash.chunk_bwd_route(Tl)
        want = {f"flash_chunk_fwd/{fr}": L * seq * n_fwd,
                f"flash_chunk_bwd_dq/{br}": L * seq * steps,
                f"flash_chunk_bwd_dkv/{br}": L * seq * steps}
    elif ulysses or rate > 0:  # full T (over H / P heads, or this tensor
        # rank's heads): the aligned head-major routes; an eval at T <= 512
        # (no dropout) takes kernel D
        fr, br = flash.fwd_route(T), flash.bwd_route(S, T)
        n_bh = L * n_fwd if ulysses else L * steps
        want = {f"flash_bh_fwd/{fr}": n_bh}
        want.update({f"flash_bh_bwd_fused/{br}": L * steps} if br == "fused" else
                    {f"flash_bh_bwd_dq/{br}": L * steps, f"flash_bh_bwd_dkv/{br}": L * steps})
    else:  # T 512, dropout 0: the token-major kernels D and E
        want = {}
    for r in recs:
        expect(r["routes"] == want, f"{label} rank {r['rank']}: launches by route "
               f"{r['routes']}, expected {want}")
        # the add+LayerNorm backward: ln1, ln2 (and diff's GroupLayerNorm,
        # at full width on a tensor line) per layer, and ln_f
        norms = (2 if model == "control" else 3) * L + 1
        if pp > 1:  # this rank's stage: its Lp layers a microbatch; only the
            # last stage runs ln_f (and the lm head and the loss)
            Lp, last = L // pp, int(r["coords"][-1] == pp - 1)
            n_f, n_b = M * steps + 2 * RING_EVAL_ITERS, M * steps
            ln = 1 if model == "control" else 2  # ln1 (and diff's GroupLayerNorm)
            per = {"fused_norm": (ln * Lp + last) * n_f, "fused_add_norm": Lp * n_f,
                   "fused_swiglu": Lp * n_f, "flash_tm_fwd": Lp * n_f,
                   "flash_tm_bwd": Lp * n_b, "swiglu_bwd": Lp * n_b,
                   "add_norm_bwd": ((ln + 1) * Lp + last) * n_b}
        elif not want:
            per = {"flash_tm_fwd": L * n_fwd, "flash_tm_bwd": L * steps,
                   "swiglu_bwd": L * steps, "add_norm_bwd": norms * steps}
        elif seq == 1 and not ulysses:  # the evals' forwards on kernel D
            per = {"flash_tm_fwd": L * (n_fwd - steps), "flash_tm_bwd": 0,
                   "swiglu_bwd": L * steps, "add_norm_bwd": norms * steps}
        else:
            per = {}
        got = {k: r["launches"][k] for k in per}
        expect(got == per, f"{label} rank {r['rank']}: launches {got}, expected {per}")
        for name in ("fused_norm", "fused_add_norm", "fused_swiglu", "add_norm_bwd",
                     "swiglu_bwd"):
            expect(r["launches"][name] > 0, f"{label}: {name} never launched")
        expect_norm_bwd_instances(torch, f"{label} rank {r['rank']}",
                                  r["launches"]["add_norm_bwd"], r["norm_bwd_instances"])
    if backend == "gloo" and seq > 1 and not ulysses:
        for name, (fn, route) in RING_COUNTS.items():
            totals[name] += sum(r["routes"].get(f"{fn}/{route}", 0) for r in recs)
    expect(math.isfinite(r0["after"]) and r0["after"] < r0["before"],
           f"{label}: the loss on a repeated batch did not fall "
           f"({r0['before']} -> {r0['repeat']} -> {r0['after']})")
    # the repeated batch's steps past the first: the steady state
    ms = sorted(r0["repeat_ms"][1:])[len(r0["repeat_ms"][1:]) // 2]
    coll = r0["coll"][1:]
    coll_ms = 1e3 * sum(c["host_s"] for c in coll) / len(coll)
    coll_mb = sum(c["bytes"] for c in coll) / len(coll) / 2 ** 20
    a2a, rot, send = r0["a2a"][1:], r0["rot"][1:], r0["send"][1:]
    fig = {"ms": ms, "tok_s": M * B * T / (ms / 1e3), "coll_ms": coll_ms,
           "calls": coll[0]["calls"], "coll_mb": coll_mb,
           "a2a_ms": 1e3 * sum(c["host_s"] for c in a2a) / len(a2a),
           "rot_ms": 1e3 * sum(c["host_s"] for c in rot) / len(rot),
           "sends": send[0]["calls"], "recvs": send[0]["recv_calls"],
           "send_mb": sum(c["bytes"] for c in send) / len(send) / 2 ** 20,
           "send_ms": 1e3 * sum(c["host_s"] + c["recv_host_s"] for c in send) / len(send),
           "peaks": [round(r["peak_gib"], 2) for r in recs],
           "rest": [round(r["rest_gib"], 3) for r in recs]}
    if pp > 1:
        log(f"[train-mesh] {label}: rank 0 (stage 0) of {pp} stages, {M} microbatches "
            f"a step (bubble {(pp - 1) / (M + pp - 1):.3f} of the ticks): its sends "
            f"{fig['sends']} and receives {fig['recvs']} a step, {fig['send_mb']:.1f} MB "
            f"sent, {fig['send_ms']:.1f} ms of host time in both; the sums over the "
            f"pipeline line and the mesh (the replicated leaves' gradients, the loss, the "
            f"norm) {fig['calls']} calls, {coll_mb:.1f} MB, {coll_ms:.1f} ms host")
    log(f"[train-mesh] {label}: {model}, {L} layers, width {RECIPE['n_embd']}, T {T}, "
        f"global micro-batch {B} x {M} grad-acc, dropout {rate}, bf16, {P} {backend} "
        f"ranks sharing one "
        f"card ({card}); {steps} trainer steps, losses {[round(x, 4) for x in losses]}, "
        f"rank 0 step ms {[round(x, 1) for x in r0['step_ms']]}; repeated batch: "
        f"{ms:.1f} ms/step median past the first ({fig['tok_s']:.0f} tokens/s over the "
        f"mesh), the collectives {coll_ms:.1f} ms of host time a step ({fig['calls']} "
        f"calls, {coll_mb:.1f} MB in per rank), the all-to-alls {fig['a2a_ms']:.1f} ms, "
        f"the ring's exchanges {fig['rot_ms']:.1f} ms; "
        f"peak per rank {fig['peaks']} GiB, params + AdamW moments at rest per rank "
        f"{fig['rest']} GiB; launches per rank by route {want or 'kernels D and E'}; "
        f"params equal on all ranks ({r0['checksum'][:12]}); mesh coords "
        f"{[r['coords'] for r in recs]}")
    log(f"[train-mesh] {label}: launches on each rank by kernel "
        f"{[{k: r['launches'][k] for k in TRAIN_COUNTERS} for r in recs]}")
    log(f"[train-mesh] {label}: one repeated batch, loss {r0['before']:.4f} -> "
        f"{[round(x, 4) for x in r0['repeat']]} -> {r0['after']:.4f}")
    return fig


def pipeline_rest_share(torch, P: int) -> float:
    """The share of the recipe's params a pipeline stage holds: 1/P of
    the blocks, the embeddings, ln_f and lm_head whole."""
    from differential_transformer_replication_tpu_torch.config import ModelConfig
    from differential_transformer_replication_tpu_torch.models import init_model, param_count

    # one layer's params: the blocks are n_layer of its block
    params = init_model(torch.Generator(), ModelConfig(**dict(RECIPE, n_layer=1)))
    block = param_count(params["blocks"])
    rest = param_count(params) - block
    L = RECIPE["n_layer"]
    return (rest + L * block / P) / (rest + L * block)


def recipe_single_step(torch, card: str) -> dict:
    """One rank's step of the diff recipe (8 layers, T 512, micro-batch 32,
    bf16, dropout 0) on the card alone: the scale the train-mesh recipe
    runs stand beside."""
    from differential_transformer_replication_tpu_torch.config import (
        ModelConfig,
        TrainConfig,
    )
    from differential_transformer_replication_tpu_torch.train.step import (
        create_train_state,
        make_train_step,
    )

    cfg = TrainConfig(model=ModelConfig(**RECIPE), micro_batch_size=TRAIN_B,
                      warmup_iters=2, learning_rate=1e-3, sampler="replacement")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    state = create_train_state(g, cfg, "cuda")
    step = make_train_step(cfg)
    idx = torch.randint(0, RECIPE["vocab_size"], (1, TRAIN_B, RECIPE["block_size"] + 1),
                        generator=g, device="cuda")
    batch = {"x": idx[..., :-1], "y": idx[..., 1:]}
    times = []
    for _ in range(REPEAT_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    ms = sorted(times[1:])[len(times[1:]) // 2]
    fig = {"ms": ms, "tok_s": TRAIN_B * RECIPE["block_size"] / (ms / 1e3),
           "peak": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"[train-mesh] one rank, the diff recipe (8 layers, T 512, micro-batch 32, bf16): "
        f"{ms:.1f} ms/step median of {REPEAT_STEPS} past the first "
        f"({fig['tok_s']:.0f} tokens/s), peak {fig['peak']:.2f} GiB ({card})")
    del state, step
    torch.cuda.empty_cache()
    return fig


def start_train_ring(torch, tokens) -> dict:
    """Phase train-ring, with train-ring-e2e and train-mesh, its first
    half: the single-card reference steps, then every run at P ranks in
    one torch.distributed.run launch of P ranks (the trainer runs of
    RING_RUNS and MESH_RUNS, the fp32 steps against one card), so each
    launch's start (~25-35 s) is paid once per P. The gloo launches start
    here, side by side, and run beside the phases that follow (train-e2e,
    train-ckpt, train-full: processes of their own, launch counts of
    their own); the P = 2 launch's profile and recipe runs wait in it
    until :func:`finish_train_ring` finds the card theirs. The P = 2 runs
    also carry the heartbeat and the step watchdog: one heartbeat file
    per rank, no fire. Returns the phase's state for
    :func:`finish_train_ring`."""
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    hb_dir = out_dir / "ring_heartbeat"
    shutil.rmtree(hb_dir, ignore_errors=True)
    for stale in out_dir.glob("*.hang_report*"):
        stale.unlink()
    t0 = time.perf_counter()
    ref = ring_e2e_reference(torch)
    mref = mesh_e2e_reference(torch)
    log(f"[train-ring-e2e] the single-card reference steps in "
        f"{time.perf_counter() - t0:.1f} s")
    launches = []
    for P in sorted({run[2] for run in RING_RUNS}):
        runs = [(label, model, P, T, B, steps, "gloo")
                for label, model, p, T, B, steps in RING_RUNS if p == P]
        launches.append((P, "gloo", runs, True))
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        launches.append((2, "nccl", [("diff P=2 T=8192 nccl", "diff", 2, 8192, 2, 3,
                                      "nccl")], False))
    else:
        log(f"[train-ring] NCCL leg not run: this machine has {n_cards} card "
            "(it needs one card per rank, 2); the runs below are gloo ranks sharing "
            "one card")
        log(f"[train-mesh] NCCL leg (--data-parallel 2, --tensor-parallel 2 and "
            f"--pipeline-parallel 2 over nccl) not run: this machine has {n_cards} card "
            "(it needs one card per rank, 2); the mesh runs below are gloo ranks sharing "
            "one card")
    # the gloo launches run side by side (each launch's start, ~20 s, and
    # its runs overlap the other's); the step profile and the recipe runs,
    # tasks at the end of the P = 2 launch, wait until the P = 4 launch and
    # the phases beside it ended
    alone = out_dir / "ring_profile_alone"
    alone.unlink(missing_ok=True)
    def mesh_task(P, backend, run):
        label, flags, T, B, steps, L, rate, on_its_own, model = run
        name = re.sub(r"[^A-Za-z0-9]+", "_", label)
        argv = ring_argv(model, P, T, B, steps, tokens, backend,
                         str(out_dir / f"metrics_mesh_{name}.jsonl"), layers=L,
                         rate=rate, mesh=flags)
        return {"label": label, "task": "mesh", "argv": argv,
                **({"after": str(alone)} if on_its_own else {})}

    if n_cards >= 2:
        launches.append((2, "nccl", [], False))
    plans = []
    for P, backend, runs, with_e2e in launches:
        tasks = []
        for label, model, _, T, B, steps, _ in runs:
            argv = ring_argv(model, P, T, B, steps, tokens, backend,
                             str(out_dir / f"metrics_ring_{model}_P{P}_T{T}.jsonl"))
            if P == 2 and backend == "gloo":
                argv += ["--heartbeat-dir", str(hb_dir), "--step-deadline-s", "300",
                         "--heartbeat-timeout-s", "60"]
            tasks.append({"label": label, "task": "train", "argv": argv})
        mruns = [r for r in MESH_RUNS[P] if backend == "gloo"] if runs else \
            [(f"{r[0]} nccl", *r[1:7], False, r[8]) for r in MESH_RUNS[2]
             if r[0] in ("data=2 recipe", "tensor=2 recipe", "pipeline=2 recipe")]
        # the mesh runs that share the card with the other launch, then
        # the e2e steps; the P = 2 launch's profile and its recipe runs
        # wait for the P = 4 launch to end
        tasks += [mesh_task(P, backend, r) for r in mruns if not r[7]]
        if with_e2e:
            tasks.append({"label": f"e2e P={P}", "task": "e2e"})
            tasks.append({"label": f"mesh e2e P={P}", "task": "mesh_e2e"})
        if P == 2 and backend == "gloo":
            tasks.append({"label": "profile P=2", "task": "profile",
                          "argv": tasks[0]["argv"], "after": str(alone)})
        tasks += [mesh_task(P, backend, r) for r in mruns if r[7]]
        plans.append((P, backend, runs, with_e2e, tasks, mruns))

    procs = []

    def launch(plan, box):
        P, backend, _, _, tasks, _ = plan
        t0 = time.perf_counter()
        try:
            box["results"] = launch_ranks(P, backend, tasks, procs=procs)
        except BaseException as e:  # noqa: BLE001 - raised on the main thread
            box["error"] = e
        finally:
            box["wall"] = time.perf_counter() - t0

    gloo = [pl for pl in plans if pl[1] == "gloo"]
    boxes = [{} for _ in gloo]
    threads = [threading.Thread(target=launch, args=(pl, box), daemon=True)
               for pl, box in zip(gloo, boxes)]
    for th in threads:
        th.start()
    return dict(ref=ref, mref=mref, plans=plans, boxes=boxes, threads=threads,
                launch=launch, alone=alone, hb_dir=hb_dir, out_dir=out_dir,
                procs=procs)


def stop_train_ring(ring: dict) -> None:
    """Stop the train-ring launches still running (a phase beside them
    failed): no process of the smoke outlives it."""
    for proc in ring["procs"]:
        stop_process(proc)


def finish_train_ring(torch, card: str, ring: dict) -> dict:
    """Phase train-ring's second half, once the phases beside it ended:
    the card is the launches' alone (the P = 2 launch's profile and
    recipe runs go on once the P = 4 launch ended), the nccl launches
    with two or more cards, then every check of the runs' records.
    Returns the launch count of each ring JSON entry (wrapper and route),
    summed over the ranks of the gloo runs."""
    plans, boxes, threads = ring["plans"], ring["boxes"], ring["threads"]
    ref, mref, out_dir, hb_dir = ring["ref"], ring["mref"], ring["out_dir"], ring["hb_dir"]
    gloo = [pl for pl in plans if pl[1] == "gloo"]
    try:
        for pl, th in zip(gloo, threads):
            if pl[0] != 2:
                th.join(RING_TIMEOUT_S)
    finally:
        ring["alone"].touch()
    for th in threads:
        th.join(RING_TIMEOUT_S)
    for pl in plans[len(gloo):]:  # nccl: after the gloo launches
        boxes.append({})
        ring["launch"](pl, boxes[-1])
    totals = {name: 0 for name in RING_COUNTS}
    prof = None
    figs = {}
    for (P, backend, runs, with_e2e, tasks, mruns), box in zip(plans, boxes):
        if "error" in box:
            raise box["error"]
        expect("results" in box, f"P={P} {backend} launch: no end")
        results = box["results"]
        by_label = dict(zip((t["label"] for t in tasks), results))
        log(f"[train-ring] one P={P} {backend} launch{' beside the other' if backend == 'gloo' else ''}: "
            f"{len(tasks)} tasks ({', '.join(t['label'] for t in tasks)}) in "
            f"{box['wall']:.1f} s; in it "
            + ", ".join(f"{t['label']} {recs[0]['task_s']:.1f} s"
                        for t, recs in zip(tasks, results))
            + f"; the launch's start and exit "
            f"{box['wall'] - sum(r[0]['task_s'] for r in results):.1f} s")
        for (label, model, _, T, B, steps, _), recs in zip(runs, results):
            check_ring_run(torch, card, label, model, P, T, B, steps, backend, recs,
                           totals)
        for run in mruns:
            figs[run[0]] = check_mesh_run(torch, card, run[0], P, run, backend,
                                          by_label[run[0]], totals)
        if with_e2e:
            out = (out_dir / "ring" / f"e2e_P{P}")
            check_ring_e2e(torch, P, ref, by_label[f"e2e P={P}"], str(out))
            out = out_dir / "ring" / f"mesh_e2e_P{P}"
            check_mesh_e2e(torch, P, mref, by_label[f"mesh e2e P={P}"], str(out))
        if P == 2 and backend == "gloo":
            prof = by_label["profile P=2"][0]["profile"]
    # the P = 2 runs' liveness: a heartbeat file a rank, no watchdog fire
    beats = sorted(p.name for p in hb_dir.iterdir()) if hb_dir.exists() else []
    expect(beats == ["hb-0.json", "hb-1.json"], f"train-ring: heartbeat files {beats}")
    expect(not any(out_dir.glob("*.hang_report*")), "train-ring: the watchdog fired")
    log(f"[train-ring] P=2 runs with --heartbeat-dir and --step-deadline-s 300: "
        f"heartbeat files {beats} (last iters "
        f"{[json.loads((hb_dir / b).read_text())['iter'] for b in beats]}), no "
        "watchdog fire")
    # where the ring step's time goes: train/step_profile.py on the P = 2
    # ranks, the card theirs alone
    # the recipe on one rank beside the mesh runs of it, and the state at
    # rest under fsdp against data's
    one = recipe_single_step(torch, card)
    dp, fs = figs["data=2 recipe"], figs["fsdp=2 recipe"]
    ratio = max(fs["rest"]) / max(dp["rest"])
    log(f"[train-mesh] the diff recipe (8 layers, T 512, global micro-batch 32, bf16) "
        f"on 2 gloo ranks sharing one card against one rank: "
        + ", ".join(f"{k} {figs[k]['ms']:.1f} ms/step ({figs[k]['tok_s']:.0f} tok/s, "
                    f"collectives {figs[k]['coll_ms']:.1f} ms host, peak "
                    f"{max(figs[k]['peaks']):.2f} GiB)"
                    for k in ("data=2 recipe", "data=2 no-overlap recipe", "fsdp=2 recipe"))
        + f"; one rank {one['ms']:.1f} ms/step ({one['tok_s']:.0f} tok/s, peak "
        f"{one['peak']:.2f} GiB); fsdp's params + moments at rest {max(fs['rest']):.3f} "
        f"GiB a rank against data's {max(dp['rest']):.3f} ({ratio:.3f}); {card}")
    expect(0.49 <= ratio <= 0.51, f"fsdp=2 keeps {ratio:.3f} of data=2's state at rest")
    tp = figs["tensor=2 recipe"]
    t_ratio = max(tp["rest"]) / max(dp["rest"])
    log(f"[train-mesh] the diff recipe at --tensor-parallel 2 (2 of 4 heads, SwiGLU "
        f"width 1536, vocab 6000 a rank; gloo, ranks sharing one card): {tp['ms']:.1f} "
        f"ms/step ({tp['tok_s']:.0f} tok/s), the collectives {tp['calls']} calls, "
        f"{tp['coll_mb']:.1f} MB in per rank, {tp['coll_ms']:.1f} ms host a step; "
        f"against one rank {one['ms']:.1f} ms/step; peak per rank {tp['peaks']} GiB; "
        f"params + moments at rest {max(tp['rest']):.3f} GiB a rank against data's "
        f"{max(dp['rest']):.3f} ({t_ratio:.3f}); {card}")
    expect(0.49 <= t_ratio <= 0.51,
           f"tensor=2 keeps {t_ratio:.3f} of data=2's state at rest")
    # the pipeline recipe: a stage's 4 layers, the replicated embeddings
    # and head whole
    pp = figs["pipeline=2 recipe"]
    p_ratio = max(pp["rest"]) / max(dp["rest"])
    p_want = pipeline_rest_share(torch, 2)
    log(f"[train-mesh] the diff recipe at --pipeline-parallel 2 (4 of the 8 layers a "
        f"stage, 4 microbatches of 8 a step; gloo, ranks sharing one card): "
        f"{pp['ms']:.1f} ms/step ({pp['tok_s']:.0f} tok/s), against one rank "
        f"{one['ms']:.1f} ms/step ({one['tok_s']:.0f} tok/s); rank 0's sends "
        f"{pp['sends']} and receives {pp['recvs']} a step, {pp['send_mb']:.1f} MB, "
        f"{pp['send_ms']:.1f} ms host; the pipeline sum {pp['calls']} calls, "
        f"{pp['coll_mb']:.1f} MB, {pp['coll_ms']:.1f} ms host; peak per rank "
        f"{pp['peaks']} GiB; params + moments at rest {pp['rest']} GiB a rank against "
        f"data's {max(dp['rest']):.3f} ({p_ratio:.3f}; the blocks' half and the "
        f"replicated leaves: {p_want:.3f}); {card}")
    expect(abs(p_ratio - p_want) <= 0.01,
           f"pipeline=2 keeps {p_ratio:.3f} of data=2's state at rest, not {p_want:.3f}")
    expect(prof is not None, f"{RING_RUNS[0][0]}: no step profile")
    top = ", ".join(f"{k['name'][:40]} {k['ms_per_step']:.2f}"
                    for k in prof["top_kernels"][:8])
    log(f"[train-ring] step_profile diff P=2 T=8192 B=2 dropout {HM_RATE}, "
        f"{prof['n_layer']} layers, after the P=4 launch and the phases beside it "
        f"ended (gloo, ranks "
        f"sharing one card; rank 0 profiled): wall {prof['wall_ms_per_step']:.1f} ms "
        f"({prof['tokens_per_s']:.0f} tok/s over the ring), rank 0 busy "
        f"{prof['device_busy_ms_per_step']:.1f} ms, {prof['rotations_per_step']:.0f} "
        f"exchanges/step of {prof['rotation_mb_per_step']:.1f} MB in all, their host "
        f"time {prof['rotation_host_ms_per_step']:.1f} ms/step, peak "
        f"{prof['peak_device_memory_gib']:.2f} GiB, routes "
        f"{prof['head_major_routes_per_step']}; top device ms/step: {top}")
    return totals


# ---------------------------------------------------------------------------
# phase 6: one train step, the card's kernels against the CPU's plain versions
# ---------------------------------------------------------------------------


def run_train_e2e(torch) -> None:
    """Loss and every gradient of a 2-layer diff model at recipe width,
    fp32, micro-batch 2, on the card and on the CPU, from the same
    weights and batch."""
    from differential_transformer_replication_tpu_torch.config import ModelConfig
    from differential_transformer_replication_tpu_torch.models import (
        init_model,
        model_forward,
    )
    from differential_transformer_replication_tpu_torch.train.optim import (
        leaves,
        unflatten,
    )

    cfg = ModelConfig(**dict(RECIPE, n_layer=2), compute_dtype="float32")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    params = init_model(gen, cfg)
    idx = torch.randint(0, cfg.vocab_size, (2, cfg.block_size + 1), generator=gen)
    res = {}
    for dev in ("cuda", "cpu"):
        p = [t.to(dev).requires_grad_(True) for t in leaves(params)]
        tree = unflatten(params, p)
        _, loss = model_forward(tree, idx[:, :-1].to(dev), cfg,
                                targets=idx[:, 1:].to(dev))
        grads = torch.autograd.grad(loss, p)
        res[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    (lc, gc), (lh, gh) = res["cuda"], res["cpu"]
    rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
              for a, b in zip(gc, gh))
    # fp32 through 2 layers, sums in another order on each side
    log(f"[train-e2e] diff recipe width, 2 layers, fp32, micro-batch 2: loss "
        f"card {lc:.6f} vs CPU {lh:.6f} (bound 1e-4); worst gradient max-abs "
        f"relative to its leaf's max {rel:.3g} over {len(gc)} leaves (bound 1e-3)")
    expect(abs(lc - lh) <= 1e-4, f"loss card {lc} vs CPU {lh}")
    expect(rel <= 1e-3, f"gradients differ: {rel:.3g} > 1e-3")

    # the head-major route: T = 640 is past the token-major envelope
    from differential_transformer_replication_tpu_torch.ops import flash

    cfg = ModelConfig(**dict(RECIPE, n_layer=2, block_size=640),
                      compute_dtype="float32")
    gen.manual_seed(5)
    params = init_model(gen, cfg)
    idx = torch.randint(0, cfg.vocab_size, (1, 641), generator=gen)
    flash.reset_bh_counters()
    res = {}
    for dev in ("cuda", "cpu"):
        p = [t.to(dev).requires_grad_(True) for t in leaves(params)]
        _, loss = model_forward(unflatten(params, p), idx[:, :-1].to(dev), cfg,
                                targets=idx[:, 1:].to(dev))
        res[dev] = (float(loss.detach()),
                    [g.cpu() for g in torch.autograd.grad(loss, p)])
    expect(flash.flash_bh_fwd.routes["resident"] == 2
           and flash.flash_bh_bwd_dq.routes["split"] == 2,
           "the T = 640 step did not run the head-major kernels")
    (lc, gc), (lh, gh) = res["cuda"], res["cpu"]
    rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
              for a, b in zip(gc, gh))
    log(f"[train-e2e] diff recipe width, 2 layers, fp32, T 640 (head-major, "
        f"dropout 0), micro-batch 1: loss card {lc:.6f} vs CPU {lh:.6f} (bound "
        f"1e-4); worst gradient max-abs relative to its leaf's max {rel:.3g} "
        f"(bound 1e-3)")
    expect(abs(lc - lh) <= 1e-4, f"T=640: loss card {lc} vs CPU {lh}")
    expect(rel <= 1e-3, f"T=640: gradients differ: {rel:.3g} > 1e-3")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase train-ckpt: the default recipe from text (corpus, BPE, epoch
# sampler) with checkpoints, killed and resumed, then its best checkpoint
# sampled and served, through the command lines in processes of their own
# ---------------------------------------------------------------------------

CKPT_N = 6          # steps between step checkpoints and evals; runs of 2N
CKPT_LAYERS = 2     # the recipe's width at a quarter of its depth: the smoke's time
                    # limit (the host's process starts and steps dominate)
CKPT_B = 8          # micro-batch
CKPT_ACC = 48       # grad-acc steps: 384 windows a step, so 2N steps cross
CKPT_DOCS = 200     # synthetic documents: the stream crosses an epoch in the
                    # resumed half and leaves the eval its validation windows
CKPT_EVAL_ITERS = 2
CKPT_PROMPTS = (5, 40, 97, 200)  # greedy token requests to the served checkpoint
CKPT_TEXT_DOCS = (1, 2, 4, 8)    # greedy text requests: synthetic documents each
CKPT_NEW = 24
CKPT_SAMPLE_NEW = 64             # sample, generate_cached route (n 2)
CKPT_WINDOWED_NEW = 40           # sample, windowed route: a prompt near 512
CKPT_TIMEOUT_S = 300


def ckpt_argv(tok_dir, run_dir, *extra) -> list:
    """The trainer's command line for one train-ckpt run: the diff recipe
    at full width, ``CKPT_LAYERS`` deep, from the synthetic corpus (BPE target vocab
    12000, the tokenizer's own size in the end), bf16 compute, the epoch
    sampler, async step checkpoints and an eval every N steps."""
    return ["--model", "diff", "--dataset", "synthetic", "--num-train-samples",
            str(CKPT_DOCS), "--tokenizer-dir", str(tok_dir), "--device", "cuda",
            "--n-embd", str(RECIPE["n_embd"]), "--n-head", str(RECIPE["n_head"]),
            "--n-layer", str(CKPT_LAYERS),
            "--block-size", str(RECIPE["block_size"]),
            "--vocab-size", str(RECIPE["vocab_size"]), "--compute-dtype", "bfloat16",
            "--micro-batch-size", str(CKPT_B), "--grad-acc-steps", str(CKPT_ACC),
            "--max-iters", str(2 * CKPT_N), "--eval-interval", str(CKPT_N),
            "--eval-iters", str(CKPT_EVAL_ITERS), "--log-interval", "1",
            "--warmup-iters", "2", "--learning-rate", "1e-3", "--seed", "0",
            "--sampler", "epoch", "--ckpt-interval", str(CKPT_N), "--ckpt-async",
            "--checkpoint-path", str(Path(run_dir) / "best.ckpt"),
            "--metrics-path", str(Path(run_dir) / "metrics.jsonl"), *extra]


def ckpt_stream():
    """(tokenizer, tokens) of the train-ckpt corpus (CKPT_DOCS synthetic
    documents, seed 0, the port's BPE), held to what the run needs: an
    epoch of training windows between N and 2N steps of batches, and
    enough validation windows for the eval."""
    from differential_transformer_replication_tpu_torch.data.corpus import (
        synthetic_corpus,
    )
    from differential_transformer_replication_tpu_torch.data.tokenizer import (
        encode_corpus,
        train_bpe_tokenizer,
    )

    per_step, T = CKPT_B * CKPT_ACC, RECIPE["block_size"]
    texts = synthetic_corpus(CKPT_DOCS, 0)
    tok = train_bpe_tokenizer(texts, RECIPE["vocab_size"], 2, None)
    tokens = encode_corpus(tok, texts)
    n_train = int(0.9 * len(tokens))
    expect(CKPT_N * per_step < n_train - T < 2 * CKPT_N * per_step
           and len(tokens) - n_train - T >= CKPT_B * CKPT_EVAL_ITERS,
           f"train-ckpt: {CKPT_DOCS} documents give {len(tokens)} tokens, "
           f"{n_train - T} training windows (an epoch must end between "
           f"{CKPT_N * per_step} and {2 * CKPT_N * per_step}) and "
           f"{len(tokens) - n_train - T} validation windows (the eval needs "
           f"{CKPT_B * CKPT_EVAL_ITERS})")
    return tok, tokens


def cli_worker(spec: dict) -> int:
    """A process of the train-ckpt phase (``--cli-worker``): the trainer's,
    the server's or the sampler's command line, run in this process with
    the kernel wrappers' counts set to 0 before and written to
    ``spec["out"]`` after (a process killed before its end writes none).
    ``sample`` runs each of ``spec["runs"]`` in turn, with its counts and
    its standard output and error recorded apart. A ``{pid}`` in
    ``spec["out"]`` becomes this process's id (a serve-fleet replica
    relaunched on the same command line writes a file of its own)."""
    import contextlib
    import io
    import sys as _sys

    counters = dict(_train_counters(), **_req_counters())
    spec = dict(spec, out=spec["out"].replace("{pid}", str(os.getpid())))
    carry = counters["add_norm_bwd"]

    def zero():
        for fn in counters.values():
            fn.launches = 0
        carry.carry_launches = 0

    def counts():
        out = {name: fn.launches for name, fn in counters.items()}
        out["add_norm_bwd_carry"] = carry.carry_launches
        return out

    zero()
    if spec["cli"] == "train":
        import torch

        from differential_transformer_replication_tpu_torch.train import __main__ as cli

        rc = cli.main(spec["argv"])
        out = counts()
        out["peak_mib"] = (torch.cuda.max_memory_allocated() / 2 ** 20
                           if torch.cuda.is_available() else 0.0)
        Path(spec["out"]).write_text(json.dumps(out))
        return rc
    elif spec["cli"] == "sample":
        from differential_transformer_replication_tpu_torch import sample

        rc, runs = 0, []
        for argv in spec["runs"]:
            zero()
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc |= sample.main(argv)
            runs.append({"counts": counts(), "stdout": out.getvalue(),
                         "stderr": err.getvalue()})
        Path(spec["out"]).write_text(json.dumps(runs))
        return rc
    else:
        t_torch = time.time()  # main() imported torch before this call
        from differential_transformer_replication_tpu_torch.serving import server

        _sys.argv = ["server", *spec["argv"]]
        server.main()
        rc = 0
        Path(spec["out"]).write_text(json.dumps(
            {**counts(), "timeline": {"module": T_IMPORT, "torch": t_torch}}))
        return rc
    Path(spec["out"]).write_text(json.dumps(counts()))
    return rc


def start_worker(cli: str, argv: list, out: Path, env: dict = None,
                 **spec) -> subprocess.Popen:
    out.unlink(missing_ok=True)
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--cli-worker",
         json.dumps({"cli": cli, "argv": argv, "out": str(out), **spec})],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=None if env is None else {**os.environ, **env})


def finish_worker(proc: subprocess.Popen, label: str, timeout: float = CKPT_TIMEOUT_S,
                  rc: int = 0) -> str:
    try:
        out = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        out = proc.communicate()[0]
        raise Failure(f"{label}: no end within {timeout} s:\n{out[-4000:]}")
    expect(proc.returncode == rc, f"{label}: exit {proc.returncode}, expected {rc}:\n"
           f"{out[-6000:]}")
    return out


def step_records(path: Path) -> list:
    return [r for r in map(json.loads, path.read_text().splitlines()) if "loss" in r]


def state_bytes(ckpt_dir: Path) -> bytes:
    return (ckpt_dir / "state.msgpack").read_bytes()


def expect_train_launches(counts: dict, steps: int, label: str) -> None:
    """The backward kernels ran once per layer and microbatch of each step
    (never in eval); every forward kernel of the path launched."""
    L, A = CKPT_LAYERS, CKPT_ACC
    per_micro = {"flash_tm_bwd": L, "swiglu_bwd": L, "add_norm_bwd": 3 * L + 1,
                 "add_norm_bwd_carry": L}
    for name, per in per_micro.items():
        expect(counts[name] == per * A * steps,
               f"{label}: {name} launched {counts[name]} times, expected "
               f"{per * A * steps}")
    for name in ("flash_tm_fwd", "fused_norm", "fused_add_norm", "fused_swiglu"):
        expect(counts[name] > 0, f"{label}: {name} never launched")


def ckpt_samples(torch, params, mcfg, tok, tok_dir: Path, ckpt: Path, work: Path,
                 card: str) -> None:
    """(b) the ``sample`` command line on the best checkpoint, greedy, once
    through generate_cached (in the window) and once through the windowed
    generate (a prompt near 512 tokens plus new tokens past it): its text
    equals the in-process generators' output decoded by the tokenizer,
    with the decode kernel's and kernel D's launches of each run."""
    from differential_transformer_replication_tpu_torch.data.corpus import (
        synthetic_corpus,
    )
    from differential_transformer_replication_tpu_torch.models import (
        generate,
        generate_cached,
    )

    T, L = RECIPE["block_size"], CKPT_LAYERS
    long_ids = tok.encode(" ".join(synthetic_corpus(40, seed=5))).ids
    long_prompt = tok.decode(long_ids[-(T - 24):])  # ~488 tokens: 488 + 40 > 512
    cases = (("generate_cached", "One day, Tom", CKPT_SAMPLE_NEW, 2, generate_cached),
             ("generate", long_prompt, CKPT_WINDOWED_NEW, 1, generate))
    runs, want, rates = [], [], {}
    for route, prompt, new, n, fn in cases:
        ids = tok.encode(prompt).ids
        expect((len(ids) + new > T) == (route == "generate"),
               f"train-ckpt: the {route} prompt ({len(ids)} + {new} tokens) takes "
               "the other route")
        idx = torch.tensor([ids] * n, dtype=torch.int64, device="cuda")
        for rep in range(2):  # the second call timed: first-use costs paid
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(params, idx, mcfg, new, 0, temperature=0.0)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        rates[route] = (n * new / dt, dt, n, new, len(ids))
        want.append("".join(f"--- sample {i} ---\n{tok.decode(row)}\n"
                            for i, row in enumerate(out.tolist())))
        runs.append(["--checkpoint", str(ckpt), "--tokenizer", str(tok_dir),
                     "--prompt", prompt, "--max-new-tokens", str(new), "--n", str(n),
                     "--temperature", "0", "--device", "cuda"])
    proc = start_worker("sample", [], work / "sample.json", runs=runs)
    finish_worker(proc, "train-ckpt sample")
    got = json.loads((work / "sample.json").read_text())
    for (route, _, new, n, _), rec, text in zip(cases, got, want):
        c = rec["counts"]
        rate = re.search(r"\(([\d.]+) tokens/s\)", rec["stderr"])
        log(f"[train-ckpt] (b) sample --temperature 0 --n {n} --max-new-tokens {new} "
            f"through {route} ({rates[route][4]} prompt tokens): text "
            f"{'equal to' if rec['stdout'] == text else 'DIFFERENT from'} the "
            f"in-process {route} decoded by the tokenizer; launches decode_attention "
            f"{c['decode_attention']}, flash_tm_fwd {c['flash_tm_fwd']}, fused_swiglu "
            f"{c['fused_swiglu']}; the CLI's own rate "
            f"{rate.group(1) if rate else '?'} tokens/s (first call in its process)")
        expect(rec["stdout"] == text, f"train-ckpt: sample through {route} printed\n"
               f"{rec['stdout'][:2000]}\nnot\n{text[:2000]}")
        expect(f"through {route} in" in rec["stderr"],
               f"train-ckpt: sample took another route: {rec['stderr']}")
        if route == "generate_cached":  # one decode step a layer and new token
            expect(c["decode_attention"] == L * (new - 1) and c["flash_tm_fwd"] == 0,
                   f"train-ckpt: generate_cached launches {c}")
        else:  # a full window forward a token: kernel D a layer
            expect(c["flash_tm_fwd"] == L * new and c["decode_attention"] == 0,
                   f"train-ckpt: generate launches {c}")
        expect(c["fused_swiglu"] > 0 and c["fused_norm"] > 0,
               f"train-ckpt: sample through {route}: kernels did not launch {c}")
    log(f"[train-ckpt] (d) sampling at the diff recipe, in process, greedy, second "
        f"call: " + "; ".join(
            f"{route} {r[0]:.1f} tokens/s ({r[2]} x {r[3]} new tokens in {r[1]:.3f} s)"
            for route, r in rates.items()) + f"; {card}")


def ckpt_serving(torch, params, mcfg, meta, tok, tok_dir: Path, a: Path, work: Path,
                 card: str) -> None:
    """train-ckpt (b) and (c) on run a's best checkpoint: the ``sample``
    command line against the in-process generators, and the server with
    ``--tokenizer`` against the in-process engine (run on a thread beside
    the killed and the resumed runs)."""
    import socket

    import numpy as np

    from differential_transformer_replication_tpu_torch.config import ServingConfig
    from differential_transformer_replication_tpu_torch.data.corpus import (
        synthetic_corpus,
    )
    from differential_transformer_replication_tpu_torch.serving.engine import (
        ServingEngine,
    )

    # (c) the server, started first so that it comes up while (b) runs
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    proc = start_worker("serve", ["--checkpoint", str(a / "best.ckpt"),
                                  "--tokenizer", str(tok_dir),
                                  "--device", "cuda", "--port", str(port),
                                  "--num-slots", "8", "--prefill-chunk", "128",
                                  "--prefill-budget", "256"], work / "s.json")
    url = f"http://127.0.0.1:{port}"
    try:
        # (b) the sample command line against the in-process generators
        ckpt_samples(torch, params, mcfg, tok, tok_dir, a / "best.ckpt", work, card)
        # (c) against the in-process engine: token prompts, then text prompts
        serving = dict(num_slots=8, prefill_chunk=128, prefill_budget=256)
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, mcfg.vocab_size, n).tolist() for n in CKPT_PROMPTS]
        texts = [" ".join(synthetic_corpus(k, seed=6 + k)) for k in CKPT_TEXT_DOCS]
        engine = ServingEngine(params, mcfg, ServingConfig(**serving), device="cuda")
        want = [engine.generate([p], max_new_tokens=CKPT_NEW, temperature=0.0)[0].tokens
                for p in prompts + [tok.encode(t).ids for t in texts]]
        del engine, params
        torch.cuda.empty_cache()
        while True:
            try:
                with urllib.request.urlopen(url + "/health", timeout=5) as r:
                    if json.load(r)["ok"]:
                        break
            except OSError:
                expect(proc.poll() is None and time.perf_counter() - t0 < CKPT_TIMEOUT_S,
                       f"train-ckpt: the server did not come up:\n"
                       f"{proc.stdout.read() if proc.poll() is not None else ''}")
                time.sleep(0.2)
        up_s = time.perf_counter() - t0
        replies = []
        for body in ([{"prompt_ids": p} for p in prompts]
                     + [{"prompt": t} for t in texts]):
            # one at a time, as the engine ran them
            status, reply = _post(url + "/generate", dict(
                body, max_new_tokens=CKPT_NEW, temperature=0.0))
            expect(status == 200, f"train-ckpt: /generate answered {status}")
            replies.append(reply)
    finally:
        proc.send_signal(15)
    out_s = finish_worker(proc, "train-ckpt server")
    served = json.loads((work / "s.json").read_text())
    expect(served["decode_attention"] > 0 and served["fused_swiglu"] > 0
           and served["fused_norm"] > 0 and served["fused_add_norm"] > 0,
           f"train-ckpt: the server's kernels did not launch: {served}")
    expect(str(a / "best.ckpt") in out_s, "train-ckpt: the server did not name "
           "its checkpoint")
    got = [r["tokens"] for r in replies]
    text_ok = all(r["prompt_ids"] == tok.encode(t).ids
                  and r["text"] == tok.decode(r["tokens"])
                  for r, t in zip(replies[len(prompts):], texts))
    log(f"[train-ckpt] (c) server on {a / 'best.ckpt'} with --tokenizer (step "
        f"{meta['iter_num']}, up within {up_s:.1f} s of its start, (b) and the "
        f"engine's runs beside it): {len(prompts)} greedy token "
        f"requests of {list(CKPT_PROMPTS)} prompt tokens and {len(texts)} greedy "
        f"text requests of {[len(tok.encode(t).ids) for t in texts]} tokens, "
        f"{CKPT_NEW} new tokens each, "
        f"{'equal to' if got == want else 'DIFFERENT from'} the in-process engine on "
        f"load_params_for_inference of the same directory (text prompts on "
        f"encode(text)); replies' \"text\" "
        f"{'equal to' if text_ok else 'DIFFERENT from'} decode(tokens), e.g. "
        f"{replies[-1]['text'][:60]!r}; server launches "
        f"{ {k: served[k] for k in ('decode_attention', 'fused_swiglu', 'fused_norm', 'fused_add_norm')} }")
    expect(got == want, f"train-ckpt: served tokens {got} != engine tokens {want}")
    expect(text_ok, "train-ckpt: a text reply's prompt or text is not the "
           "tokenizer's")


def run_train_ckpt(torch, card: str, work: Path) -> dict:
    """Phase train-ckpt, from text: (a) the corpus, the BPE and the epoch
    sampler across an epoch boundary, the first run building the cache
    and the later ones loading it; a run killed by SIGKILL after its
    step-N checkpoint and resumed with ``--resume-from auto`` ends
    bit-equal to an uninterrupted 2N-step run, every checkpoint carrying
    the tokenizer's fingerprint; (b) the ``sample`` command line on the
    best checkpoint; (c) the server on it gives the in-process engine's
    greedy tokens for token and text prompts; (d) the host's data,
    sampling and checkpoint costs. Works in ``work``, where the
    uninterrupted run stays (``a/``) for train-full. Returns the
    uninterrupted run's launch counts and wall seconds."""
    import numpy as np

    from differential_transformer_replication_tpu_torch.data.native import (
        EpochPermutation,
    )
    from differential_transformer_replication_tpu_torch.data.tokenizer import (
        load_tokenizer,
        tokenizer_fingerprint,
    )
    from differential_transformer_replication_tpu_torch.models import param_count
    from differential_transformer_replication_tpu_torch.train.checkpoint import (
        load_params_for_inference,
        read_meta,
    )
    from differential_transformer_replication_tpu_torch.train.ckpt_writer import (
        step_dir_name,
        verify_checkpoint,
    )

    N = CKPT_N
    t0 = time.perf_counter()
    tok_pred, stream = ckpt_stream()
    pred_s = time.perf_counter() - t0
    tok_dir = work / "tok"
    windows = int(0.9 * len(stream)) - RECIPE["block_size"]
    per_step = CKPT_B * CKPT_ACC
    # (a) where the epoch boundary falls, from the port's permutation
    perm = EpochPermutation(windows, 0)
    cross = 0
    while perm.epoch == 0:
        perm.take(per_step)
        cross += 1
    log(f"[train-ckpt] (a) corpus: {CKPT_DOCS} synthetic documents (seed 0), BPE "
        f"vocab {tok_pred.get_vocab_size()}, {len(stream)} tokens (predicted in "
        f"process in {pred_s:.2f} s); epoch sampler: {windows} training windows "
        f"an epoch, {per_step} a step (micro-batch {CKPT_B} x {CKPT_ACC}); step "
        f"{cross} crosses into epoch 1, after the resume at step {N} (the draws "
        f"equal the JAX package's EpochPermutation bit for bit: "
        f"tests/test_torch_data.py)")
    # 1. the uninterrupted run: builds the corpus cache
    a, b = work / "a", work / "b"
    a.mkdir()
    b.mkdir()
    t0 = time.perf_counter()
    proc = start_worker("train", ckpt_argv(tok_dir, a), work / "a.json")
    out_a = finish_worker(proc, "train-ckpt uninterrupted run")
    wall_a = time.perf_counter() - t0
    counts = json.loads((work / "a.json").read_text())
    expect_train_launches(counts, 2 * N, "train-ckpt uninterrupted run")
    miss = re.search(r"\[data\] cache miss: .*? in ([\d.]+) s; BPE trained in "
                     r"([\d.]+) s; (\d+) tokens encoded in ([\d.]+) s \((\d+) "
                     r"tokens/s\)", out_a)
    expect(miss is not None, f"train-ckpt: the first run built no cache:\n{out_a[-3000:]}")
    (entry,) = [p for p in tok_dir.iterdir() if p.name.startswith("cache-")]
    cached = np.load(entry / "tokens.npy")
    expect(np.array_equal(cached, stream), "train-ckpt: the CLI's cached stream "
           "differs from the in-process corpus + BPE")
    tok = load_tokenizer(str(tok_dir))
    fp = tokenizer_fingerprint(tok)
    expect(fp == tokenizer_fingerprint(tok_pred) == tokenizer_fingerprint(
        load_tokenizer(str(entry))), "train-ckpt: the tokenizers differ")
    t0 = time.perf_counter()
    params, mcfg, meta = load_params_for_inference(str(a / "best.ckpt"), device="cuda")
    load_s = time.perf_counter() - t0
    expect(meta["consumed_windows"] % per_step == 0 and meta["iter_num"] > 0,
           f"train-ckpt: best checkpoint meta {meta['iter_num']}, "
           f"{meta['consumed_windows']}")
    expect(mcfg.vocab_size == tok.get_vocab_size(), f"train-ckpt: model vocab "
           f"{mcfg.vocab_size} is not the tokenizer's {tok.get_vocab_size()}")
    n_params = param_count(params)
    # (b) and (c) on run a's best checkpoint, on a thread beside 2. and 3.
    serving = {}

    def serve_side():
        try:
            ckpt_serving(torch, params, mcfg, meta, tok, tok_dir, a, work, card)
        except BaseException as e:  # noqa: BLE001 - raised on the main thread
            serving["error"] = e

    thread = threading.Thread(target=serve_side, daemon=True)
    thread.start()
    del params
    # 2. the run killed once its step-N checkpoint is certified
    t0 = time.perf_counter()
    proc = start_worker("train", ckpt_argv(tok_dir, b), work / "b.json")
    manifest = b / "best.steps" / step_dir_name(N) / "manifest.json"
    while not manifest.exists() and proc.poll() is None \
            and time.perf_counter() - t0 < CKPT_TIMEOUT_S:
        time.sleep(0.01)
    proc.send_signal(9)
    out_b = finish_worker(proc, "train-ckpt killed run", rc=-9)
    killed_at = max(r["iter"] for r in step_records(b / "metrics.jsonl"))
    # 3. the resume
    t0 = time.perf_counter()
    proc = start_worker("train", ckpt_argv(tok_dir, b, "--resume-from",
                                           "auto"), work / "c.json")
    out_c = finish_worker(proc, "train-ckpt resumed run")
    wall_c = time.perf_counter() - t0
    resumed = re.search(r"resuming from (\S+)", out_c)
    expect(resumed is not None, f"train-ckpt: the resume found no checkpoint:\n{out_c}")
    resumed_step = read_meta(resumed.group(1))["iter_num"]
    counts_c = json.loads((work / "c.json").read_text())
    expect_train_launches(counts_c, 2 * N - resumed_step, "train-ckpt resumed run")
    hits = [re.search(r"\[data\] cache hit: tokenizer and stream loaded in "
                      r"([\d.]+) s", o) for o in (out_b, out_c)]
    expect(all(hits), "train-ckpt: the killed or resumed run missed the cache")
    # every checkpoint of both runs records the tokenizer's fingerprint
    metas = [p.parent for p in a.rglob("meta.json")] + \
        [p.parent for p in b.rglob("meta.json")]
    bad_fp = [str(m) for m in metas if read_meta(str(m)).get(
        "tokenizer_fingerprint") != fp]
    expect(len(metas) >= 6 and not bad_fp, f"train-ckpt: checkpoints without the "
           f"fingerprint {fp}: {bad_fp} (of {len(metas)})")
    log(f"[train-ckpt] (a) the first run built the cache {entry.name} from "
        f"--dataset synthetic (the stream equal to the in-process build), the "
        f"killed and the resumed run loaded it; {len(metas)} checkpoints "
        f"(best, last, step) all record tokenizer fingerprint {fp}")
    # bit for bit: the train states (params, mu, nu, counts, step)
    # serialize to the same bytes, and every step's loss is equal
    ra, rb = step_records(a / "metrics.jsonl"), step_records(b / "metrics.jsonl")
    la = {r["iter"]: r["loss"] for r in ra}
    expect(sorted(la) == list(range(1, 2 * N + 1)), f"train-ckpt: steps {sorted(la)}")
    unequal = [(r["iter"], r["loss"], la[r["iter"]]) for r in rb
               if r["loss"] != la[r["iter"]]]
    same = state_bytes(a / "best.last.ckpt") == state_bytes(b / "best.last.ckpt")
    log(f"[train-ckpt] (a) killed at step {killed_at} (SIGKILL once "
        f"step-{N} was certified), resumed from {resumed.group(1)} (step "
        f"{resumed_step}) to {2 * N}: state.msgpack of the last checkpoints "
        f"{'bit-equal' if same else 'DIFFERENT'}, {len(rb)} step losses of the "
        f"killed and resumed runs against the uninterrupted run's, "
        f"{len(unequal)} unequal {unequal[:4]}; losses "
        f"{[round(la[i], 4) for i in sorted(la)]}")
    expect(same and not unequal, "train-ckpt: the resumed run is not bit-equal "
           "to the uninterrupted run")
    # (d) costs on this machine's disk
    save_ms = [r["ckpt_save_ms"] for r in ra if "ckpt_save_ms" in r]
    blocked = [r["ckpt_blocked_ms"] for r in ra if r["iter"] % N == 0]
    loop = [r["ckpt_loop_ms"] for r in ra if r["iter"] % N == 0]
    best_s = [float(x) for x in re.findall(r"\[ckpt\] best checkpoint written to "
                                           r"\S+ in ([\d.]+) s", out_a)]
    last_s = [float(x) for x in re.findall(r"\[ckpt\] last checkpoint written to "
                                           r"\S+ in ([\d.]+) s", out_a)]
    step_dir = a / "best.steps" / step_dir_name(2 * N)
    mb = sum(f.stat().st_size for f in step_dir.iterdir()) / 1e6
    t0 = time.perf_counter()
    verify_checkpoint(str(step_dir))
    verify_s = time.perf_counter() - t0
    log(f"[train-ckpt] (d) data on this host: corpus of {CKPT_DOCS} documents "
        f"{miss.group(1)} s, BPE trained in {miss.group(2)} s, {miss.group(3)} "
        f"tokens encoded in {miss.group(4)} s ({miss.group(5)} tokens/s); cache "
        f"hits loaded in {hits[0].group(1)} s and {hits[1].group(1)} s; {card}")
    log(f"[train-ckpt] (d) checkpoint {mb:.1f} MB (state.msgpack + meta + manifest, "
        f"{n_params / 1e6:.1f} M params and two "
        f"moments); async step saves {sorted({round(x / 1e3, 3) for x in save_ms})} s "
        f"on the writer thread; the "
        f"loop's time in each periodic save {[round(x, 1) for x in loop]} ms, of it "
        f"blocked on the previous save {[round(x, 1) for x in blocked]} ms; best "
        f"(inline) saves {best_s} s; last {last_s} s; verify "
        f"{verify_s:.3f} s (beside (b) and (c)); load for inference {load_s:.3f} s; "
        f"uninterrupted run {wall_a:.1f} s, resumed run {wall_c:.1f} s (process start "
        f"included; (b) and (c) beside it); {card}")
    thread.join(CKPT_TIMEOUT_S)
    if "error" in serving:
        raise serving["error"]
    expect(not thread.is_alive(), "train-ckpt: (b) and (c) did not end")
    log(f"[train-ckpt] uninterrupted run launches {counts}")
    return {"counts": counts, "wall_a": wall_a}


# the JAX trainer's metric families on its sidecar, less
# train_compile_events_total (eager PyTorch has no compile cache);
# train_heartbeat_age_seconds is labelled by peer and a single process
# has no peer
TRAIN_FAMILIES = ("build_info", "process_start_time_seconds", "train_step_seconds",
                  "train_data_wait_seconds", "train_data_stall_ratio",
                  "train_device_memory_peak_mb", "train_iterations_total",
                  "train_anomaly_events_total", "ckpt_save_seconds",
                  "ckpt_blocked_seconds", "ckpt_verify_failures_total",
                  "ckpt_save_failures_total", "train_watchdog_fires_total")
# kernels the profiler window must name (the port's hand-written ones)
PROFILED_KERNELS = ("tm_fwd_mma", "tm_bwd_dq_mma", "tm_bwd_dk_mma", "tm_bwd_dv_mma",
                    "swiglu_act_wgmma", "addnorm_bwd_warp")
FULL_HANG_AT = 8     # (g): train_hang's iteration
FULL_DEADLINE_S = 10


def scrape_while_running(proc, url: str, want_iters: int) -> dict:
    """Scrape ``url`` every 0.25 s while ``proc`` runs (a thread, so the
    caller can drain the process's output); keep the first parse whose
    ``train_iterations_total`` reaches ``want_iters``, and the last."""
    from differential_transformer_replication_tpu_torch.obs import parse_exposition

    got = {"first": None, "last": None, "n": 0}

    def loop():
        while proc.poll() is None:
            try:
                with urllib.request.urlopen(url, timeout=2) as r:
                    types, samples = parse_exposition(r.read().decode())
            except OSError:
                time.sleep(0.25)
                continue
            vals = {(n, tuple(sorted(lab.items()))): v for n, lab, v in samples}
            snap = {"types": types, "values": vals, "t": time.perf_counter()}
            got["n"] += 1
            got["last"] = snap
            if got["first"] is None and \
                    vals.get(("train_iterations_total", ()), 0) >= want_iters:
                got["first"] = snap
            time.sleep(0.25)

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    got["thread"] = th
    return got


def run_train_full(torch, card: str, work: Path, a_info: dict) -> None:
    """Phase train-full, on train-ckpt's corpus, tokenizer (a cache hit)
    and uninterrupted run a: (f) run a's command line with
    ``corrupt_params@8`` and a guard that checks every step, rolls back
    after 2 bad steps to a snapshot taken every 3, at most once, plus the
    sidecar, the span trace, the profiler window, the watchdog and a
    heartbeat: one rollback to iteration 6, the final state byte-equal to
    a's, a live /metrics scrape, the traces, lambda rows; (g) run a's
    command line with ``nan@3`` and ``train_hang@8`` under a 10 s step
    deadline: exit 113, the hang report, one skipped step, a step-6
    checkpoint that resumes."""
    import socket

    import numpy as np

    from differential_transformer_replication_tpu_torch.obs.introspect import (
        effective_diff_lambda,
    )
    from differential_transformer_replication_tpu_torch.train.checkpoint import (
        load_params_for_inference,
        read_meta,
        resolve_resume_auto,
    )
    from differential_transformer_replication_tpu_torch.train.optim import leaves
    from differential_transformer_replication_tpu_torch.train.ckpt_writer import (
        step_dir_name,
    )
    from differential_transformer_replication_tpu_torch.train.watchdog import (
        HANG_EXIT_CODE,
    )
    from differential_transformer_replication_tpu_torch.train.__main__ import (
        build_parser,
        config_from_args,
    )

    N, L, tools = CKPT_N, CKPT_LAYERS, Path(__file__).resolve().parent / "tools"
    a, tok_dir = work / "a", work / "tok"
    ra = step_records(a / "metrics.jsonl")
    la = {r["iter"]: r["loss"] for r in ra}
    counts_a = json.loads((work / "a.json").read_text())
    med_a = statistics.median(r["step_time_ms"] for r in ra if r["iter"] > 1)

    # (f) rollback and observability
    f = work / "f"
    f.mkdir()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = ckpt_argv(tok_dir, f, "--faults", "corrupt_params@8",
                     "--anomaly-check-interval", "1", "--anomaly-rollback-after", "2",
                     "--anomaly-snapshot-interval", "3", "--anomaly-max-rollbacks", "1",
                     "--metrics-port", str(port), "--trace-path", str(f / "trace.json"),
                     "--profile-dir", str(f / "profile"), "--step-deadline-s", "60",
                     "--heartbeat-dir", str(f / "hb"))
    # (g) runs beside (f) on the card (its output drained on a thread):
    # the layer's own cost is train/obs_bench.py's, A B B A in one process
    g = work / "g"
    g.mkdir()
    argv_g = ckpt_argv(tok_dir, g, "--faults", f"nan@3,train_hang@{FULL_HANG_AT}",
                       "--step-deadline-s", str(FULL_DEADLINE_S))
    t0 = time.perf_counter()
    proc = start_worker("train", argv, work / "f.json")
    proc_g = start_worker("train", argv_g, work / "g.json",
                          env={"DTX_TRAIN_HANG_S": "120"})
    done_g = {}

    def finish_g():
        try:
            finish_worker(proc_g, "train-full (g)", rc=HANG_EXIT_CODE)
        except BaseException as e:  # noqa: BLE001 - raised on the main thread
            done_g["error"] = e
        done_g["wall"] = time.perf_counter() - t0

    thread_g = threading.Thread(target=finish_g, daemon=True)
    thread_g.start()
    scrape = scrape_while_running(proc, f"http://127.0.0.1:{port}/metrics", 11)
    try:
        out_f = finish_worker(proc, "train-full (f)")
    finally:
        thread_g.join(CKPT_TIMEOUT_S)
    wall_f = time.perf_counter() - t0
    scrape["thread"].join(5)
    counts_f = json.loads((work / "f.json").read_text())
    rolls = re.findall(r"\[anomaly\] (\d+) consecutive bad steps at iter (\d+): "
                       r"rolling back to iter (\d+)", out_f)
    expect(rolls == [("2", "10", "6")], f"train-full (f): rollbacks {rolls}, expected "
           "one, at iter 10 to iter 6")
    rf = step_records(f / "metrics.jsonl")
    last_f = {r["iter"]: r for r in rf}
    expect([r["iter"] for r in rf] == [*range(1, 10), *range(7, 2 * N + 1)],
           f"train-full (f): step records {[r['iter'] for r in rf]}")
    unequal = [(i, last_f[i]["loss"], la[i]) for i in la if last_f[i]["loss"] != la[i]]
    same = state_bytes(f / "best.last.ckpt") == state_bytes(a / "best.last.ckpt")
    expect(not unequal and same, f"train-full (f): not bit-equal to run a: losses "
           f"{unequal}, state.msgpack {'equal' if same else 'DIFFERENT'}")
    expect([r["rollbacks"] for r in rf] == [0] * 9 + [1] * 6
           and [r["skipped_steps"] for r in rf] == [0] * 8 + [1] + [0] * 6,
           f"train-full (f): rollbacks {[r['rollbacks'] for r in rf]}, skipped "
           f"{[r['skipped_steps'] for r in rf]}")
    # 9 + 1 rolled back + 6 replayed steps launched their backward kernels
    expect_train_launches(counts_f, 2 * N + 4, "train-full (f)")
    # the live scrape
    first, last = scrape["first"], scrape["last"]
    expect(first is not None, f"train-full (f): no scrape past 11 iterations "
           f"({scrape['n']} scrapes)")
    missing = [n for n in TRAIN_FAMILIES if n not in first["types"]]
    expect(not missing, f"train-full (f): /metrics lacks {missing}")
    v = first["values"]
    iters = v[("train_iterations_total", ())]
    expect(11 <= iters <= len(rf)
           and v[("train_anomaly_events_total", (("kind", "rollback"),))] == 1
           and v[("train_anomaly_events_total", (("kind", "skip"),))] == 1
           and v[("train_watchdog_fires_total", ())] == 0,
           f"train-full (f): scraped counters {v}")
    expect(last["values"][("train_iterations_total", ())] <= len(rf),
           "train-full (f): the last scrape counts more iterations than records")
    # the span trace
    events = json.loads((f / "trace.json").read_text())
    spans = {e["name"] for e in events if e.get("ph") == "X"}
    expect({"data_wait", "dispatch", "eval", "ckpt_snapshot", "block"} <= spans,
           f"train-full (f): span names {spans}")
    # the introspection rows against the plain lambdas of the final state
    intro = [r for r in map(json.loads, (f / "metrics.jsonl").read_text().splitlines())
             if r.get("record") == "introspection"]
    expect([r["iter"] for r in intro] == [N, 2 * N]
           and all(f"lambda_l{k}" in intro[-1] for k in range(1, L + 1)),
           f"train-full (f): introspection rows {[r['iter'] for r in intro]}")
    params, _, meta = load_params_for_inference(str(f / "best.last.ckpt"), device="cpu")
    state_mib = 3 * sum(t.numel() * 4 for t in leaves(params)) / 2 ** 20  # fp32 p, mu, nu
    lam = [float(effective_diff_lambda(blk["attn"], k))
           for k, blk in enumerate(params["blocks"], 1)]
    lam_err = max(abs(intro[-1][f"lambda_l{k}"] - lam[k - 1]) for k in range(1, L + 1))
    expect(meta["iter_num"] == 2 * N and lam_err <= 1e-6,
           f"train-full (f): lambdas {lam} against the row's (max error {lam_err})")
    # the repo's own readers of metrics.jsonl
    rep = subprocess.run([sys.executable, str(tools / "metrics_report.py"),
                          str(a / "metrics.jsonl"), "--check",
                          "--require-loss-decrease"], capture_output=True, text=True)
    expect(rep.returncode == 0, f"train-full: metrics_report --check on run a: "
           f"{rep.stdout[-2000:]} {rep.stderr[-2000:]}")
    rep_f = subprocess.run([sys.executable, str(tools / "metrics_report.py"),
                            str(f / "metrics.jsonl"), "--check",
                            "--require-loss-decrease", "--max-skipped", "1",
                            "--max-rollbacks", "1"], capture_output=True, text=True)
    expect(rep_f.returncode == 1
           and "non-finite loss values in the stream" in rep_f.stdout + rep_f.stderr
           and "did not decrease" not in rep_f.stdout + rep_f.stderr
           and "rollbacks >" not in rep_f.stdout + rep_f.stderr,
           f"train-full (f): metrics_report --check: rc {rep_f.returncode} "
           f"{rep_f.stdout[-2000:]} {rep_f.stderr[-2000:]}")
    summary_f = json.loads(rep_f.stdout.splitlines()[0])
    lam_rep = subprocess.run([sys.executable, str(tools / "lambda_report.py"),
                              str(f / "metrics.jsonl"), "--ascii"],
                             capture_output=True, text=True)
    expect(lam_rep.returncode == 0 and "lambda" in lam_rep.stdout.lower(),
           f"train-full (f): lambda_report: rc {lam_rep.returncode} "
           f"{lam_rep.stdout[-2000:]} {lam_rep.stderr[-2000:]}")
    # the profiler window names the hand-written kernels
    traces = sorted((f / "profile").glob("*.json"))
    exported = re.search(r"Profiler trace written to \S+ \(([\d.]+) MB\) in ([\d.]+) s",
                         out_f)
    expect(len(traces) == 1 and exported is not None,
           f"train-full (f): profiler traces {traces}")
    raw = traces[0].read_bytes()  # ~10^5-10^6 events: searched, not parsed
    n_kernels = len(re.findall(rb'"cat": ?"kernel"', raw))
    absent = [k for k in PROFILED_KERNELS if k.encode() not in raw]
    expect(n_kernels > 0 and not absent, f"train-full (f): the profiler trace "
           f"({n_kernels} kernel events) lacks {absent}")
    del raw
    beats = sorted(x.name for x in (f / "hb").iterdir())
    expect(beats == ["hb-0.json"] and not (f / "best.hang_report.json").exists(),
           f"train-full (f): heartbeat files {beats}, or the watchdog fired")
    # the first pass (iterations 2-9: a guard read every step, a snapshot
    # every 3) and the replay (7-12, inside the profiler window)
    med_f = statistics.median(r["step_time_ms"] for r in rf[1:9])
    med_replay = statistics.median(r["step_time_ms"] for r in rf[9:])
    log(f"[train-full] (f) run a's command line + --faults corrupt_params@8, a guard "
        f"checking every step (rollback after 2, snapshots every 3, at most 1), "
        f"--metrics-port, --trace-path, --profile-dir, --step-deadline-s 60, "
        f"--heartbeat-dir: rollback {rolls[0][1]} -> {rolls[0][2]}; the last record "
        f"of each of the {len(la)} iterations equal to run a's loss and the final "
        f"state.msgpack byte-equal to a's; {scrape['n']} /metrics scrapes while it "
        f"ran, the first past 11 iterations: iterations {iters:.0f}, rollback "
        f"{v[('train_anomaly_events_total', (('kind', 'rollback'),))]:.0f}, skip "
        f"{v[('train_anomaly_events_total', (('kind', 'skip'),))]:.0f}, watchdog "
        f"fires 0, {len(first['types'])} families (the JAX trainer's, less compile "
        f"events); spans {sorted(spans)}; introspection rows at {[r['iter'] for r in intro]}, "
        f"lambda_l1..l{L} {[round(x, 6) for x in lam]} within {lam_err:.2g} of the "
        f"plain CPU lambdas of the final state; metrics_report --check exits 0 on run a, "
        f"and on (f) exits 1 naming only the non-finite loss of the poisoned step "
        f"(skipped {summary_f.get('skipped_steps_total')}, rollbacks "
        f"{summary_f.get('rollbacks_total')}); lambda_report exits 0; profiler trace "
        f"{traces[0].name}, {exported.group(1)} MB written in {exported.group(2)} s, "
        f"{n_kernels} kernel events, {list(PROFILED_KERNELS)} among them; heartbeat "
        f"{beats}, no watchdog fire")
    log(f"[train-full] (f) against run a, with (g) running beside (f) on the card: "
        f"median step_time_ms of iterations 2-9 {med_f:.1f} vs {med_a:.1f} "
        f"({100 * (med_f / med_a - 1):+.1f}%), of the replayed 7-12 under the "
        f"profiler {med_replay:.1f} ({100 * (med_replay / med_a - 1):+.1f}%); peak "
        f"device memory {counts_f['peak_mib']:.0f} vs {counts_a['peak_mib']:.0f} MiB "
        f"(both hold the guard's snapshot of the {state_mib:.0f} MiB train state: the "
        f"default guard takes one at the loop's entry); wall {wall_f:.1f} vs "
        f"{a_info['wall_a']:.1f} s (process start included); {card}")
    log(f"[train-full] (f) step_time_ms by record {[round(r['step_time_ms']) for r in rf]}, "
        f"run a's {[round(r['step_time_ms']) for r in ra]}; gpu_memory MiB at each log "
        f"{[round(r.get('gpu_memory', 0)) for r in rf]}, run a's "
        f"{[round(r.get('gpu_memory', 0)) for r in ra]}")

    # (g) watchdog and poison
    if "error" in done_g:
        raise done_g["error"]
    expect("wall" in done_g, "train-full (g): no end")
    wall_g = done_g["wall"]
    rows = [json.loads(x) for x in (g / "metrics.jsonl").read_text().splitlines()]
    rg = [r for r in rows if "loss" in r and "record" not in r]
    hang_rows = [r for r in rows if r.get("record") == "hang"]
    report = json.loads((g / "best.hang_report.json").read_text())
    expect(len(hang_rows) == 1 and report["iter"] == FULL_HANG_AT
           and hang_rows[0]["iter"] == FULL_HANG_AT
           and "train_stall" in report["threads"]["MainThread"],
           f"train-full (g): hang rows {hang_rows}, report iter {report['iter']}")
    start_8 = [r["ts"] for r in rg if r["iter"] == FULL_HANG_AT]
    fire_after = hang_rows[0]["ts"] - start_8[-1]
    expect([r["iter"] for r in rg] == list(range(1, FULL_HANG_AT + 1))
           and FULL_DEADLINE_S <= fire_after <= FULL_DEADLINE_S + 5,
           f"train-full (g): records {[r['iter'] for r in rg]}, fired "
           f"{fire_after:.1f} s after iteration {FULL_HANG_AT} began")
    expect([r["skipped_steps"] for r in rg] == [0, 0, 0] + [1] * (FULL_HANG_AT - 3)
           and not math.isfinite(rg[3]["loss"]),
           f"train-full (g): skipped {[r['skipped_steps'] for r in rg]}")
    cfg_g = config_from_args(build_parser().parse_args(argv_g))
    resolved, skipped = resolve_resume_auto(cfg_g)
    expect(resolved is not None and Path(resolved).name == step_dir_name(N)
           and read_meta(resolved)["iter_num"] == N,
           f"train-full (g): resume auto picks {resolved} (skipped {skipped})")
    log(f"[train-full] (g) run a's command line + --faults nan@3,train_hang@"
        f"{FULL_HANG_AT} --step-deadline-s {FULL_DEADLINE_S} (DTX_TRAIN_HANG_S 120), "
        f"beside (f): exit {proc_g.returncode} {fire_after:.1f} s after iteration {FULL_HANG_AT} "
        f"began; hang report iter {report['iter']}, the main thread in train_stall, "
        f"keys {sorted(report)}; one hang row; skipped_steps "
        f"{[r['skipped_steps'] for r in rg]} (iteration 3's NaN skipped); resume auto "
        f"picks and verifies {Path(resolved).name}; wall {wall_g:.1f} s (process "
        f"start included); {card}")


def main() -> int:
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--ring-worker":
        return ring_worker(json.loads(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--cli-worker":
        return cli_worker(json.loads(sys.argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs one "
              "GPU", file=sys.stderr)
        return 2
    try:
        from differential_transformer_replication_tpu_torch.ops import (
            _kernels,
            decode_attention as dat,
            flash,
            fused_ffn as ffn,
            fused_norm_residual as fnr,
        )
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable here ({e}); "
              "run from the root of a checkout", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t_all = t0 = time.perf_counter()
    paths = _kernels.build()
    log(f"[build] nvcc sm_90a: {', '.join(p.name for p in paths.values())} "
        f"in {time.perf_counter() - t0:.1f} s")
    # kernels D and E, K1-K4, the decode attention's split kernel and the
    # SwiGLU kernels in bf16 (the tensor-core instances, "_mma" and
    # "wgmma"; bf16 and int8 K/V for the decode; the SwiGLU's wgmma tiles
    # and skinny instance):
    # their registers per thread, and no local-memory spill (ptxas -v)
    for lib in ("flash_tm", "flash_bh_fwd", "flash_bh_bwd_dq", "flash_bh_bwd_dkv",
                "flash_bh_bwd_fused", "decode_attention", "fused_swiglu"):
        usage = {k: v for k, v in _kernels.ptxas_usage(lib).items()
                 if "_mma" in k or "wgmma" in k}
        for fn, (regs, spill) in sorted(usage.items()):
            m = re.search(r"((?:tm|bh)_(?:fwd|bwd_dq|bwd_dkv|bwd_fused_dkv|bwd_fused_dk|"
                          r"bwd_dk|bwd_dv)_mma|dattn_split_mma)I(\w*?)EEv", fn) or \
                re.search(r"\d(swiglu_[a-z_]+?mma)(?:I(\w+?)E)?E", fn)
            log(f"[build] ptxas {m.group(1) if m else fn} <{(m.group(2) or '') if m else ''}>: "
                f"{regs} registers, {spill} bytes spilled")
        spilled = [fn for fn, (_, spill) in usage.items() if spill]
        if not usage or spilled:
            raise Failure(f"{lib} bf16 kernels spill to local memory: {spilled}"
                          if usage else f"no ptxas report for {lib}")
    # the add+norm backward: every instance (warp: dtype, chunks of 8 a
    # lane, with the carry cotangent; block: dtype, carry) and the finish
    usage = {}
    for fn, ru in _kernels.ptxas_usage("fused_norm_residual").items():
        m = re.search(r"addnorm_bwd_(warp|block|finish)(?:I(13__nv_bfloat16|f)(?:Li(\d)E)?"
                      r"Lb(\d)E)?", fn)
        if m:
            kind, dt, c, gx = m.groups()
            usage[kind + ("" if dt is None else f"<{'bf16' if dt != 'f' else 'fp32'}"
                          + (f", C={c}" if c else "") + f", carry={gx}>")] = ru
    for fn, (regs, spill) in sorted(usage.items()):
        log(f"[build] ptxas addnorm_bwd_{fn}: {regs} registers, {spill} bytes spilled")
    spilled = [fn for fn, (_, spill) in usage.items() if spill]
    if len(usage) != 21 or spilled:
        raise Failure(f"fused_norm_residual: {len(usage)} add+norm kernels in the ptxas "
                      f"report (21 expected), spilled: {spilled}")
    t0 = time.perf_counter()
    x = torch.zeros(8, 768, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(768, device="cuda")
    fnr.fused_add_norm(x, x, w, w)
    fnr.fused_norm(x, w, w)
    torch.cuda.synchronize()
    log(f"[build] triton JIT of the add+norm forward (both variants): "
        f"{time.perf_counter() - t0:.1f} s")

    phases = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t
        log(f"[{name}] phase took {phases[name]:.1f} s")
        return out

    entries = phase("kernels", lambda: {**run_kernels(torch, (fnr, ffn, dat)),
                                        **run_decode_kernels(torch, dat)})
    entries.update(phase("kernels-train", run_train_kernels, torch,
                         (fnr, ffn, flash)))
    entries.update(phase("kernels-hm", run_bh_kernels, torch, flash))
    entries.update(phase("kernels-ring", run_ring_kernels, torch, flash))
    serve_counts = phase("serve", run_serve, torch, card)
    serve_counts.update(phase("serve-paged", run_serve_paged, torch, card))
    phase("serve-tier", run_serve_tier, torch, card)
    phase("serve-requests", run_serve_requests, torch, card)
    phase("serve-fleet", run_serve_fleet, torch, card)
    phase("e2e", run_e2e, torch)
    train_counts = phase("train", run_train, torch, card)
    hm_counts = phase("train-hm", run_train_hm, torch, card,
                      Path(__file__).resolve().parent / "build" / "chip_smoke"
                      / "tokens.npy")
    # the train-ring launches run beside train-e2e, train-ckpt and
    # train-full (ranks and CLI workers in processes of their own); their
    # runs that time the card alone wait for those phases to end
    ring = phase("train-ring-start", start_train_ring, torch,
                 Path(__file__).resolve().parent / "build" / "chip_smoke" / "tokens.npy")
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="train_ckpt_",
                                 dir=Path(__file__).resolve().parent / "build"))
    ring_counts = None
    try:
        phase("train-e2e", run_train_e2e, torch)
        a_info = phase("train-ckpt", run_train_ckpt, torch, card, work)
        phase("train-full", run_train_full, torch, card, work, a_info)
        ring_counts = phase("train-ring", finish_train_ring, torch, card, ring)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if ring_counts is None:
            stop_train_ring(ring)
    for best in (SMOKE_BEST, ring_best(2), ring_best(4)):
        shutil.rmtree(best, ignore_errors=True)
    log(f"[done] phases {', '.join(f'{k} {v:.1f} s' for k, v in phases.items())}; "
        f"total {time.perf_counter() - t_all:.1f} s")

    for name, ent in entries.items():
        # serving kernels: launches over the served run; training
        # kernels: over the diff recipe's trainer run;
        # head-major kernels: over the train-hm runs, by route; the ring
        # chunk modes: over the train-ring runs' ranks, by route (an
        # entry at the control width: its kernel's route)
        if name in ring_counts:
            ent["launches"] = ring_counts[name]
        elif name in hm_counts:
            ent["launches"] = hm_counts[name]
        elif name in ("flash_tm_fwd", "flash_tm_bwd", "swiglu_bwd"):
            ent["launches"] = train_counts[name]
        elif name == "add_norm_bwd":
            ent["launches"] = train_counts["add_norm_bwd_carry"]
        elif name == "add_norm_bwd_nocarry":
            ent["launches"] = train_counts["add_norm_bwd"] - train_counts["add_norm_bwd_carry"]
        elif name == "fused_swiglu_train":
            ent["launches"] = train_counts["fused_swiglu"]
        else:
            ent["launches"] = serve_counts.get(name, 0)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: ent[k] for k in order}
                                  for ent in entries.values()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
