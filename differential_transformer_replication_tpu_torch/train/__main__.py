"""Command line of the port's trainer:

    python -m differential_transformer_replication_tpu_torch.train \\
        --model diff --dataset synthetic --num-train-samples 20000 \\
        --tokenizer-dir tokenizer --device cuda

builds its data as the JAX package's ``train.py`` does: the corpus
(``tinystories`` where it loads, else ``synthetic``; or a text file),
a byte-level BPE trained on it, the encoded stream, cached together
under ``<tokenizer-dir>/cache-<key>/``. It takes the flags of
``train.py`` that the port runs, under the same names, plus
``--tokens`` (an encoded ``.npy`` token stream to train on instead,
with no tokenizer), ``--sampler``, ``--device`` and ``--dist-backend``.
Every other ``train.py`` flag is refused with the ROADMAP item that
brings it.

Checkpoints and resume, as ``train.py`` takes them:

    python -m differential_transformer_replication_tpu_torch.train ... \
        --checkpoint-path run/best.ckpt --ckpt-interval 500 --resume-from auto

writes the best state at each improving eval, a certified
``run/best.steps/step-NNNNNNNN`` every 500 steps and ``run/best.last.ckpt``
on every exit; run again, ``--resume-from auto`` continues from the
newest checkpoint that verifies.

Data parallelism, FSDP, tensor parallelism, sequence parallelism (the
ring, or Ulysses' all-to-alls) and pipeline parallelism (GPipe stages)
run under torchrun on a mesh of data x fsdp x tensor x sequence x
pipeline ranks, with the backend named:

    torchrun --nproc-per-node 2 -m differential_transformer_replication_tpu_torch.train \
        --data-parallel 2 --dist-backend gloo ...
    torchrun --nproc-per-node 4 -m differential_transformer_replication_tpu_torch.train \
        --tensor-parallel 2 --sequence-parallel 2 --dist-backend gloo ...
    torchrun --nproc-per-node 4 -m differential_transformer_replication_tpu_torch.train \
        --data-parallel 2 --sequence-parallel 2 --sequence-impl ulysses \
        --dist-backend gloo ...
    torchrun --nproc-per-node 2 -m differential_transformer_replication_tpu_torch.train \
        --pipeline-parallel 2 --grad-acc-steps 4 --dist-backend gloo ...

``nccl`` needs one card per rank; ``gloo`` lets the ranks share one
card (the exchanges then go through host memory) or run on the CPU
(``--device cpu``). ``--micro-batch-size`` must split into data x fsdp
equal shards and ``--block-size`` into ``--sequence-parallel`` equal
ones; ``--tensor-parallel`` must split the heads, the vocab and the
SwiGLU width (and diff's ``--block-size``); under Ulysses each tensor
rank's heads must split over the sequence ranks; ``--n-layer`` must split
into ``--pipeline-parallel`` stages, whose microbatch stream is
``--grad-acc-steps`` (at least P of them, or the bubble dominates). A
pure data mesh syncs its gradients bucket by bucket in the backward
(``--dp-bucket-layers`` blocks a bucket) unless ``--no-dp-overlap``.

Resilience and observability, as ``train.py`` takes them:

    python -m differential_transformer_replication_tpu_torch.train ... \
        --step-deadline-s 300 --heartbeat-dir run/hb --metrics-port 9310 \
        --trace-path run/train.trace.json --profile-dir run/profile

arms the step watchdog (a hung iteration writes
``<checkpoint stem>.hang_report.json`` and exits 113, which
``tools/train_supervisor.py`` restarts as a hang), publishes heartbeats,
serves the Prometheus registry at ``:9310/metrics``, writes the host span
trace and a 5-step ``torch.profiler`` trace; ``--faults`` (or
``DTX_FAULTS``) injects the chaos plans of ``utils/faults.py``. The guard
rolls back to an in-memory snapshot after ``--anomaly-rollback-after``
bad steps and aborts past ``--anomaly-max-rollbacks``.

Memory for compute, as ``train.py`` takes them:

    python -m differential_transformer_replication_tpu_torch.train ... \
        --block-size 8192 --micro-batch-size 2 --remat --remat-policy nothing \
        --loss-chunk 2048

recomputes each block's activations in the backward from its saved
inputs, and computes the loss 2048 positions of logits at a time.
"""

from __future__ import annotations

import argparse
import sys

from differential_transformer_replication_tpu_torch.config import (
    REMAT_POLICIES,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)

# train.py flags that wait for a later slice -> the ROADMAP item
LATER_FLAGS = {
    "--attention-impl": "none: the port dispatches kernels by device",
    "--ffn-impl": "none: the port dispatches kernels by device",
    "--profile-every": "the continuous device profile (ROADMAP Queue A: "
                       "tooling and analysis, item 10)",
    "--profile-spool-dir": "the continuous device profile (ROADMAP Queue A: "
                           "tooling and analysis, item 10)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m differential_transformer_replication_tpu_torch.train",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    m, t = ModelConfig(), TrainConfig()
    p.add_argument("--model", choices=("control", "diff", "ndiff"), default=m.model)
    p.add_argument("--n-embd", type=int, default=m.n_embd)
    p.add_argument("--n-head", type=int, default=m.n_head)
    p.add_argument("--n-layer", type=int, default=m.n_layer)
    p.add_argument("--block-size", type=int, default=m.block_size)
    p.add_argument("--dropout", type=float, default=m.dropout)
    p.add_argument("--n-terms", type=int, default=m.n_terms)
    p.add_argument("--compute-dtype", default=m.compute_dtype,
                   choices=("float32", "bfloat16"))
    p.add_argument("--loss-chunk", type=int, default=None,
                   help="fused chunked lm-head loss: positions per chunk "
                        "(never materializes full logits; for long context)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize blocks on backward (less activation memory)")
    p.add_argument("--remat-policy", default=m.remat_policy,
                   choices=REMAT_POLICIES,
                   help="what each block's checkpoint may save under --remat "
                        "(models/common.py:remat_block)")
    p.add_argument("--vocab-size", type=int, default=t.vocab_size)
    p.add_argument("--dataset", default=t.dataset,
                   help="tinystories | synthetic | path/to/corpus.txt")
    p.add_argument("--num-train-samples", type=int, default=t.num_train_samples)
    p.add_argument("--tokenizer-dir", default=t.tokenizer_dir,
                   help="tokenizer artifacts + token-stream cache dir")
    p.add_argument("--micro-batch-size", type=int, default=t.micro_batch_size)
    p.add_argument("--grad-acc-steps", type=int, default=t.grad_acc_steps)
    p.add_argument("--max-iters", type=int, default=t.max_iters)
    p.add_argument("--eval-interval", type=int, default=t.eval_interval)
    p.add_argument("--eval-iters", type=int, default=t.eval_iters)
    p.add_argument("--learning-rate", type=float, default=t.learning_rate)
    p.add_argument("--min-lr", type=float, default=t.min_lr)
    p.add_argument("--weight-decay", type=float, default=t.weight_decay)
    p.add_argument("--warmup-iters", type=int, default=t.warmup_iters)
    p.add_argument("--seed", type=int, default=t.seed)
    p.add_argument("--metrics-path", default=t.metrics_path)
    p.add_argument("--checkpoint-path", default=t.checkpoint_path)
    p.add_argument("--last-checkpoint-path", default=t.last_checkpoint_path,
                   help="resumable last-state checkpoint written on any "
                        "exit (SIGTERM/Ctrl-C/crash/completion); '' disables")
    p.add_argument("--resume-from", default=None,
                   help="checkpoint dir to resume from, or 'auto' to "
                        "pick the newest checkpoint that passes "
                        "integrity verification (step tree, then "
                        "last/best), falling back to older ones; with "
                        "no verified checkpoint, starts fresh")
    p.add_argument("--ckpt-interval", type=int, default=t.ckpt_interval,
                   help="iterations between rotating step-NNNNNNNN "
                        "checkpoints, each certified by a SHA-256 "
                        "manifest (train/ckpt_writer.py); 0 = off")
    p.add_argument("--ckpt-dir", default=t.ckpt_dir,
                   help="root of the step-checkpoint tree ('auto' = "
                        "<checkpoint-path stem>.steps)")
    p.add_argument("--ckpt-async", action=argparse.BooleanOptionalAction,
                   default=t.ckpt_async,
                   help="write step checkpoints from a background "
                        "thread (the loop blocks only for the "
                        "device->host snapshot); --no-ckpt-async "
                        "writes inline")
    p.add_argument("--ckpt-keep-last", type=int, default=t.ckpt_keep_last,
                   help="retention: newest N verified step checkpoints "
                        "to keep")
    p.add_argument("--ckpt-keep-every", type=int, default=t.ckpt_keep_every,
                   help="retention: additionally keep every Nth-step "
                        "checkpoint forever (0 = none)")
    p.add_argument("--checkpoint-min-interval-s", type=float,
                   default=t.checkpoint_min_interval_s,
                   help="throttle best-checkpoint disk writes to at most "
                        "one per this many seconds (0 = write every "
                        "improvement; the best state is still copied on "
                        "the device each improvement and written at exit)")
    p.add_argument("--allow-inexact-resume", action="store_true",
                   help="accept an elastic resume whose epoch-sampler "
                        "position cannot be reproduced exactly under "
                        "the new batch math (mid-accumulation boundary "
                        "or legacy checkpoint) instead of raising "
                        "ElasticResumeError")
    p.add_argument("--anomaly-guard", action=argparse.BooleanOptionalAction,
                   default=t.anomaly_guard)
    p.add_argument("--anomaly-spike-factor", type=float,
                   default=t.anomaly_spike_factor)
    p.add_argument("--anomaly-warmup-steps", type=int,
                   default=t.anomaly_warmup_steps)
    p.add_argument("--anomaly-rollback-after", type=int,
                   default=t.anomaly_rollback_after,
                   help="consecutive bad steps before rolling back to the "
                        "good-state snapshot")
    p.add_argument("--anomaly-max-rollbacks", type=int,
                   default=t.anomaly_max_rollbacks,
                   help="rollbacks before the run aborts")
    p.add_argument("--anomaly-snapshot-interval", type=int,
                   default=t.anomaly_snapshot_interval,
                   help="iterations between good-state snapshots (pins one "
                        "extra train state in device memory)")
    p.add_argument("--anomaly-check-interval", type=int,
                   default=t.anomaly_check_interval,
                   help="iterations between reads of the guard's bad streak")
    p.add_argument("--step-deadline-s", type=float, default=t.step_deadline_s,
                   help="step-deadline watchdog (train/watchdog.py): a "
                        "training iteration hung past this many seconds "
                        "dumps the hang report and exits 113, the code "
                        "tools/train_supervisor.py restarts as a hang; 0 = off")
    p.add_argument("--hang-report-path", default=t.hang_report_path,
                   help="watchdog post-mortem destination ('auto' = "
                        "<checkpoint-path stem>.hang_report.json)")
    p.add_argument("--heartbeat-dir", default=t.heartbeat_dir,
                   help="liveness mesh (parallel/heartbeat.py): directory of "
                        "per-process heartbeat files; a peer silent past "
                        "--heartbeat-timeout-s trips the watchdog at once "
                        "(coordinated abort); unset = off")
    p.add_argument("--heartbeat-interval-s", type=float,
                   default=t.heartbeat_interval_s,
                   help="seconds between heartbeat publications")
    p.add_argument("--heartbeat-timeout-s", type=float,
                   default=t.heartbeat_timeout_s,
                   help="peer silence past this = dead (coordinated abort); "
                        "must exceed the interval")
    p.add_argument("--faults", default=None,
                   help="fault-injection spec for chaos testing, e.g. "
                        "'sigkill@120,nan@50-52' (utils/faults.py; also via "
                        "the DTX_FAULTS variable)")
    p.add_argument("--metrics-port", type=int, default=t.metrics_port,
                   help="serve the trainer's Prometheus registry at "
                        "http://0.0.0.0:PORT/metrics from a sidecar thread "
                        "(obs/http.py); 0 = off")
    p.add_argument("--trace-path", default=t.trace_path,
                   help="write a Chrome trace-event JSON of the train loop's "
                        "host spans (data_wait/dispatch/block/eval/"
                        "ckpt_snapshot; open in Perfetto) to this path")
    p.add_argument("--wandb", action="store_true", help="enable the wandb sink")
    p.add_argument("--profile-dir", default=t.profile_dir,
                   help="capture a 5-step torch.profiler trace (CPU and CUDA "
                        "activity, starting 10 iterations after this run "
                        "begins or resumes) into this directory")
    # the port's own
    p.add_argument("--tokens", default=None,
                   help="an encoded token stream (.npy, 1-D integer ids below "
                        "--vocab-size) to train on instead of --dataset; no "
                        "tokenizer, so checkpoints record no fingerprint")
    p.add_argument("--sampler", choices=("epoch", "replacement"),
                   default=t.sampler,
                   help="'epoch': every window once per epoch in a seeded "
                        "permutation (the JAX order); 'replacement': "
                        "uniform draws")
    p.add_argument("--log-interval", type=int, default=t.log_interval)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--sequence-impl", choices=("ring", "ulysses"),
                   default=m.sequence_impl,
                   help="sequence-parallel strategy when --sequence-parallel "
                        "> 1: K/V ring rotation or all-to-all re-sharding")
    p.add_argument("--no-dp-overlap", action="store_true",
                   help="disable the bucketed backward-overlapped DP "
                        "gradient all-reduce (parallel/dp_step.py)")
    p.add_argument("--dp-bucket-layers", type=int, default=t.dp_bucket_layers,
                   help="transformer blocks per overlapped gradient "
                        "all-reduce bucket (parallel/dp_step.py)")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="devices on the data mesh axis")
    p.add_argument("--fsdp", type=int, default=1,
                   help="devices on the fsdp (param-sharding) mesh axis")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="devices on the tensor mesh axis (Megatron: heads, "
                   "the SwiGLU width and the vocab sharded)")
    p.add_argument("--sequence-parallel", type=int, default=1,
                   help="devices on the sequence mesh axis (ring attention)")
    p.add_argument("--pipeline-parallel", type=int, default=1,
                   help="devices on the pipeline mesh axis (GPipe stages of "
                   "n_layer / P consecutive layers; --grad-acc-steps is the "
                   "microbatch stream)")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default="nccl",
                   help="the mesh's backend: nccl (one card per rank, the "
                   "default) or gloo (ranks may share a card, or the CPU)")
    return p


def refused_flags(argv) -> list:
    return [a.split("=")[0] for a in argv if a.split("=")[0] in LATER_FLAGS]


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    model = ModelConfig(
        model=args.model, vocab_size=args.vocab_size, n_embd=args.n_embd,
        n_head=args.n_head, n_layer=args.n_layer, block_size=args.block_size,
        dropout=args.dropout, n_terms=args.n_terms,
        compute_dtype=args.compute_dtype, sequence_impl=args.sequence_impl,
        remat=args.remat, remat_policy=args.remat_policy,
        loss_chunk=args.loss_chunk,
    )
    return TrainConfig(
        model=model,
        mesh=MeshConfig(data=args.data_parallel, fsdp=args.fsdp,
                        tensor=args.tensor_parallel,
                        sequence=args.sequence_parallel,
                        pipeline=args.pipeline_parallel),
        dp_overlap=not args.no_dp_overlap,
        dp_bucket_layers=args.dp_bucket_layers,
        vocab_size=args.vocab_size, dataset=args.dataset,
        num_train_samples=args.num_train_samples,
        tokenizer_dir=args.tokenizer_dir,
        micro_batch_size=args.micro_batch_size,
        grad_acc_steps=args.grad_acc_steps, max_iters=args.max_iters,
        eval_interval=args.eval_interval, eval_iters=args.eval_iters,
        learning_rate=args.learning_rate, min_lr=args.min_lr,
        weight_decay=args.weight_decay, warmup_iters=args.warmup_iters,
        seed=args.seed, metrics_path=args.metrics_path or None,
        anomaly_guard=args.anomaly_guard,
        anomaly_spike_factor=args.anomaly_spike_factor,
        anomaly_warmup_steps=args.anomaly_warmup_steps,
        sampler=args.sampler, log_interval=args.log_interval,
        checkpoint_path=args.checkpoint_path,
        last_checkpoint_path=args.last_checkpoint_path or None,
        resume_from=args.resume_from,
        checkpoint_min_interval_s=args.checkpoint_min_interval_s,
        ckpt_interval=args.ckpt_interval, ckpt_dir=args.ckpt_dir,
        ckpt_async=args.ckpt_async, ckpt_keep_last=args.ckpt_keep_last,
        ckpt_keep_every=args.ckpt_keep_every,
        allow_inexact_resume=args.allow_inexact_resume,
        anomaly_rollback_after=args.anomaly_rollback_after,
        anomaly_max_rollbacks=args.anomaly_max_rollbacks,
        anomaly_snapshot_interval=args.anomaly_snapshot_interval,
        anomaly_check_interval=args.anomaly_check_interval,
        step_deadline_s=args.step_deadline_s,
        hang_report_path=args.hang_report_path,
        heartbeat_dir=args.heartbeat_dir,
        heartbeat_interval_s=args.heartbeat_interval_s,
        heartbeat_timeout_s=args.heartbeat_timeout_s,
        faults=args.faults,
        metrics_port=args.metrics_port,
        trace_path=args.trace_path,
        use_wandb=args.wandb,
        profile_dir=args.profile_dir,
    )


def run(argv) -> tuple:
    """Parse ``argv`` as the command line does and train: (final train
    state, per-step metrics)."""
    parser = build_parser()
    bad = refused_flags(argv)
    if bad:
        parser.error("; ".join(f"{f} is not run by the port yet: "
                               f"{LATER_FLAGS[f]}" for f in bad))
    args = parser.parse_args(argv)
    from differential_transformer_replication_tpu_torch.train.trainer import train

    cfg = config_from_args(args)
    return train(cfg, args.tokens, device=args.device,
                 dist_backend=args.dist_backend if cfg.mesh.n_devices > 1 else None)


def main(argv=None) -> int:
    run(sys.argv[1:] if argv is None else list(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
