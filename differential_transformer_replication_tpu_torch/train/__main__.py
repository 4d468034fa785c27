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

Sequence parallelism (ring attention over P ranks) runs under torchrun,
with the backend named:

    torchrun --nproc-per-node P -m differential_transformer_replication_tpu_torch.train \
        --sequence-parallel P --dist-backend gloo ...

``nccl`` needs one card per rank; ``gloo`` lets the P ranks share one
card (the ring's K/V exchanges then go through host memory) or run on
the CPU (``--device cpu``). ``--block-size`` must split into P equal
shards.
"""

from __future__ import annotations

import argparse
import sys

from differential_transformer_replication_tpu_torch.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)

# train.py flags that wait for a later slice -> the ROADMAP item
LATER_FLAGS = {
    "--attention-impl": "none: the port dispatches kernels by device",
    "--ffn-impl": "none: the port dispatches kernels by device",
    "--loss-chunk": "the chunked loss (ROADMAP Queue A)",
    "--remat": "remat (ROADMAP Queue A)",
    "--remat-policy": "remat (ROADMAP Queue A)",
    "--no-dp-overlap": "parallelism (ROADMAP Queue A)",
    "--dp-bucket-layers": "parallelism (ROADMAP Queue A)",
    "--anomaly-rollback-after": "the full trainer (ROADMAP Queue A)",
    "--anomaly-max-rollbacks": "the full trainer (ROADMAP Queue A)",
    "--anomaly-snapshot-interval": "the full trainer (ROADMAP Queue A)",
    "--anomaly-check-interval": "the full trainer (ROADMAP Queue A)",
    "--step-deadline-s": "the full trainer (ROADMAP Queue A)",
    "--hang-report-path": "the full trainer (ROADMAP Queue A)",
    "--heartbeat-dir": "the full trainer (ROADMAP Queue A)",
    "--heartbeat-interval-s": "the full trainer (ROADMAP Queue A)",
    "--heartbeat-timeout-s": "the full trainer (ROADMAP Queue A)",
    "--faults": "the full trainer (ROADMAP Queue A)",
    "--metrics-port": "the full trainer (ROADMAP Queue A)",
    "--trace-path": "the full trainer (ROADMAP Queue A)",
    "--wandb": "the full trainer (ROADMAP Queue A)",
    "--profile-dir": "the full trainer (ROADMAP Queue A)",
    "--profile-every": "the full trainer (ROADMAP Queue A)",
    "--profile-spool-dir": "the full trainer (ROADMAP Queue A)",
    "--data-parallel": "parallelism (ROADMAP Queue A)",
    "--tensor-parallel": "parallelism (ROADMAP Queue A)",
    "--fsdp": "parallelism (ROADMAP Queue A)",
    "--pipeline-parallel": "parallelism (ROADMAP Queue A)",
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
    p.add_argument("--sequence-parallel", type=int, default=1,
                   help="ranks of the sequence ring (run under torchrun)")
    p.add_argument("--sequence-impl", choices=("ring", "ulysses"),
                   default=m.sequence_impl,
                   help="'ring' is the one the port runs")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default="nccl",
                   help="the ring's backend: nccl (one card per rank, the "
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
    )
    return TrainConfig(
        model=model, mesh=MeshConfig(sequence=args.sequence_parallel),
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
    if args.sequence_impl != "ring":
        parser.error(f"--sequence-impl {args.sequence_impl} is not run by the "
                     "port yet: Ulysses sequence parallelism (ROADMAP Queue A: "
                     "parallelism); use ring")
    from differential_transformer_replication_tpu_torch.train.trainer import train

    sp = args.sequence_parallel > 1
    return train(config_from_args(args), args.tokens, device=args.device,
                 dist_backend=args.dist_backend if sp else None)


def main(argv=None) -> int:
    run(sys.argv[1:] if argv is None else list(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
