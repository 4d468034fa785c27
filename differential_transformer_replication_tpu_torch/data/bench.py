"""Host costs of the port's data path at one corpus size:

    python -m differential_transformer_replication_tpu_torch.data.bench \
        --docs 1000000 --dir build/data_bench

builds the cache entry of the default ``TrainConfig``'s corpus as the
trainer does (``train/trainer.py:corpus_tokens``: the corpus, the
byte-level BPE, the encoded stream, the entry written), then loads it as
a later run does (a cache hit), and prints one JSON line: the seconds of
each part, read from the ``[data]`` lines that ``corpus_tokens`` prints,
the encoder's tokens/s, the process's peak resident memory after the
imports, the miss and the hit, and the card's name and power limit where
``nvidia-smi`` answers. ``--dir`` is emptied before and removed after.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import resource
import shutil
import subprocess
import sys

MISS = re.compile(r"\[data\] cache miss: .*? in ([\d.]+) s; BPE trained in ([\d.]+) s; "
                  r"(\d+) tokens encoded in ([\d.]+) s \((\d+) tokens/s\); entry "
                  r"written in ([\d.]+) s")
HIT = re.compile(r"\[data\] cache hit: tokenizer and stream loaded in ([\d.]+) s")


def peak_rss_mb() -> int:
    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip() or "no card"
    except (OSError, subprocess.SubprocessError):
        return "no card"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--docs", type=int, default=1_000_000)
    p.add_argument("--dir", default=os.path.join("build", "data_bench"))
    args = p.parse_args(argv)

    from differential_transformer_replication_tpu_torch.config import TrainConfig
    from differential_transformer_replication_tpu_torch.train.trainer import (
        corpus_tokens,
    )

    cfg = TrainConfig(dataset="synthetic", num_train_samples=args.docs,
                      tokenizer_dir=args.dir)
    shutil.rmtree(args.dir, ignore_errors=True)
    rss_imports = peak_rss_mb()
    lines = []

    def say(msg: str) -> None:
        lines.append(msg)
        print(msg, file=sys.stderr)

    try:
        tok, tokens = corpus_tokens(cfg, say)
        rss_miss = peak_rss_mb()
        _, again = corpus_tokens(cfg, say)
        text = "\n".join(lines)
        miss, hit = MISS.search(text), HIT.search(text)
        if miss is None or hit is None or len(again) != len(tokens):
            raise SystemExit("the first build did not miss or the second did not hit")
        corpus_s, bpe_s, encode_s, write_s = (float(miss.group(i)) for i in (1, 2, 4, 6))
        print(json.dumps({
            "docs": args.docs, "dataset": cfg.dataset, "tokens": int(len(tokens)),
            "vocab": tok.get_vocab_size(), "corpus_s": corpus_s, "bpe_train_s": bpe_s,
            "encode_s": encode_s, "encode_tokens_per_s": int(miss.group(5)),
            "cache_write_s": write_s,
            "miss_total_s": round(corpus_s + bpe_s + encode_s + write_s, 3),
            "hit_load_s": float(hit.group(1)),
            "peak_rss_mb": {"imports": rss_imports, "miss": rss_miss,
                            "hit": peak_rss_mb()},
            "card": card()}))
    finally:
        shutil.rmtree(args.dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
