"""What the trainer's resilience and observability layer costs on the card.

    python -m differential_transformer_replication_tpu_torch.train.obs_bench [--pairs 1]

Trains chip_smoke.py's train-ckpt run (the diff recipe: 8 layers, width
768, T 512, bf16 compute; 200 synthetic documents through the BPE, the
epoch sampler, micro-batch 8 x 48 grad-acc steps, 12 steps, an eval and
an async step checkpoint every 6) through the trainer's command line,
in this process, in turns, each run from the same seed:

- ``plain``: none of the layer's flags (the guard at its defaults);
- ``full``: the guard read every step with a snapshot every 3
  (``--anomaly-check-interval 1 --anomaly-snapshot-interval 3``), the
  Prometheus sidecar scraped 4 times a second, the span trace, the step
  watchdog (60 s) and a heartbeat;
- ``profiled``: ``full`` and the 5-step ``torch.profiler`` window
  (``--profile-dir``; iterations 10-12 fall in it).

The order is plain, full, profiled, profiled, full, plain (``--pairs``
times), so a drift of the host's speed falls on every variant alike.
Prints one JSON line: the card, and for each run its variant, the median
``step_time_ms`` over iterations 2-9 and 10-12, the peak device memory
(MiB, from ``reset_peak_memory_stats``), ``gpu_memory`` at the last log
(MiB allocated), the wall seconds, and for a profiled run the trace's
megabytes and export seconds. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import socket
import statistics
import subprocess
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import torch

from differential_transformer_replication_tpu_torch.train import __main__ as cli

STEPS, EVERY, ACC, MICRO, DOCS = 12, 6, 48, 8, 200
SCRAPE_S = 0.25


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def base_argv(tok_dir: Path, run_dir: Path) -> list:
    """The train-ckpt run's command line (chip_smoke.py:ckpt_argv)."""
    return ["--model", "diff", "--dataset", "synthetic", "--num-train-samples",
            str(DOCS), "--tokenizer-dir", str(tok_dir), "--device", "cuda",
            "--n-embd", "768", "--n-head", "4", "--n-layer", "8",
            "--block-size", "512", "--vocab-size", "12000",
            "--compute-dtype", "bfloat16", "--micro-batch-size", str(MICRO),
            "--grad-acc-steps", str(ACC), "--max-iters", str(STEPS),
            "--eval-interval", str(EVERY), "--eval-iters", "2",
            "--log-interval", "1", "--warmup-iters", "2",
            "--learning-rate", "1e-3", "--seed", "0", "--sampler", "epoch",
            "--ckpt-interval", str(EVERY), "--ckpt-async",
            "--checkpoint-path", str(run_dir / "best.ckpt"),
            "--metrics-path", str(run_dir / "metrics.jsonl")]


def run_once(variant: str, tok_dir: Path, run_dir: Path) -> dict:
    run_dir.mkdir(parents=True)
    argv = base_argv(tok_dir, run_dir)
    port = None
    if variant != "plain":
        port = _free_port()
        argv += ["--anomaly-check-interval", "1", "--anomaly-snapshot-interval", "3",
                 "--metrics-port", str(port), "--trace-path",
                 str(run_dir / "trace.json"), "--step-deadline-s", "60",
                 "--heartbeat-dir", str(run_dir / "hb")]
    if variant == "profiled":
        argv += ["--profile-dir", str(run_dir / "profile")]
    done = threading.Event()

    def scrape():  # a Prometheus scraper's load on the sidecar
        while not done.wait(SCRAPE_S):
            with contextlib.suppress(OSError):
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                            timeout=2) as r:
                    r.read()

    scraper = threading.Thread(target=scrape, daemon=True) if port else None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    if scraper:
        scraper.start()
    try:
        with contextlib.redirect_stdout(out):
            cli.run(argv)
    finally:
        done.set()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if scraper:
        scraper.join(5)
    rows = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in rows if "loss" in r and "record" not in r]
    ms = {r["iter"]: r["step_time_ms"] for r in steps}
    rec = {"variant": variant,
           "step_ms_2_9": statistics.median(ms[i] for i in range(2, 10)),
           "step_ms_10_12": statistics.median(ms[i] for i in range(10, STEPS + 1)),
           "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
           "gpu_memory_mib": steps[-1].get("gpu_memory"), "wall_s": wall,
           "last_loss": steps[-1]["loss"]}
    m = re.search(r"Profiler trace written to (\S+) \(([\d.]+) MB\) in ([\d.]+) s",
                  out.getvalue())
    if variant == "profiled":
        if m is None:
            raise RuntimeError(f"no profiler trace:\n{out.getvalue()[-2000:]}")
        rec["trace_mb"], rec["export_s"] = float(m.group(2)), float(m.group(3))
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pairs", type=int, default=1,
                   help="rounds of plain, full, profiled, profiled, full, plain")
    p.add_argument("--dir", default=None, help="work directory (default: a temporary one)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("obs_bench needs a CUDA GPU")
    order = ["plain", "full", "profiled", "profiled", "full", "plain"] * args.pairs
    with tempfile.TemporaryDirectory(dir=args.dir) as d:
        work = Path(d)
        runs = [run_once(v, work / "tok", work / f"run{i}") for i, v in enumerate(order)]
    print(json.dumps({"card": _card(), "steps": STEPS, "grad_acc": ACC,
                      "micro_batch": MICRO, "runs": runs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
