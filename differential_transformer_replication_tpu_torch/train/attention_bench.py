"""Device time of the token-major attention kernels D and E
(``ops/flash.py`` ``flash_tm_fwd`` / ``flash_tm_bwd``, ``csrc/flash_tm.cu``)
at the three recipes' attention shapes (B 32, T 512, bf16), beside
PyTorch's ``scaled_dot_product_attention`` at the control shape.

    python differential_transformer_replication_tpu_torch/train/attention_bench.py \
        [--root DIR] [--tag NAME]

``--root`` names the checkout whose package is timed (default: the one
that holds this file), so that two trees are compared on one card in one
call, in turns (A B B A). Each call of a kernel is captured in a CUDA
graph and replayed (``ITERS`` calls, median of ``REPS`` replays), so the
host's launch cost is out of the number; the operands (75 MB) exceed the
50 MB L2. SDPA's backward is the graph of forward + backward less the
graph of the forward, both captured the same way. Prints one JSON line:
the card, the tag, and per shape the forward and backward ms. Needs a
CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ITERS, REPS = 10, 5
# (name, S, H, d, dv, packed): the diff, control and ndiff recipes
SHAPES = (("diff", 2, 4, 96, 192, True), ("control", 1, 8, 96, 96, False),
          ("ndiff", 4, 4, 96, 192, False))
B, T = 32, 512


def device_ms(torch, fn) -> float:
    """Median device ms of one ``fn()``: ITERS calls in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(ITERS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / ITERS)
    return statistics.median(times)


def bench(torch, flash) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    res = {}
    for name, S, H, d, dv, packed in SHAPES:
        W = 2 * S * H * d + H * dv
        proj = torch.randn(B, T, W, generator=gen, device="cuda").to(torch.bfloat16)
        Hd = H * d
        qs = [proj[..., s * Hd:(s + 1) * Hd] for s in range(S)]
        ks = [proj[..., (S + s) * Hd:(S + s + 1) * Hd] for s in range(S)]
        v = proj[..., 2 * S * Hd:]
        if not packed:
            qs, ks, v = ([t.contiguous() for t in qs], [t.contiguous() for t in ks],
                         v.contiguous())
        c = 0.5 * torch.randn(S, H, generator=gen, device="cuda")
        out, o_all, lse = flash.flash_tm_fwd(qs, ks, v, c, H, True)
        g = torch.randn(B, T, H * dv, generator=gen, device="cuda").to(torch.bfloat16)
        delta = torch.randn(B, T, H * S, generator=gen, device="cuda")
        dqs = [torch.empty(B, T, Hd, dtype=torch.bfloat16, device="cuda")
               for _ in range(2 * S)]
        dvo = torch.empty(B, T, H * dv, dtype=torch.bfloat16, device="cuda")
        row = {
            "fwd_ms": device_ms(torch, lambda: flash.flash_tm_fwd(qs, ks, v, c, H, True)),
            "bwd_ms": device_ms(torch, lambda: flash.flash_tm_bwd(
                qs, ks, v, g, lse, delta, c, H, dqs[:S], dqs[S:], dvo)),
        }
        if S == 1:
            qt, kt, vt = (t.reshape(B, T, H, -1).transpose(1, 2).detach()
                          .requires_grad_(True) for t in (qs[0], ks[0], v))
            gt = g.reshape(B, T, H, -1).transpose(1, 2)
            sdpa = torch.nn.functional.scaled_dot_product_attention

            def fwd_bwd():
                o = sdpa(qt, kt, vt, is_causal=True)
                torch.autograd.grad(o, (qt, kt, vt), gt)

            with torch.no_grad():
                f = device_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True))
            row["sdpa_fwd_ms"] = f
            row["sdpa_bwd_ms"] = device_ms(torch, fwd_bwd) - f
        res[name] = row
        del proj, qs, ks, v, out, o_all, lse, g, delta, dqs, dvo
    return res


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    p.add_argument("--tag", default="")
    args = p.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("attention_bench needs a CUDA GPU", file=sys.stderr)
        return 2
    from differential_transformer_replication_tpu_torch.ops import flash

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "tag": args.tag, "root": args.root,
                      "package": flash.__file__, **bench(torch, flash)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
