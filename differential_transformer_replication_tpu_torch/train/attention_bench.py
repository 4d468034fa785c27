"""Device time of the training attention kernels: the token-major kernels
D and E (``ops/flash.py`` ``flash_tm_fwd`` / ``flash_tm_bwd``,
``csrc/flash_tm.cu``) at the three recipes' attention shapes (B 32, T 512,
bf16), beside PyTorch's ``scaled_dot_product_attention`` at the control
shape; and the head-major kernels (``flash_bh_fwd``, ``flash_chunk_fwd``:
K1, ``csrc/flash_bh_fwd.cu``; K2 and K3, ``csrc/flash_bh_bwd_dq.cu`` and
``csrc/flash_bh_bwd_dkv.cu``, also as the ring chunk's
``flash_chunk_bwd_dq``/``_dkv``; K4, ``csrc/flash_bh_bwd_fused.cu``) at
the shapes of the long-context and ring runs, each beside its bound and,
at S 1 and dropout 0, beside SDPA (K4 and K2 + K3 beside SDPA's
backward); at the fused route's shapes (T 512, B 32) K2 + K3 are timed
beside K4 as the other way to the same backward. It also times the
decode attention of the serving step (``ops/decode_attention.py``,
``csrc/decode_attention.cu``: rows 5-8, contiguous and paged, bf16 and
int8 K/V, L 1 and 5, under ``decode``) at the diff and control decode
shapes, beside SDPA with a boolean mask at the control shape. Under
``ffn`` it times the fused SwiGLU (``ops/fused_ffn.py``,
``csrc/fused_swiglu.cu``: Queue B rows 3 and 4), forward and backward at
the recipe's widths (E 768, F 3072) and M 8 (a decode step), 128 (a
prefill chunk) and 16384 (a training step), each beside its bound and
beside cuBLAS computing the same products alone (``x @ [Wg | Wx]``; for
the backward that plus ``x^T @ [dg | dt]``): a yardstick of what the
card reaches at these shapes, not a one-call equivalent of the function;
and the forward on both of its tensor-core instances at 32 to 128 rows,
where ``swiglu_instance`` switches between them.

    python differential_transformer_replication_tpu_torch/train/attention_bench.py \
        [--root DIR] [--tag NAME] [--parts tm,hm,decode,ffn]

``--root`` names the checkout whose package is timed (default: the one
that holds this file), so that two trees are compared on one card in one
call, in turns (A B B A). The bounds come from this file's own tree
(``testing.attention_work``). Each call of a kernel is captured in a CUDA
graph and replayed (``ITERS`` calls, median of ``REPS`` replays), so the
host's launch cost is out of the number; the calls cycle through copies
of their operands that together exceed the 50 MB L2. SDPA's backward is
the graph of forward + backward less the graph of the forward, both
captured the same way. Prints one JSON line: the card's name and power
limit, the tag, and per shape the kernels' ms (the head-major ones under
``hm``, each with its bound's ms). Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ITERS, REPS = 10, 5
L2_BYTES = 50 * 2**20
PEAK_BYTES_S, PEAK_BF16 = 3.35e12, 989e12  # H100 SXM data sheet, dense
# (name, S, H, d, dv, packed): the diff, control and ndiff recipes
SHAPES = (("diff", 2, 4, 96, 192, True), ("control", 1, 8, 96, 96, False),
          ("ndiff", 4, 4, 96, 192, False))
B, T = 32, 512
HM_RATE = 0.1  # the attention dropout of the long-context and ring runs
HM_WORDS = (0x51F00D, 0x2A7E11)
DIFF, CONTROL = (2, 4, 96, 192), (1, 8, 96, 96)  # (S, H, d, dv)
# K1: (name, (S, H, d, dv), B, T, rate, off in T or None for the combined
# forward, SDPA's causal flag or None)
K1_SHAPES = (
    ("diff T2048 p0", DIFF, 8, 2048, 0.0, None, None),
    ("diff T2048 p0.1", DIFF, 8, 2048, HM_RATE, None, None),
    ("control T512 p0", CONTROL, 32, 512, 0.0, None, True),
    ("diff T8192 p0", DIFF, 2, 8192, 0.0, None, None),
    ("diff T8192 p0.1", DIFF, 2, 8192, HM_RATE, None, None),
    ("chunk diff Tl4096 +Tl p0", DIFF, 2, 4096, 0.0, 1, None),
    ("chunk diff Tl4096 +Tl p0.1", DIFF, 2, 4096, HM_RATE, 1, None),
    ("chunk diff Tl4096 0 p0.1", DIFF, 2, 4096, HM_RATE, 0, None),
    ("chunk diff Tl4096 -Tl p0.1", DIFF, 2, 4096, HM_RATE, -1, None),
    ("chunk control Tl4096 +Tl p0", CONTROL, 2, 4096, 0.0, 1, False),
    ("chunk control Tl4096 0 p0", CONTROL, 2, 4096, 0.0, 0, True),
)
# K2-K4 at the train-hm shapes, dropout 0.1: (name, B, T, kernels; "bwd"
# is K4)
BWD_SHAPES = (("diff T2048 split", 8, 2048, ("dq", "dkv")),
              ("diff T512 fused", 32, 512, ("bwd", "dq", "dkv")),
              ("diff T8192 tiled", 2, 8192, ("dq", "dkv")))
# the backward at the control width, dropout 0, beside SDPA's backward:
# (name, T, B, kernels)
CONTROL_BWD_SHAPES = (("control T512 fused p0", 512, 32, ("bwd", "dq", "dkv")),
                      ("control T2048 split/tiled p0", 2048, 8, ("dq", "dkv")),
                      ("control T8192 split/tiled p0", 8192, 2, ("dq", "dkv")))
# the ring chunk's K2 and K3 (per-stream cotangents), diff width, Tl 4096,
# B 2, dropout 0.1, at offsets +Tl (full), 0 (causal), -Tl (masked)
CHUNK_BWD_TL, CHUNK_BWD_B, CHUNK_BWD_OFFS = 4096, 2, (("+Tl", 1), ("0", 0), ("-Tl", -1))
# decode attention (Queue B rows 5-8) at the serving recipes' decode step:
# 8 slots of M 512 keys, pages of 16, L 1 (the decode step) and 5 (the
# verify step of 4 drafts); (name, S, H, d, dv); the slots' first rows sit
# at DEC_POS (chip_smoke.py's positions), row l at DEC_POS + l
DEC_B, DEC_M, DEC_PS, DEC_LS = 8, 512, 16, (1, 5)
DEC_SHAPES = (("diff", 2, 4, 96, 192), ("control", 1, 8, 96, 96))
DEC_POS = (0, 37, 300, 506, 506, 300, 37, 150)
# the fused SwiGLU (Queue B rows 3 and 4): the recipe's widths, and the
# rows of a decode step, a prefill chunk and a training step
FFN_E, FFN_F, FFN_MS = 768, 3072, (8, 128, 16384)
FFN_SWITCH_MS = (32, 64, 96, 128)  # rows timed on both forward instances
PARTS = ("tm", "hm", "decode", "ffn")


def device_ms(torch, calls) -> float:
    """Median device ms of one call: ITERS calls (cycling through
    ``calls``) in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(ITERS):
            calls[i % len(calls)]()
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


def bound_ms(work) -> float:
    """The least ms for (pairs, bytes, operations) of bf16 work."""
    _, nbytes, ops = work
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_BF16) * 1e3


def copies(nbytes: int, make) -> list:
    """``make()`` called often enough that the operand sets it returns
    together exceed the L2 cache twice over."""
    return [make() for _ in range(max(1, math.ceil(2 * L2_BYTES / nbytes)))]


def bench_tm(torch, flash) -> dict:
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
            "fwd_ms": device_ms(torch, [lambda: flash.flash_tm_fwd(qs, ks, v, c, H, True)]),
            "bwd_ms": device_ms(torch, [lambda: flash.flash_tm_bwd(
                qs, ks, v, g, lse, delta, c, H, dqs[:S], dqs[S:], dvo)]),
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
                f = device_ms(torch, [lambda: sdpa(qt, kt, vt, is_causal=True)])
            row["sdpa_fwd_ms"] = f
            row["sdpa_bwd_ms"] = device_ms(torch, [fwd_bwd]) - f
        res[name] = row
        del proj, qs, ks, v, out, o_all, lse, g, delta, dqs, dvo
    return res


def bench_hm(torch, flash, work) -> dict:
    """K1 at the long-context and ring shapes, and K2-K4 at the train-hm
    shapes; ``work`` is ``testing.attention_work``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    dt = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def operands(S, BH, Tn, d, dv):
        q, k = (torch.randn(BH, S, Tn, d, generator=gen, device="cuda").to(dt)
                for _ in range(2))
        v, g = (torch.randn(BH, Tn, dv, generator=gen, device="cuda").to(dt)
                for _ in range(2))
        return q, k, v, g

    res = {}
    for name, (S, H, d, dv), Bn, Tn, rate, om, causal in K1_SHAPES:
        words = HM_WORDS if rate > 0 else (0, 0)
        off = None if om is None else om * Tn
        kind = "fwd" if off is None else "chunk_fwd"
        w = work(Bn, H, S, Tn, d, dv, off or 0, kind)
        sets = copies(w[1], lambda: operands(S, Bn * H, Tn, d, dv))
        c = torch.ones(S, H, device="cuda")
        if off is None:
            calls = [lambda q=q, k=k, v=v: flash.flash_bh_fwd(q, k, v, c, H, rate, words, True)
                     for q, k, v, _ in sets]
        else:
            calls = [lambda q=q, k=k, v=v: flash.flash_chunk_fwd(q, k, v, off, rate, words)
                     for q, k, v, _ in sets]
        row = {"ms": device_ms(torch, calls), "bound_ms": bound_ms(w)}
        if causal is not None:
            views = [tuple(x.reshape(Bn, H, Tn, -1) for x in s[:3]) for s in sets]
            row["sdpa_ms"] = device_ms(torch, [
                lambda q=q, k=k, v=v: sdpa(q, k, v, is_causal=causal) for q, k, v in views])
        res[name] = row
        del sets, calls
        torch.cuda.empty_cache()
    fns = {"dq": flash.flash_bh_bwd_dq, "dkv": flash.flash_bh_bwd_dkv,
           "bwd": flash.flash_bh_bwd_fused}
    S, H, d, dv = DIFF
    for name, Bn, Tn, kernels in BWD_SHAPES:
        sets = []
        for q, k, v, g in copies(work(Bn, H, S, Tn, d, dv, 0, "bwd")[1],
                                 lambda: operands(S, Bn * H, Tn, d, dv)):
            c = 0.5 * torch.randn(S, H, generator=gen, device="cuda")
            _, _, lse = flash.flash_bh_fwd(q, k, v, c, H, HM_RATE, HM_WORDS, True)
            delta = torch.randn(Bn * H, S, Tn, generator=gen, device="cuda")
            sets.append((q, k, v, g, lse, delta, c, H, HM_RATE, HM_WORDS))
        row = {}
        for kern in kernels:
            row[f"{kern}_ms"] = device_ms(torch, [lambda a=a, f=fns[kern]: f(*a) for a in sets])
            row[f"{kern}_bound_ms"] = bound_ms(work(Bn, H, S, Tn, d, dv, 0, kern))
        res[name] = row
        del sets
        torch.cuda.empty_cache()
    S, H, d, dv = CONTROL
    for label, Tn, Bn, kernels in CONTROL_BWD_SHAPES:
        sets = []
        for q, k, v, g in copies(work(Bn, H, S, Tn, d, dv, 0, "bwd")[1],
                                 lambda: operands(S, Bn * H, Tn, d, dv)):
            c = torch.ones(S, H, device="cuda")
            _, o_all, lse = flash.flash_bh_fwd(q, k, v, c, H, 0.0, (0, 0), True)
            delta = torch.einsum("btd,bstd->bst", g.float(), o_all.float()).contiguous()
            sets.append((q, k, v, g, lse, delta, c, H, 0.0, (0, 0)))
        row = {}
        for kern in kernels:
            row[f"{kern}_ms"] = device_ms(torch, [lambda a=a, f=fns[kern]: f(*a) for a in sets])
            row[f"{kern}_bound_ms"] = bound_ms(work(Bn, H, S, Tn, d, dv, 0, kern))
        views = [tuple(x.reshape(Bn, H, Tn, -1).detach().requires_grad_(True)
                       for x in a[:3]) + (a[3].reshape(Bn, H, Tn, -1),) for a in sets]
        with torch.no_grad():
            f = device_ms(torch, [lambda a=a: sdpa(*a[:3], is_causal=True) for a in views])
        row["sdpa_bwd_ms"] = device_ms(torch, [
            lambda a=a: torch.autograd.grad(sdpa(*a[:3], is_causal=True), a[:3], a[3])
            for a in views]) - f
        res[label] = row
        del sets, views
        torch.cuda.empty_cache()
    S, H, d, dv = DIFF
    Tl, Bn = CHUNK_BWD_TL, CHUNK_BWD_B
    for label, om in CHUNK_BWD_OFFS:
        off = om * Tl
        sets = []
        for q, k, v, _ in copies(work(Bn, H, S, Tl, d, dv, Tl, "chunk_dkv")[1],
                                 lambda: operands(S, Bn * H, Tl, d, dv)):
            do = torch.randn(Bn * H, S, Tl, dv, generator=gen, device="cuda").to(dt)
            _, lse = flash.flash_chunk_fwd(q, k, v, off, HM_RATE, HM_WORDS)
            delta = torch.randn(Bn * H, S, Tl, generator=gen, device="cuda")
            sets.append((q, k, v, do, lse, delta, off, HM_RATE, HM_WORDS))
        row = {}
        for kern, f in (("dq", flash.flash_chunk_bwd_dq), ("dkv", flash.flash_chunk_bwd_dkv)):
            row[f"{kern}_ms"] = device_ms(torch, [lambda a=a, f=f: f(*a) for a in sets])
            row[f"{kern}_bound_ms"] = bound_ms(work(Bn, H, S, Tl, d, dv, off, "chunk_" + kern))
        res[f"chunk bwd diff Tl{Tl} {label} p0.1"] = row
        del sets
        torch.cuda.empty_cache()
    return res


def bench_decode(torch, dat) -> dict:
    """Rows 5-8: each wrapper (contiguous and paged, bf16 and int8 K/V,
    bf16 queries) at the decode shapes, with the bound of the bytes the
    call must move (each visible key's K/V and scales once, the queries,
    the outputs, the page table); SDPA with a boolean visibility mask
    beside the contiguous bf16 calls at the control shape (one stream)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    dt = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pp = DEC_M // DEC_PS
    base = torch.tensor(DEC_POS, dtype=torch.int32, device="cuda")
    res = {}
    for name, S, H, d, dv in DEC_SHAPES:
        c = 0.5 * torch.randn(S, H, generator=gen, device="cuda")
        c[0] = 1.0
        for store in ("bf16", "int8"):
            int8 = store == "int8"
            es = 1 if int8 else 2

            def operands():
                kc = torch.randn(S, DEC_B, H, DEC_M, d, generator=gen, device="cuda").to(dt)
                vc = torch.randn(DEC_B, H, DEC_M, dv, generator=gen, device="cuda").to(dt)
                cs = {}
                if int8:
                    (kc, ks), (vc, vs) = dat.quantize_kv(kc), dat.quantize_kv(vc)
                    cs = {"k_scale": ks, "v_scale": vs}
                tab = torch.randperm(DEC_B * pp, generator=gen, device="cuda").to(
                    torch.int32).reshape(DEC_B, pp)

                def pages(t, axis):  # (.., B, H, M, ..) -> (.., B * pp, H, ps, ..)
                    src = t.unflatten(axis + 2, (pp, DEC_PS)).movedim(axis + 2, axis + 1)
                    return torch.empty_like(src.flatten(axis, axis + 1)).index_copy_(
                        axis, tab.reshape(-1).long(), src.flatten(axis, axis + 1))

                ps = {k: pages(v, 1 if k == "k_scale" else 0) for k, v in cs.items()}
                return dict(kc=kc, vc=vc, cs=cs, kp=pages(kc, 1), vp=pages(vc, 0),
                            tab=tab, ps=ps)

            per_key = H * ((S * d + dv) * es + ((S + 1) * 4 if int8 else 0))
            sets = copies(2 * per_key * DEC_B * DEC_M, operands)
            for L in DEC_LS:
                pos = (base[:, None] + torch.arange(L, device="cuda", dtype=torch.int32))
                q = torch.randn(S, DEC_B, L, H, d, generator=gen, device="cuda").to(dt)
                if L == 1:
                    pos, q = pos[:, 0].contiguous(), q[:, :, 0].contiguous()
                    contiguous, paged = dat.decode_attention, dat.decode_attention_paged
                else:
                    contiguous = dat.decode_attention_multi
                    paged = dat.decode_attention_multi_paged
                vis = int(torch.clamp(pos.reshape(DEC_B, -1).max(1).values + 1,
                                      max=DEC_M).sum())
                nbytes = vis * per_key + (S * d + dv) * DEC_B * L * H * es
                row = {
                    "ms": device_ms(torch, [
                        lambda o=o: contiguous(q, o["kc"], o["vc"], pos, c, **o["cs"])
                        for o in sets]),
                    "paged_ms": device_ms(torch, [
                        lambda o=o: paged(q, o["kp"], o["vp"], o["tab"], pos, c, **o["ps"])
                        for o in sets]),
                    "bound_ms": nbytes / PEAK_BYTES_S * 1e3,
                    "paged_bound_ms": (nbytes + DEC_B * pp * 4) / PEAK_BYTES_S * 1e3,
                }
                if S == 1 and not int8:
                    qt = q[0].reshape(DEC_B, L, H, d).transpose(1, 2)
                    mask = (torch.arange(DEC_M, device="cuda")[None, None, :]
                            <= pos.reshape(DEC_B, L, 1))[:, None]
                    row["sdpa_ms"] = device_ms(torch, [
                        lambda o=o: sdpa(qt, o["kc"][0], o["vc"], attn_mask=mask)
                        for o in sets])
                res[f"{name} {store} L{L}"] = row
            del sets
            torch.cuda.empty_cache()
    return res


def bench_ffn(torch, ffn) -> dict:
    """Rows 3 and 4 in bf16: ``fused_swiglu`` and ``swiglu_bwd`` at each M
    of FFN_MS, the weights cycled past the L2, with the bound (each
    operand read once, each result written once; 4 M E F products
    forward, 8 M E F backward) and cuBLAS's time for the products alone;
    under "switch", where the package has ``swiglu_instance``, the
    forward on each tensor-core instance at FFN_SWITCH_MS rows."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    dt, E, F = torch.bfloat16, FFN_E, FFN_F

    def weights():
        w = [(0.02 * torch.randn(*s, generator=gen, device="cuda")).to(dt)
             for s in ((E, F), (F,), (E, F), (F,))]
        return w, torch.cat([w[0], w[2]], dim=1)

    sets = copies(4 * E * F, weights)
    res = {}
    for M in FFN_MS:
        x = torch.randn(M, E, generator=gen, device="cuda").to(dt)
        gh = torch.randn(M, F, generator=gen, device="cuda").to(dt)
        dgt = torch.randn(M, 2 * F, generator=gen, device="cuda").to(dt)
        fwd_bytes = 2 * (M * E + 2 * E * F + 2 * F + M * F)
        bwd_bytes = 2 * (M * E + 2 * E * F + 2 * F + 3 * M * F) + 4 * (2 * E * F + 2 * F)
        res[f"M{M}"] = {
            "fwd_ms": device_ms(torch, [lambda w=w: ffn.fused_swiglu(x, *w) for w, _ in sets]),
            "fwd_bound_ms": max(fwd_bytes / PEAK_BYTES_S,
                                (4 * M * E * F + 6 * M * F) / PEAK_BF16) * 1e3,
            "fwd_cublas_ms": device_ms(torch, [lambda c=c: x @ c for _, c in sets]),
            "bwd_ms": device_ms(torch, [lambda w=w: ffn.swiglu_bwd(x, *w, gh)
                                        for w, _ in sets]),
            "bwd_bound_ms": max(bwd_bytes / PEAK_BYTES_S,
                                (8 * M * E * F + 20 * M * F) / PEAK_BF16) * 1e3,
            "bwd_cublas_ms": device_ms(torch, [lambda c=c: (x @ c, x.t() @ dgt)
                                               for _, c in sets]),
        }
        del x, gh, dgt
    if hasattr(ffn, "swiglu_instance"):
        # the forward's two tensor-core instances on both sides of the
        # rows where swiglu_instance switches from one to the other
        pick = ffn.swiglu_instance
        try:
            for M in FFN_SWITCH_MS:
                x = torch.randn(M, E, generator=gen, device="cuda").to(dt)
                for inst in ("skinny", "mma"):
                    ffn.swiglu_instance = lambda *a, inst=inst, **k: inst
                    res.setdefault("switch", {}).setdefault(f"M{M}", {})[inst + "_ms"] = \
                        device_ms(torch, [lambda w=w: ffn.fused_swiglu(x, *w) for w, _ in sets])
        finally:
            ffn.swiglu_instance = pick
    del sets
    torch.cuda.empty_cache()
    return res


def _attention_work():
    """``testing.attention_work`` of the tree that holds this file, which
    ``--root`` need not have."""
    path = Path(__file__).resolve().parents[1] / "testing.py"
    spec = importlib.util.spec_from_file_location("_bench_testing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.attention_work


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    p.add_argument("--tag", default="")
    p.add_argument("--parts", default=",".join(PARTS),
                   help="comma-separated parts to time: " + ", ".join(PARTS))
    args = p.parse_args()
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        p.error(f"--parts takes {', '.join(PARTS)}")
    work = _attention_work()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("attention_bench needs a CUDA GPU", file=sys.stderr)
        return 2
    from differential_transformer_replication_tpu_torch.ops import (
        decode_attention as dat,
        flash,
        fused_ffn as ffn,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    out = {"card": card, "tag": args.tag, "root": args.root, "package": flash.__file__}
    if "tm" in parts:
        out.update(bench_tm(torch, flash))
    if "hm" in parts:
        out["hm"] = bench_hm(torch, flash, work)
    if "decode" in parts:
        out["decode"] = bench_decode(torch, dat)
    if "ffn" in parts:
        out["ffn"] = bench_ffn(torch, ffn)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
