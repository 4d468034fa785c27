"""The port's hand-written kernels on the card, against their plain
PyTorch versions. These tests need a CUDA GPU (marker ``gpu``) and skip
without one; they import nothing of JAX, so they run on a machine
without it through the repository's test command minus the JAX
conftest:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

fp32 bounds: 1e-5 (norm, attention), 5e-5 (SwiGLU: fp32 accumulation
order over E products). bf16 bounds: one bf16 rounding step at the
largest output (2^-7 * max|ref|), and for decode attention also 2^-8 of
sum|c| * max|V| (the kernel rounds each stream's probabilities before
its PV product, the plain version rounds the combined map once; with
int8 K/V, |V| is bounded by 127 times the largest V scale). The paged
and multi-row decode-attention instances must equal the contiguous
single-row instance bit for bit on the same contents.

The training kernels (add+norm backward, SwiGLU backward) share their
plain versions' rounding points, so what differs is the order of fp32
sums: gradients are held to 1e-4 of each result's max |value| in fp32,
one bf16 step in bf16. The attention kernels (token-major D/E,
head-major K1-K4) are held row by row, each query row (dq, out, o_all)
or key row (dk, dv) of each head against its own scale, as
``differential_transformer_replication_tpu_torch/testing.py`` sets out:
a bound scaled by a tensor's largest value would not see late rows,
whose values under causal attention are far smaller than the first
rows'.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu_torch import testing
from differential_transformer_replication_tpu_torch.config import (
    ModelConfig,
    ServingConfig,
)
from differential_transformer_replication_tpu_torch.models import init_model
from differential_transformer_replication_tpu_torch.models import model_forward
from differential_transformer_replication_tpu_torch.ops import decode_attention as dat
from differential_transformer_replication_tpu_torch.ops import flash
from differential_transformer_replication_tpu_torch.ops import fused_ffn as ffn
from differential_transformer_replication_tpu_torch.ops import fused_norm_residual as fnr
from differential_transformer_replication_tpu_torch.serving.engine import ServingEngine
from differential_transformer_replication_tpu_torch.config import TrainConfig
from differential_transformer_replication_tpu_torch.train.optim import leaves
from differential_transformer_replication_tpu_torch.train.step import (
    make_train_step,
    train_state,
)

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _ulp(ref: torch.Tensor) -> float:
    return 2.0 ** -7 * float(ref.float().abs().max())


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 768), (3, 5, 100), (129, 1536)])
def test_add_norm_kernels_match_plain(gen, dtype, shape):
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    d = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    E = shape[-1]
    w = 1 + 0.1 * torch.randn(E, generator=gen, device="cuda")
    b = 0.1 * torch.randn(E, generator=gen, device="cuda")
    n0, a0 = fnr.fused_norm.launches, fnr.fused_add_norm.launches
    carry, normed = fnr.fused_add_norm(x, d, w, b)
    ref_carry, ref = fnr.add_norm_reference(x, d, w, b)
    assert _err(carry, ref_carry) == 0.0
    tol = 1e-5 if dtype == torch.float32 else _ulp(ref)
    assert _err(normed, ref) <= tol
    assert _err(fnr.fused_norm(x, w, b), fnr.norm_reference(x, w, b)) <= (
        1e-5 if dtype == torch.float32 else _ulp(fnr.norm_reference(x, w, b)))
    assert (fnr.fused_norm.launches - n0, fnr.fused_add_norm.launches - a0) == (1, 1)


# bf16 takes the tensor-core instances at widths in multiples of 8
# (swiglu_instance: skinny at M <= 64, mma above; M 40, 100 and 1000 off
# the 8- and 128-row grids; (64, 256) and (72, 200) widths off the
# 128-column tile); fp32 and (5, 70, 99) the SIMT kernels
SWIGLU_SHAPES = [(M, E, F) for E, F in ((768, 3072), (64, 256), (72, 200))
                 for M in (1, 8, 40, 64, 100, 128, 1000, 16384)] + [(5, 70, 99),
                                                                    (1024, 768, 3072)]


def _swiglu_operands(gen, dtype, M, E, F):
    x = torch.randn(M, E, generator=gen, device="cuda").to(dtype)
    ws = [(0.05 * torch.randn(*s, generator=gen, device="cuda")).to(dtype)
          for s in ((E, F), (F,), (E, F), (F,))]
    return x, ws


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("M,E,F", SWIGLU_SHAPES)
def test_swiglu_kernel_matches_plain(gen, dtype, M, E, F):
    x, ws = _swiglu_operands(gen, dtype, M, E, F)
    inst = ffn.swiglu_instance(dtype, M, E, F)
    n0, i0 = ffn.fused_swiglu.launches, ffn.fused_swiglu.instances[inst]
    got = ffn.fused_swiglu(x, *ws)
    ref = ffn.swiglu_reference(x, *ws)
    assert got.dtype == dtype and got.shape == (M, F)
    assert _err(got, ref) <= (5e-5 if dtype == torch.float32 else _ulp(ref))
    assert ffn.fused_swiglu.launches - n0 == 1
    assert ffn.fused_swiglu.instances[inst] - i0 == 1
    assert torch.equal(got, ffn.fused_swiglu(x, *ws))


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
# (3, 36, 72) in bf16 takes the scalar staging path (36 is not a
# multiple of the 8-element vector); the others stage 16-byte vectors
@pytest.mark.parametrize("S,d,dv", [(1, 96, 96), (2, 96, 192), (4, 40, 80),
                                    (3, 36, 72)])
def test_decode_attention_kernel_matches_plain(gen, dtype, S, d, dv):
    B, H, M = 6, 4, 512
    q = torch.randn(S, B, H, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(S, B, H, M, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, H, M, dv, generator=gen, device="cuda").to(dtype)
    pos = torch.tensor([0, 37, 300, 511, 512, 900], dtype=torch.int32, device="cuda")
    c = torch.randn(S, H, generator=gen, device="cuda") * 0.5
    c[0] = 1.0
    n0 = dat.decode_attention.launches
    got = dat.decode_attention(q, k, v, pos, c)
    ref = dat.decode_attention_reference(q, k, v, pos, c)
    if dtype == torch.float32:
        tol = 1e-5
    else:
        tol = (2.0 ** -8 * float(c.abs().sum(0).max()) * float(v.float().abs().max())
               + _ulp(ref))
    assert _err(got, ref) <= tol
    assert dat.decode_attention.launches - n0 == 1


def _paged_copy(t: torch.Tensor, tab: torch.Tensor, ps: int, axis: int,
                n_pages: int, gen) -> torch.Tensor:
    """A paged pool holding the slots of the contiguous leaf ``t`` (batch
    axis ``axis``) behind ``tab``; every other page, the trash page 0
    included, holds garbage that a correct kernel never reads."""
    shape = list(t.shape)
    shape[axis], shape[axis + 2] = n_pages, ps  # (.., B, H, M, ..) -> (.., P, H, ps, ..)
    out = torch.randn(*shape, generator=gen, device=t.device).to(t.dtype) \
        if t.dtype != torch.int8 else torch.randint(
            -127, 128, shape, generator=gen, device=t.device).to(torch.int8)
    # slot b's logical page j at physical page tab[b, j]
    pages = t.unflatten(axis + 2, (-1, ps)).movedim(axis + 2, axis + 1).flatten(axis, axis + 1)
    return out.index_copy_(axis, tab.reshape(-1).long(), pages)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("ps", [8, 16, 64, 128])
# (4, 40, 80): d not a multiple of 16, the int8 scalar staging path
@pytest.mark.parametrize("S,d,dv", [(2, 96, 192), (4, 40, 80)])
def test_paged_and_multi_kernels_match_plain(gen, dtype, int8, ps, S, d, dv):
    """Rows 5 (float and int8), 6, 7 and 8 on the card: each kernel
    instance against its plain version for L = 1..5 rows; the paged
    instances equal the contiguous ones bit for bit on the same contents
    (same tile order), and row l of the multi-row instance equals the
    single-row instance at pos[:, l]."""
    B, H, M = 6, 4, 512
    R = B + 1
    kc = torch.randn(S, R, H, M, d, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(R, H, M, dv, generator=gen, device="cuda").to(dtype)
    scales = {}
    if int8:
        (kc, ks), (vc, vs) = dat.quantize_kv(kc), dat.quantize_kv(vc)
        scales = {"k_scale": ks, "v_scale": vs}
    pp = M // ps
    P = 1 + B * pp + 5
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(ps))
    tab = (1 + perm[:B * pp]).reshape(B, pp).to(torch.int32).cuda()
    kp = _paged_copy(kc[:, :B], tab, ps, 1, P, gen)
    vp = _paged_copy(vc[:B], tab, ps, 0, P, gen)
    pscales = {}
    if int8:
        pscales = {"k_scale": _paged_copy(ks[:, :B].unsqueeze(-1), tab, ps, 1, P,
                                          gen).squeeze(-1).abs(),
                   "v_scale": _paged_copy(vs[:B].unsqueeze(-1), tab, ps, 0, P,
                                          gen).squeeze(-1).abs()}
    c = torch.randn(S, H, generator=gen, device="cuda") * 0.5
    c[0] = 1.0
    vmax = float(vc.float().abs().max()) if not int8 else float(vs.max()) * 127
    for L in range(1, 6):
        base = torch.tensor([0, 7, 15 + ps, 300, 511 - L, 128 - L],
                            dtype=torch.int32, device="cuda")
        pos = (base[:, None] + torch.arange(L, device="cuda", dtype=torch.int32)).contiguous()
        q = torch.randn(S, B, L, H, d, generator=gen, device="cuda").to(dtype)
        counts = [f.launches for f in (dat.decode_attention, dat.decode_attention_paged,
                                       dat.decode_attention_multi,
                                       dat.decode_attention_multi_paged)]
        multi = dat.decode_attention_multi(q, kc, vc, pos, c, **scales)
        multi_p = dat.decode_attention_multi_paged(q, kp, vp, tab, pos, c, **pscales)
        ref = dat.decode_attention_multi_reference(q, kc, vc, pos, c, **scales)
        tol = 1e-5 if dtype == torch.float32 else (
            2.0 ** -8 * float(c.abs().sum(0).max()) * vmax + _ulp(ref))
        assert _err(multi, ref) <= tol and torch.equal(multi, multi_p), L
        for l in range(L):
            ql, pl = q[:, :, l].contiguous(), pos[:, l].contiguous()
            one = dat.decode_attention(
                ql, kc[:, :B].contiguous(), vc[:B].contiguous(), pl, c,
                **{k: (v[:, :B] if k == "k_scale" else v[:B]).contiguous()
                   for k, v in scales.items()})
            one_p = dat.decode_attention_paged(ql, kp, vp, tab, pl, c, **pscales)
            ref1 = dat.decode_attention_paged_reference(ql, kp, vp, tab, pl, c, **pscales)
            assert _err(one_p, ref1) <= tol, (L, l)
            assert torch.equal(one, one_p) and torch.equal(one, multi[:, l]), (L, l)
        after = [f.launches for f in (dat.decode_attention, dat.decode_attention_paged,
                                      dat.decode_attention_multi,
                                      dat.decode_attention_multi_paged)]
        assert [a - b for a, b in zip(after, counts)] == [L, L, 1, 1]


def _decode_rows_ok(got: torch.Tensor, ref: torch.Tensor, c: torch.Tensor,
                    vmax: float) -> torch.Tensor:
    """Per output row (b, l) of a (B, L, H, dv) result: within the bf16
    bound of decode attention, 2^-8 of sum|c| * max|V| plus one bf16 step
    of that row's own largest value."""
    err = (got.float() - ref.float()).abs().amax(dim=(2, 3))
    tol = (2.0 ** -8 * float(c.abs().sum(0).max()) * vmax
           + 2.0 ** -7 * ref.float().abs().amax(dim=(2, 3)))
    return err <= tol


@pytest.mark.parametrize("store", ["bf16", "int8"])
@pytest.mark.parametrize("S", [1, 2, 4, 8])
# (40, 80): widths off the 16-column step and the int8 16-value loads
@pytest.mark.parametrize("d,dv", [(96, 192), (96, 96), (40, 80), (64, 64),
                                  (128, 128), (256, 512)])
def test_decode_mma_instances_across_the_envelope(gen, store, S, d, dv):
    """The tensor-core instances (bf16 queries, bf16 or int8 K/V) of rows
    5-8 for L 1, 2, 5, 8, 9, 16 (past 8: passes of 8 rows) over pages of
    8, 16 and 128 and the contiguous
    cache, at positions 0, off the tile grid, M - 1 and past M: each row
    of the multi-row call within the bf16 bound of its plain version; row
    l equal to the single-row call at pos[:, l], paged equal to contiguous
    and two calls equal, bit for bit; outputs zeroed past row L/2 fail the
    bound."""
    B, H, M = 4, 2, 512
    R = B + 1
    assert dat.decode_instance(torch.bfloat16, S, 1, d, dv)[0] == "mma"
    kc = torch.randn(S, R, H, M, d, generator=gen, device="cuda").to(torch.bfloat16)
    vc = torch.randn(R, H, M, dv, generator=gen, device="cuda").to(torch.bfloat16)
    scales = {}
    if store == "int8":
        (kc, ks), (vc, vs) = dat.quantize_kv(kc), dat.quantize_kv(vc)
        scales = {"k_scale": ks, "v_scale": vs}
    one_scales = {k: (v[:, :B] if k == "k_scale" else v[:B]).contiguous()
                  for k, v in scales.items()}
    kc1, vc1 = kc[:, :B].contiguous(), vc[:B].contiguous()
    pools = {}
    for ps in (8, 16, 128):
        pp = M // ps
        P = 1 + B * pp + 3
        perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(ps))
        tab = (1 + perm[:B * pp]).reshape(B, pp).to(torch.int32).cuda()
        pscales = {k: _paged_copy(v, tab, ps, 1 if k == "k_scale" else 0, P, gen)
                   for k, v in one_scales.items()}
        pools[ps] = (_paged_copy(kc1, tab, ps, 1, P, gen),
                     _paged_copy(vc1, tab, ps, 0, P, gen), tab, pscales)
    c = torch.randn(S, H, generator=gen, device="cuda") * 0.5
    c[0] = 1.0
    vmax = float(vc.float().abs().max()) if store == "bf16" else float(vs.max()) * 127
    for L in (1, 2, 5, 8, 9, 16):
        # slot 0's rows start at key 0, slot 1's off every tile grid, slot
        # 2's last row at M - 1, slot 3's rows all past M (every key)
        base = torch.tensor([0, 77, M - L, M + 5], dtype=torch.int32, device="cuda")
        pos = (base[:, None] + torch.arange(L, device="cuda", dtype=torch.int32)).contiguous()
        q = torch.randn(S, B, L, H, d, generator=gen, device="cuda").to(torch.bfloat16)
        multi = dat.decode_attention_multi(q, kc, vc, pos, c, **scales)
        assert torch.equal(multi, dat.decode_attention_multi(q, kc, vc, pos, c, **scales))
        ref = dat.decode_attention_multi_reference(q, kc, vc, pos, c, **scales)
        ok = _decode_rows_ok(multi, ref, c, vmax)
        assert bool(ok.all()), (L, ok.logical_not().nonzero().tolist())
        if L == 8:
            bad = multi.clone()
            bad[:, L // 2 + 1:] = 0
            assert not bool(_decode_rows_ok(bad, ref, c, vmax)[:, L // 2 + 1:].all())
        for ps, (kp, vp, tab, pscales) in pools.items():
            assert torch.equal(
                dat.decode_attention_multi_paged(q, kp, vp, tab, pos, c, **pscales),
                multi), (L, ps)
        for l in range(L):
            ql, pl = q[:, :, l].contiguous(), pos[:, l].contiguous()
            one = dat.decode_attention(ql, kc1, vc1, pl, c, **one_scales)
            assert torch.equal(one, multi[:, l]), (L, l)
            for ps, (kp, vp, tab, pscales) in pools.items():
                assert torch.equal(
                    dat.decode_attention_paged(ql, kp, vp, tab, pl, c, **pscales),
                    one), (L, l, ps)


@pytest.mark.parametrize("verify", ["exact", "batched"])
@pytest.mark.parametrize("kind", ["control", "diff", "ndiff"])
def test_paged_int8_spec_engine_on_the_card_matches_the_cpu(gen, kind, verify):
    """fp32 greedy serving with the paged pool, the prefix cache, the
    int8 cache and n-gram speculation (exact: unrolled paged L=1 steps;
    batched: the multi-row kernel): the card (kernels) gives the CPU's
    tokens, and the paged kernels of that verify ran."""
    cfg = ModelConfig(model=kind, vocab_size=97, n_embd=64, n_head=2,
                      n_layer=2, block_size=64, n_terms=3,
                      compute_dtype="float32")
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(3)
    params = init_model(cpu_gen, cfg)
    shared = [(11 * j) % 97 for j in range(20)]
    prompts = [shared + [1, 2], [5, 6, 7, 8] * 4, shared + [3], [9, 4, 9, 4, 9]]
    serving = ServingConfig(num_slots=2, prefill_chunk=8, prefill_budget=16,
                            kv_page_size=16, kv_cache_dtype="int8",
                            spec_mode="ngram", spec_verify=verify)
    wrappers = (dat.decode_attention_paged,) + (
        (dat.decode_attention_multi_paged,) if verify == "batched" else ())
    before = [w.int8_launches for w in wrappers]
    eng = ServingEngine(params, cfg, serving)
    on_card = eng.generate(prompts, max_new_tokens=12, temperature=0.0)
    assert all(w.int8_launches > n for w, n in zip(wrappers, before))
    assert eng.page_stats()["hits_total"] >= 1
    on_cpu = ServingEngine(params, cfg, serving, device="cpu").generate(
        prompts, max_new_tokens=12, temperature=0.0)
    assert [o.tokens for o in on_card] == [o.tokens for o in on_cpu]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_page_extract_and_inject_round_trip_on_the_card(gen, kv):
    """A page of the recipe's decode pool (bf16 or int8 with its scale
    planes; K's page axis is not its outer one, so its page is strided)
    comes to the host as owned tensors and goes back into another page
    bit for bit; flipping a byte of the image leaves the pool alone."""
    from differential_transformer_replication_tpu_torch.models.decode import (
        KV_CACHE_BATCH_AXIS,
        extract_cache_page,
        init_cache_paged,
        inject_cache_page,
    )

    cfg = ModelConfig(model="diff", vocab_size=97, n_embd=768, n_head=4,
                      n_layer=2, block_size=512, compute_dtype="bfloat16",
                      kv_cache_dtype=kv)
    cache = init_cache_paged(cfg, 9, 16, "cuda")
    for layer in cache:
        for t in layer.values():
            if t.is_floating_point():
                t.normal_(generator=gen)
            else:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                      device="cuda", dtype=torch.int8))
    snap = [{k: t.clone() for k, t in layer.items()} for layer in cache]
    img = extract_cache_page(cache, 3)
    for layer, c in zip(img, cache):
        assert set(layer) == set(c)
        for key, t in layer.items():
            assert t.device.type == "cpu" and t.dtype == c[key].dtype
            assert torch.equal(t.cuda(), c[key].select(KV_CACHE_BATCH_AXIS[key], 3))
    img[0]["k"].reshape(-1).view(torch.uint8)[0] ^= 0xFF
    assert all(torch.equal(t, snap[i][k]) for i, layer in enumerate(cache)
               for k, t in layer.items())
    img[0]["k"].reshape(-1).view(torch.uint8)[0] ^= 0xFF
    inject_cache_page(cache, 7, img)
    for i, layer in enumerate(cache):
        for key, t in layer.items():
            ax = KV_CACHE_BATCH_AXIS[key]
            assert torch.equal(t.select(ax, 7), t.select(ax, 3))
            others = [p for p in range(9) if p != 7]
            assert torch.equal(t.index_select(ax, torch.tensor(others, device="cuda")),
                               snap[i][key].index_select(
                                   ax, torch.tensor(others, device="cuda")))


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_a_preempted_request_resumes_on_the_card_as_if_never_stopped(gen, kv):
    """bf16 serving with the host tier: a low-priority request (greedy,
    and one sampled) is preempted by a high-priority one, its pages go to
    the host and come back into other pages, and its tokens equal its run
    without pressure bit for bit."""
    cfg = ModelConfig(model="diff", vocab_size=97, n_embd=64, n_head=2,
                      n_layer=2, block_size=64, compute_dtype="bfloat16")
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(6)
    params = init_model(cpu_gen, cfg)
    serving = dict(num_slots=3, prefill_chunk=8, prefill_budget=64,
                   kv_page_size=8, kv_cache_dtype=kv)
    low = [[(7 * j + 3) % 97 for j in range(20)], [(5 * j + 1) % 97 for j in range(20)]]
    kws = [dict(max_new_tokens=30, temperature=0.0, priority="batch"),
           dict(max_new_tokens=30, temperature=0.8, top_k=20, seed=4,
                priority="batch")]
    ref = ServingEngine(params, cfg, ServingConfig(**serving))
    want = [ref.generate([p], **kw)[0].tokens for p, kw in zip(low, kws)]
    eng = ServingEngine(params, cfg, ServingConfig(
        **serving, kv_pool_pages=14, host_tier_bytes=1 << 26))
    rids = [eng.submit(p, **kw) for p, kw in zip(low, kws)]
    outs = {}
    while not all(eng._slot_for(r) is not None and len(eng._slot_for(r).generated) >= 3
                  for r in rids):
        outs.update({o.request_id: o for o in eng.step()})
    eng.submit([2] * 30, max_new_tokens=30, temperature=0.0, priority="high")
    outs.update({o.request_id: o for o in eng.run()})
    assert eng.stats["preemptions"] >= 1
    assert eng.stats["resumes"] == eng.stats["preemptions"]
    assert [outs[r].tokens for r in rids] == want


@pytest.mark.parametrize("page_size", [0, 16])
def test_batched_verify_of_eight_drafts_on_the_card_matches_the_cpu(gen, page_size):
    """Batched verify of up to 8 drafts (L = 9 rows a slot, two kernel
    passes) serves to completion on the card, fp32 greedy, with the CPU's
    tokens, contiguous and paged."""
    cfg = ModelConfig(model="diff", vocab_size=97, n_embd=64, n_head=2,
                      n_layer=2, block_size=96, compute_dtype="float32")
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(5)
    params = init_model(cpu_gen, cfg)
    motif = [5, 6, 7, 8, 9, 10, 11, 12, 13, 14]
    prompts = [motif * 3, [3, 1, 4, 1, 5, 9, 2, 6] * 3, motif * 2 + [1]]
    serving = ServingConfig(num_slots=2, prefill_chunk=8, prefill_budget=16,
                            kv_page_size=page_size, spec_mode="ngram",
                            spec_draft_len=8, spec_verify="batched")
    multi = dat.decode_attention_multi_paged if page_size else dat.decode_attention_multi
    n0 = multi.launches
    eng = ServingEngine(params, cfg, serving)
    on_card = eng.generate(prompts, max_new_tokens=24, temperature=0.0)
    assert multi.launches > n0
    on_cpu = ServingEngine(params, cfg, serving, device="cpu").generate(
        prompts, max_new_tokens=24, temperature=0.0)
    assert [o.tokens for o in on_card] == [o.tokens for o in on_cpu]
    assert all(len(o.tokens) == 24 for o in on_card)


@pytest.mark.parametrize("kind", ["control", "diff", "ndiff"])
def test_engine_on_the_card_matches_the_cpu(gen, kind):
    """fp32 greedy serving through the kernels gives the CPU's tokens
    (plain versions), and every kernel of the path was launched."""
    cfg = ModelConfig(model=kind, vocab_size=97, n_embd=64, n_head=2,
                      n_layer=2, block_size=64, n_terms=3,
                      compute_dtype="float32")
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(3)
    params = init_model(cpu_gen, cfg)
    prompts = [[(7 * i + j) % 97 for j in range(n)]
               for i, n in enumerate((3, 17, 30, 9))]
    serving = ServingConfig(num_slots=2, prefill_chunk=8, prefill_budget=16)
    wrappers = (fnr.fused_norm, fnr.fused_add_norm, ffn.fused_swiglu,
                dat.decode_attention)
    before = [w.launches for w in wrappers]
    on_card = ServingEngine(params, cfg, serving).generate(
        prompts, max_new_tokens=12, temperature=0.0)
    assert all(w.launches > n for w, n in zip(wrappers, before))
    on_cpu = ServingEngine(params, cfg, serving, device="cpu").generate(
        prompts, max_new_tokens=12, temperature=0.0)
    assert [o.tokens for o in on_card] == [o.tokens for o in on_cpu]


@pytest.mark.parametrize("shape", [(8, 12000), (8, 5, 12000)],
                         ids=["sampler", "verify"])
def test_quality_vector_on_the_card_matches_the_cpu(gen, shape):
    """The quality tail (plain torch ops, no kernel of its own) at the
    recipe's vocab: the card's result equals the CPU's within 1e-5,
    fully masked and top-k-masked rows included."""
    from differential_transformer_replication_tpu_torch.models.decode import (
        quality_vector,
    )

    cpu = torch.Generator()
    cpu.manual_seed(4)
    proc = torch.randn(shape, generator=cpu) * 4
    flat = proc.view(-1, shape[-1])
    flat[1] = -torch.inf
    flat[2, 50:] = -torch.inf
    lp = torch.log_softmax(proc / 0.7, dim=-1)
    tokens = torch.randint(0, 3, shape[:-1], generator=cpu)
    prev = torch.randint(-1, 3, shape[:-1], generator=cpu)
    want = quality_vector(lp, proc, tokens, prev)
    got = quality_vector(*(t.cuda() for t in (lp, proc, tokens, prev))).cpu()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "paged-spec"])
def test_quality_telemetry_moves_no_token_on_the_card(gen, spec):
    """A 2-layer bf16 engine gives the same greedy tokens with quality
    telemetry on and off (the tail rides the tokens' copy to the host),
    and every request carries its quality when on."""
    cfg = ModelConfig(model="diff", vocab_size=12000, n_embd=128, n_head=2,
                      n_layer=2, block_size=128, compute_dtype="bfloat16")
    params = init_model(gen, cfg)
    motif = [11, 12, 13, 14, 15, 16]
    prompts = [motif * 4, [(7 * i) % 12000 for i in range(40)], motif * 2 + [9]]
    extra = dict(kv_page_size=16, spec_mode="ngram") if spec else {}
    outs = {}
    for q in (False, True):
        serving = ServingConfig(num_slots=2, prefill_chunk=16, prefill_budget=32,
                                quality_telemetry=q, **extra)
        outs[q] = ServingEngine(params, cfg, serving).generate(
            prompts, max_new_tokens=20, temperature=0.0)
    assert [o.tokens for o in outs[True]] == [o.tokens for o in outs[False]]
    assert all(o.quality["tokens_observed"] == 20 for o in outs[True])
    assert all(o.quality is None for o in outs[False])


# ---------------------------------------------------------------------------
# the training kernels
# ---------------------------------------------------------------------------


def _heads(t: torch.Tensor, B: int, T: int, H: int) -> torch.Tensor:
    """(B, T, H * w) token-major -> (B * H, T, w): one row per (head, token)."""
    return t.reshape(B, T, H, -1).transpose(1, 2).reshape(B * H, T, -1)


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return _err(got, ref) / max(float(ref.float().abs().max()), 1e-30)


# bf16 instances: "16-byte" copies where every base pointer, row stride and
# head width is a multiple of 8 bf16 (16 bytes), else "2-byte" loads (the
# d = 12 cases); T off the 64-row tile, d off the 16-wide product depth,
# and S 3 and 4 at dv 192 (the largest accumulators)
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("S,B,T,H,d,dv,packed", [
    (1, 2, 40, 2, 8, 8, False), (2, 2, 40, 2, 8, 16, True),
    (4, 2, 40, 3, 12, 24, False),    # 2-byte
    (2, 2, 100, 2, 24, 48, True),    # T off the tile, d 24, 16-byte
    (2, 2, 500, 2, 12, 24, True),    # T 500, 2-byte
    (1, 2, 100, 3, 40, 40, False),   # d 40, 16-byte
    (3, 1, 500, 2, 96, 192, False),  # S 3 at dv 192
    (4, 1, 100, 2, 96, 192, True),   # S 4 at dv 192, packed
    (2, 2, 512, 4, 96, 192, True),   # diff recipe (batch cut)
    (1, 2, 512, 8, 96, 96, False),   # control recipe
    (4, 1, 512, 4, 96, 192, False),  # ndiff recipe
])
def test_flash_tm_kernels_match_plain(gen, dtype, S, B, T, H, d, dv, packed):
    W = 2 * S * H * d + H * dv
    proj = torch.randn(B, T, W, generator=gen, device="cuda").to(dtype)
    if not packed:
        proj = proj.clone()
    Hd = H * d
    qs = [proj[..., s * Hd:(s + 1) * Hd] for s in range(S)]
    ks = [proj[..., (S + s) * Hd:(S + s + 1) * Hd] for s in range(S)]
    v = proj[..., 2 * S * Hd:]
    if not packed:
        qs, ks, v = ([t.contiguous() for t in qs], [t.contiguous() for t in ks],
                     v.contiguous())
    c = torch.randn(S, H, generator=gen, device="cuda") * 0.5
    c[0] = 1.0
    f0, b0 = flash.flash_tm_fwd.launches, flash.flash_tm_bwd.launches
    out, o_all, lse = flash.flash_tm_fwd(qs, ks, v, c, H, True)
    r_out, r_oall, r_lse = flash.tm_attention_fwd_reference(qs, ks, v, c, H)
    assert flash.flash_tm_fwd(qs, ks, v, c, H, False)[1] is None
    g = torch.randn(B, T, H * dv, generator=gen, device="cuda").to(dtype)
    delta = torch.randn(B, T, H * S, generator=gen, device="cuda")
    dqs = [torch.empty_like(q, memory_format=torch.contiguous_format) for q in qs]
    dks = [torch.empty_like(k, memory_format=torch.contiguous_format) for k in ks]
    dv_ = torch.empty(B, T, H * dv, dtype=dtype, device="cuda")
    flash.flash_tm_bwd(qs, ks, v, g, r_lse, delta, c, H, dqs, dks, dv_)
    rq, rk, rv = flash.tm_attention_bwd_reference(qs, ks, v, g, r_lse, delta, c, H)
    assert (flash.flash_tm_fwd.launches - f0, flash.flash_tm_bwd.launches - b0) == (2, 1)
    fwd = testing.attention_fwd_ratios(
        _heads(out, B, T, H), o_all.reshape(B * H, S, T, dv), _heads(r_out, B, T, H),
        r_oall.reshape(B * H, S, T, dv), c.t().repeat(B, 1))
    assert max(fwd) <= 1.0
    if dtype == torch.float32:
        assert _err(out, r_out) <= 1e-5 and _err(o_all, r_oall) <= 1e-5
        assert _err(lse, r_lse) <= 1e-5
    else:
        assert _err(lse, r_lse) <= 1e-5 * float(r_lse.abs().max())
    for got, ref in zip([*dqs, *dks, dv_], [*rq, *rk, rv]):
        assert testing.grad_ratio(_heads(got, B, T, H), _heads(ref, B, T, H)) <= 1.0
    # a second launch gives the same bits (one writer per output, no atomics)
    out2, o_all2, lse2 = flash.flash_tm_fwd(qs, ks, v, c, H, True)
    assert torch.equal(out2, out) and torch.equal(o_all2, o_all)
    assert torch.equal(lse2, lse)
    again = [torch.empty_like(t) for t in [*dqs, *dks, dv_]]
    flash.flash_tm_bwd(qs, ks, v, g, r_lse, delta, c, H, again[:S],
                       again[S:2 * S], again[2 * S])
    assert all(torch.equal(a, b) for a, b in zip(again, [*dqs, *dks, dv_]))


# M 1, a ragged 2053 rows (prime: no rows-per-block divides it), the
# recipe's 16384 with and without the carry; every warp instance's width
# (E 64, 264, 768, 1024) and the block instance (100, 1032)
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,with_gx", [
    ((300, 768), True), ((3, 5, 100), False), ((16384, 768), True),
    ((1, 768), True), ((1, 768), False), ((2053, 768), False), ((2053, 768), True),
    ((16384, 768), False), ((7, 64), True), ((129, 264), False), ((257, 1024), True),
    ((33, 1032), False), ((2053, 100), True)])
def test_add_norm_bwd_kernel_matches_plain(gen, dtype, shape, with_gx):
    E = shape[-1]
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    gn = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    gx = torch.randn(*shape, generator=gen, device="cuda").to(dtype) if with_gx else None
    w = 1 + 0.1 * torch.randn(E, generator=gen, device="cuda")
    inst = fnr.add_norm_bwd_instance(dtype, E)
    n0, c0, i0 = (fnr.add_norm_bwd.launches, fnr.add_norm_bwd.carry_launches,
                  fnr.add_norm_bwd.instances[inst])
    dx, dw, db = fnr.add_norm_bwd(x, w, gn, gx)
    rdx, rdw, rdb = fnr.add_norm_bwd_reference(x, w, gn, gx)
    assert fnr.add_norm_bwd.launches - n0 == 1
    assert fnr.add_norm_bwd.carry_launches - c0 == int(with_gx)
    assert fnr.add_norm_bwd.instances[inst] - i0 == 1
    assert inst.endswith("block") == (E % 8 != 0 or E > fnr.WARP_MAX_E)
    assert _err(dx, rdx) <= (1e-5 * float(rdx.abs().max()) if dtype == torch.float32
                             else _ulp(rdx))
    assert _rel(dw, rdw) <= 1e-4 and _rel(db, rdb) <= 1e-4
    # no float atomics: a second call gives the same bits
    again = fnr.add_norm_bwd(x, w, gn, gx)
    assert all(torch.equal(a, b) for a, b in zip(again, (dx, dw, db)))


@pytest.mark.parametrize("mode", [0, 1], ids=["uniform", "a-near-2-b-near-1"])
def test_add_norm_bwd_quotient_equals_ieee_division(gen, mode):
    """The backward's quotients by a row's denom come from one correctly
    rounded reciprocal and an FMA correction each; on 2^26 pairs with
    exponents within 2^+-60 (significands uniform, or where a * (1/b) is
    farthest from a / b) they equal IEEE division bit for bit."""
    from differential_transformer_replication_tpu_torch.ops import _kernels

    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    lib = _kernels.load("fused_norm_residual")
    rc = lib.fused_norm_residual_quot_check(bad.data_ptr(), 4096, 12 + mode, mode,
                                            _kernels.stream_handle(bad.device))
    assert rc == 0
    assert int(bad) == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("M,E,F", SWIGLU_SHAPES + [(300, 768, 3072)])
def test_swiglu_bwd_kernel_matches_plain(gen, dtype, M, E, F):
    x, ws = _swiglu_operands(gen, dtype, M, E, F)
    gh = torch.randn(M, F, generator=gen, device="cuda").to(dtype)
    inst = ffn.swiglu_instance(dtype, M, E, F, backward=True)
    n0, i0 = ffn.swiglu_bwd.launches, ffn.swiglu_bwd.instances[inst]
    dgt, dw, db = ffn.swiglu_bwd(x, *ws, gh)
    rdgt, rdw, rdb = ffn.swiglu_bwd_reference(x, *ws, gh)
    assert ffn.swiglu_bwd.launches - n0 == 1
    assert ffn.swiglu_bwd.instances[inst] - i0 == 1
    if dtype == torch.float32:
        assert _rel(dgt, rdgt) <= 1e-5
    else:
        assert _err(dgt, rdgt) <= _ulp(rdgt)
    assert _rel(dw, rdw) <= (1e-4 if dtype == torch.float32 else 2.0 ** -7)
    assert _rel(db, rdb) <= 1e-4


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("M,E,F", [(16384, 768, 3072), (1000, 72, 200), (5, 70, 99)])
def test_swiglu_bwd_is_deterministic(gen, dtype, M, E, F):
    """No atomics: two backward calls on the same inputs give bit-equal
    [dg | dt], dW and db (the mma instance sums its weight grad's row
    slices and the bias grads' row tiles in a fixed order)."""
    x, ws = _swiglu_operands(gen, dtype, M, E, F)
    gh = torch.randn(M, F, generator=gen, device="cuda").to(dtype)
    first = ffn.swiglu_bwd(x, *ws, gh)
    second = ffn.swiglu_bwd(x, *ws, gh)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_swiglu_bounds_reject_planted_faults(gen):
    """The bounds the SwiGLU tests hold the tensor-core instances to see a
    wrong tile: the columns past F/2 of one 128-row tile zeroed, in the
    forward's output and in the backward's [dg | dt], fail them."""
    M, E, F = 16384, 768, 3072
    x, ws = _swiglu_operands(gen, torch.bfloat16, M, E, F)
    for m in (8, 128, M):
        got = ffn.fused_swiglu(x[:m], *ws)
        ref = ffn.swiglu_reference(x[:m], *ws)
        assert _err(got, ref) <= _ulp(ref)
        bad = got.clone()
        bad[:128, F // 2:] = 0
        assert _err(bad, ref) > _ulp(ref), m
    gh = torch.randn(M, F, generator=gen, device="cuda").to(torch.bfloat16)
    dgt, _, _ = ffn.swiglu_bwd(x, *ws, gh)
    rdgt, _, _ = ffn.swiglu_bwd_reference(x, *ws, gh)
    assert _err(dgt, rdgt) <= _ulp(rdgt)
    bad = dgt.clone()
    bad[128:256, F // 2:F] = 0
    assert _err(bad, rdgt) > _ulp(rdgt)


def test_train_step_on_the_card_matches_the_cpu(gen):
    """One fp32 step of a 2-layer diff model at recipe width: the card
    (kernels) against the CPU (plain versions), loss, every gradient
    and the updated params."""
    cfg = ModelConfig(model="diff", n_layer=2, vocab_size=512, block_size=128,
                      compute_dtype="float32")
    tcfg = TrainConfig(model=cfg, vocab_size=512, micro_batch_size=4,
                       warmup_iters=0, learning_rate=1e-3, sampler="replacement")
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(4)
    params = init_model(cpu_gen, cfg)
    idx = torch.randint(0, 512, (1, 4, 129), generator=cpu_gen)
    batch = {"x": idx[..., :-1], "y": idx[..., 1:]}
    out = {}
    for dev in ("cuda", "cpu"):
        state = train_state(params, tcfg, dev)
        p = state["params"]
        _, loss = model_forward(p, batch["x"][0].to(dev), cfg,
                                targets=batch["y"][0].to(dev))
        grads = torch.autograd.grad(loss, leaves(p))
        state, m = make_train_step(tcfg)(state, {k: t.to(dev) for k, t in batch.items()})
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads],
                    [t.detach().cpu() for t in leaves(state["params"])], m)
    (lc, gc, pc, mc), (lh, gh, ph, mh) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-5 and abs(mc["grad_norm"] - mh["grad_norm"]) <= 1e-4 * mh["grad_norm"]
    for a, b in zip(gc, gh):
        assert _rel(a, b) <= 1e-3
    # Adam's first step moves a param by lr * g / (|g| + eps): where g is
    # ~0 its sign, and so the step, can differ between two fp32 sum
    # orders; anywhere else the updates agree to fp32 rounding
    for a, b in zip(pc, ph):
        assert _err(a, b) <= 2 * tcfg.learning_rate
        assert float((a - b).abs().mean()) <= 1e-6


# ---------------------------------------------------------------------------
# head-major attention kernels K1-K4 (csrc/flash_bh_fwd.cu,
# csrc/flash_bh_bwd_dq.cu, csrc/flash_bh_bwd_dkv.cu,
# csrc/flash_bh_bwd_fused.cu, csrc/flash_bh.cu).
# The plain forward runs the kernel's online softmax over the same 32-key
# tiles, so p is rounded against the same running max on both sides; at
# rate 0.5 half of every map is dropped, so a keep mask that differs by
# one bit shows.
# ---------------------------------------------------------------------------


def _bh_operands(gen, dtype, S, B, T, H, d, dv):
    BH = B * H
    q, k = (torch.randn(BH, S, T, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    v = torch.randn(BH, T, dv, generator=gen, device="cuda").to(dtype)
    g = torch.randn(BH, T, dv, generator=gen, device="cuda").to(dtype)
    c = torch.randn(S, H, generator=gen, device="cuda") * 0.5
    c[0] = 1.0
    delta = torch.randn(BH, S, T, generator=gen, device="cuda")
    return q, k, v, g, c, delta


def _check_bh(gen, dtype, S, B, T, H, d, dv, rate, kernels):
    q, k, v, g, c, delta = _bh_operands(gen, dtype, S, B, T, H, d, dv)
    words = (0x51F00D, 0x2A7E11) if rate > 0 else (0, 0)
    out, o_all, lse = flash.flash_bh_fwd(q, k, v, c, H, rate, words, True)
    r_out, r_oall, r_lse = flash.bh_attention_fwd_reference(q, k, v, c, rate, words)
    assert flash.flash_bh_fwd(q, k, v, c, H, rate, words, False)[1] is None
    bwd = (q, k, v, g, r_lse, delta, c, H, rate, words)
    got = {}
    if "dq" in kernels:
        got["dq"] = (flash.flash_bh_bwd_dq(*bwd),)
    if "dkv" in kernels:
        got["dkv"] = flash.flash_bh_bwd_dkv(*bwd)
    if "fused" in kernels:
        got["fused"] = flash.flash_bh_bwd_fused(*bwd)
    rq, rk, rv = flash.bh_attention_bwd_reference(q, k, v, g, r_lse, delta, c,
                                                  rate, words)
    refs = {"dq": (rq,), "dkv": (rk, rv), "fused": (rq, rk, rv)}
    # each query row of out/o_all/dq and key row of dk/dv against its own
    # scale (testing.py)
    assert max(testing.attention_fwd_ratios(out, o_all, r_out, r_oall,
                                            flash._coeffs_bh(c, B * H))) <= 1.0
    assert _err(lse, r_lse) <= 1e-5 * float(r_lse.abs().max())
    for name, ts in got.items():
        for a, b in zip(ts, refs[name]):
            assert testing.grad_ratio(a, b) <= 1.0, name


@pytest.mark.parametrize("rate", [0.0, 0.5], ids=["p0", "p05"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("S,B,T,H,d,dv", [
    (1, 2, 64, 2, 96, 96), (2, 1, 64, 2, 96, 192), (4, 1, 64, 2, 96, 192),
    (1, 1, 520, 2, 96, 96), (2, 1, 520, 2, 96, 192), (4, 1, 520, 1, 96, 192),
    (2, 1, 2048, 2, 96, 192), (3, 2, 45, 3, 40, 80),
    (5, 1, 520, 2, 96, 192), (6, 1, 64, 1, 96, 192), (9, 1, 100, 1, 40, 80),
])
def test_flash_bh_kernels_match_plain(gen, dtype, S, B, T, H, d, dv, rate):
    """K1 (forward), K2 (dq), K3 (dk/dv) and K4 (fused backward) against
    the plain head-major versions, at every route's kernels; S > 4 takes
    more than one pass over the streams (at most four a pass)."""
    n0 = [fn.launches for fn in flash.BH_WRAPPERS]
    _check_bh(gen, dtype, S, B, T, H, d, dv, rate, ("dq", "dkv", "fused"))
    assert [fn.launches - n for fn, n in zip(flash.BH_WRAPPERS, n0)] == [2, 1, 1, 1]


@pytest.mark.parametrize("rate", [0.0, 0.5], ids=["p0", "p05"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_flash_bh_kernels_match_plain_at_8192(gen, dtype, rate):
    """K1-K3 at T = 8192, the tiled route of the diff model (K4 serves
    only the fused route, S * T^2 <= 2 * 512^2)."""
    assert flash.fwd_route(8192) == "tiled" and flash.bwd_route(2, 8192) == "tiled"
    _check_bh(gen, dtype, 2, 1, 8192, 1, 96, 192, rate, ("dq", "dkv"))


# K1's bf16 tensor-core instances (csrc/flash_bh_fwd.cu): one per padded
# dv (64/128/192/256) and d (64/96/128), aligned or ring, 16-byte or 2-byte
# loads; T off the 64-row block grid and past 4096; held row by row to the
# plain forward, lse to 1e-5, and two launches bit for bit.
K1_WIDTHS = [(d, dv) for d in (64, 96, 128) for dv in (64, 96, 192, 256)] + [
    (100, 96), (40, 80)]  # the 2-byte-load instances


def _check_k1(gen, S, B, T, H, d, dv, rate, off=None):
    q, k, v, _, c, _ = _bh_operands(gen, torch.bfloat16, S, B, T, H, d, dv)
    words = (0x51F00D, 0x2A7E11) if rate > 0 else (0, 0)
    if off is None:
        got = flash.flash_bh_fwd(q, k, v, c, H, rate, words, True)
        again = flash.flash_bh_fwd(q, k, v, c, H, rate, words, True)
        r_out, r_oall, r_lse = flash.bh_attention_fwd_reference(q, k, v, c, rate, words)
        assert max(testing.attention_fwd_ratios(got[0], got[1], r_out, r_oall,
                                                flash._coeffs_bh(c, B * H))) <= 1.0
        assert torch.equal(flash.flash_bh_fwd(q, k, v, c, H, rate, words, False)[0],
                           got[0])  # the eval variant
        o_all, lse = got[1:]
    else:
        got = o_all, lse = flash.flash_chunk_fwd(q, k, v, off, rate, words)
        again = flash.flash_chunk_fwd(q, k, v, off, rate, words)
        _, r_oall, r_lse = flash.bh_attention_fwd_reference(q, k, v, None, rate, words,
                                                            off)
        assert testing.row_ratio(o_all, r_oall, testing.BF16_ROW,
                                 testing.BF16_FLOOR) <= 1.0
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    masked = r_lse < -1e29
    assert torch.equal(lse[masked], r_lse[masked])
    live = ~masked
    if live.any():
        assert _err(lse[live], r_lse[live]) <= 1e-5 * float(r_lse[live].abs().max())


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p01"])
@pytest.mark.parametrize("S", [1, 2, 4, 5])
@pytest.mark.parametrize("d,dv", K1_WIDTHS)
def test_k1_bf16_instances_match_plain(gen, d, dv, S, rate):
    """Every bf16 K1 instance of the combined forward at T 100 and 520
    (off the 64-row grid), S 1 to 5 streams."""
    for T in (100, 520):
        _check_k1(gen, S, 1, T, 2, d, dv, rate)


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p01"])
@pytest.mark.parametrize("mult,extra", [(1, 0), (0, 0), (-1, 0), (0, 40), (0, -24)])
@pytest.mark.parametrize("d,dv", [(96, 192), (128, 256), (64, 64), (100, 96)])
def test_k1_bf16_ring_instances_match_plain(gen, d, dv, mult, extra, rate):
    """The ring chunk's bf16 K1 instances at offsets +T, 0, -T and off the
    tile grid (+40, -24), T 100 and 520."""
    for T in (100, 520):
        _check_k1(gen, 2, 1, T, 2, d, dv, rate, mult * T + extra)


@pytest.mark.parametrize("off", [None, 4160, 0, -4160], ids=["aligned", "+T", "0", "-T"])
def test_k1_bf16_past_4096_matches_plain(gen, off):
    """Past 4096 rows (the tiled routes) at the widest instance, dropout 0.1."""
    _check_k1(gen, 2, 1, 4160, 1, 128, 256, 0.1, off)


# K2 and K3's bf16 tensor-core instances (csrc/flash_bh_bwd_dq.cu,
# csrc/flash_bh_bwd_dkv.cu): d padded to 64/96/128 (two streams a block at
# d <= 96 in the factored form) and dv to 64/128/192/256, factored or ring,
# 16-byte or 2-byte loads; dv with every stream's K tile held or staged
# per step (S 4 and 5 at d 128); T off the 64-row grid and past 4096; each
# result held row by row to the plain backward, and two launches bit for
# bit.


def _check_k2k3(gen, S, B, T, H, d, dv, rate, off=None):
    q, k, v, g, c, delta = _bh_operands(gen, torch.bfloat16, S, B, T, H, d, dv)
    words = (0x51F00D, 0x2A7E11) if rate > 0 else (0, 0)
    if off is None:
        _, _, lse = flash.bh_attention_fwd_reference(q, k, v, c, rate, words)
        args = (q, k, v, g, lse, delta, c, H, rate, words)
        dq_fn, dkv_fn = flash.flash_bh_bwd_dq, flash.flash_bh_bwd_dkv
        ref = flash.bh_attention_bwd_reference(*args[:7], rate, words)
    else:
        g = torch.randn(B * H, S, T, dv, generator=gen, device="cuda").to(torch.bfloat16)
        _, _, lse = flash.bh_attention_fwd_reference(q, k, v, None, rate, words, off)
        args = (q, k, v, g, lse, delta, off, rate, words)
        dq_fn, dkv_fn = flash.flash_chunk_bwd_dq, flash.flash_chunk_bwd_dkv
        ref = flash.bh_attention_bwd_reference(q, k, v, g, lse, delta, None, rate,
                                               words, off)
    got = (dq_fn(*args), *dkv_fn(*args))
    again = (dq_fn(*args), *dkv_fn(*args))
    for name, a, b, a2 in zip(("dq", "dk", "dv"), got, ref, again):
        assert testing.grad_ratio(a, b) <= 1.0, name
        assert torch.equal(a, a2), name


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p01"])
@pytest.mark.parametrize("S", [1, 2, 4, 5])
@pytest.mark.parametrize("d,dv", K1_WIDTHS)
def test_k2k3_bf16_instances_match_plain(gen, d, dv, S, rate):
    """Every bf16 K2 and K3 instance of the factored backward at T 100 and
    520 (off the 64-row grid), S 1 to 5 streams."""
    for T in (100, 520):
        _check_k2k3(gen, S, 1, T, 2, d, dv, rate)


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["p0", "p01"])
@pytest.mark.parametrize("mult,extra", [(1, 0), (0, 0), (-1, 0), (0, 40), (0, -24)])
@pytest.mark.parametrize("d,dv", [(96, 192), (128, 256), (64, 64), (100, 96), (40, 80)])
def test_k2k3_bf16_ring_instances_match_plain(gen, d, dv, mult, extra, rate):
    """The ring chunk's bf16 K2 and K3 instances (per-stream cotangents) at
    offsets +T, 0, -T and off the tile grid (+40, -24), T 100 and 520."""
    for T in (100, 520):
        _check_k2k3(gen, 2, 1, T, 2, d, dv, rate, mult * T + extra)


@pytest.mark.parametrize("off", [None, 4160, 0, -4160], ids=["aligned", "+T", "0", "-T"])
def test_k2k3_bf16_past_4096_matches_plain(gen, off):
    """Past 4096 rows (the tiled routes) at the widest instances, dropout
    0.1."""
    _check_k2k3(gen, 2, 1, 4160, 1, 128, 256, 0.1, off)


# K4's bf16 tensor-core instances (csrc/flash_bh_bwd_fused.cu): S 1 and 2
# (one stream in the dk warps, or S + 1 warp groups), d padded to
# 64/96/128 and dv to 64/128/192, widths in multiples of 8 off the 16
# grid; T off the 64-key grid (45, 100, 520) and 2048, which the wrapper
# takes directly (the route sends it to K2 + K3); each result held row by
# row to the plain backward. Two launches on the same inputs: dk and dv
# bit-equal; dq, whose key tiles' partials meet in an order that changes
# from launch to launch, within 2^-7 of each row's max |dq|.
K4_WIDTHS = [(d, dv) for d in (64, 96, 128) for dv in (64, 128, 192)] + [
    (96, 96), (40, 80)]


def _check_k4(gen, S, T, d, dv, rate):
    assert flash.fused_bwd_instance(S, d, dv, torch.bfloat16) == "mma"
    q, k, v, g, c, delta = _bh_operands(gen, torch.bfloat16, S, 1, T, 2, d, dv)
    words = (0x51F00D, 0x2A7E11) if rate > 0 else (0, 0)
    _, _, lse = flash.bh_attention_fwd_reference(q, k, v, c, rate, words)
    args = (q, k, v, g, lse, delta, c, 2, rate, words)
    n0 = flash.flash_bh_bwd_fused.launches
    got = flash.flash_bh_bwd_fused(*args)
    again = flash.flash_bh_bwd_fused(*args)
    assert flash.flash_bh_bwd_fused.launches - n0 == 2
    ref = flash.bh_attention_bwd_reference(*args[:7], rate, words)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert testing.grad_ratio(a, b) <= 1.0, name
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    assert testing.row_ratio(again[0], got[0], 2.0 ** -7, 0.0) <= 1.0


@pytest.mark.parametrize("rate", [0.0, 0.5], ids=["p0", "p05"])
@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("d,dv", K4_WIDTHS)
def test_k4_bf16_instances_match_plain(gen, d, dv, S, rate):
    """Every bf16 tensor-core K4 instance at T 45, 100, 520 and 2048."""
    for T in (45, 100, 520, 2048):
        _check_k4(gen, S, T, d, dv, rate)


def test_fused_backward_trains_like_the_split_route_in_bf16(gen, monkeypatch):
    """A 2-layer diff model at recipe width in bf16, T 512, attention (and
    residual, FFN) dropout 0.1: loss and every gradient with the backward
    on the fused route (K4's tensor-core instance) and on the split route
    (K2 + K3: ``_FUSED_BWD_BUDGET`` patched to 0), both on the card. The
    forward runs the same kernels, so the losses agree to fp32 rounding;
    the two backwards round p, ds and the combined map at the same points
    from fp32 sums in other orders, so a bf16 rounding may flip on either
    side: each is within 2^-6 of its rows' scale of the plain backward
    (``testing.py``), so within 2^-5 of each other, and the model's bf16
    backward carries that linearly into each leaf, held within 2^-5 of
    its max |value|."""
    from differential_transformer_replication_tpu_torch.train.optim import unflatten

    cfg = ModelConfig(model="diff", n_layer=2, vocab_size=512, block_size=512,
                      dropout=0.1, compute_dtype="bfloat16")
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(8)
    params = init_model(cpu_gen, cfg)
    idx = torch.randint(0, 512, (2, 513), generator=cpu_gen).to("cuda")
    out = {}
    for route, budget in (("fused", flash._FUSED_BWD_BUDGET), ("split", 0)):
        monkeypatch.setattr(flash, "_FUSED_BWD_BUDGET", budget)
        flash.reset_bh_counters()
        p = [t.to("cuda").requires_grad_(True) for t in leaves(params)]
        _, loss = model_forward(unflatten(params, p), idx[:, :-1], cfg,
                                targets=idx[:, 1:], seed=5)
        out[route] = (float(loss.detach()), torch.autograd.grad(loss, p))
        routes = {fn.__name__: dict(fn.routes) for fn in flash.BH_WRAPPERS[1:]
                  if fn.routes}
        want = ({"flash_bh_bwd_fused": {"fused": 2}} if route == "fused" else
                {"flash_bh_bwd_dq": {"split": 2}, "flash_bh_bwd_dkv": {"split": 2}})
        assert routes == want
    (lf, gf), (ls, gs) = out["fused"], out["split"]
    assert abs(lf - ls) <= 1e-6 * abs(ls)
    for a, b in zip(gf, gs):
        assert _err(a, b) <= 2.0 ** -5 * float(b.abs().max())


def test_flash_bh_routes_count_their_launches(gen):
    """The entry picks K4 on the fused route and K2 + K3 on the split one,
    and counts each launch under its route."""
    flash.reset_bh_counters()
    for S, T in ((2, 512), (4, 512), (2, 2048)):
        q, k, v, g, c, _ = _bh_operands(gen, torch.bfloat16, S, 1, T, 2, 96, 192)
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        out = flash.flash_bh(q, k, v, c, torch.tensor([[7.0, 9.0]]), 2, 0.1)
        out.backward(g)
    assert dict(flash.flash_bh_fwd.routes) == {"resident": 3}
    assert dict(flash.flash_bh_bwd_fused.routes) == {"fused": 1}
    assert dict(flash.flash_bh_bwd_dq.routes) == {"split": 2}
    assert dict(flash.flash_bh_bwd_dkv.routes) == {"split": 2}


def test_head_major_train_grads_on_the_card_match_the_cpu(gen):
    """Loss and every gradient of a 2-layer diff model at recipe width in
    fp32 at T = 640 (past the token-major envelope: the head-major
    route, dropout 0), the card (kernels) against the CPU (plain)."""
    cfg = ModelConfig(model="diff", n_layer=2, vocab_size=512, block_size=640,
                      compute_dtype="float32")
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(6)
    params = init_model(cpu_gen, cfg)
    idx = torch.randint(0, 512, (2, 641), generator=cpu_gen)
    flash.reset_bh_counters()
    out = {}
    for dev in ("cuda", "cpu"):
        p = [t.to(dev).requires_grad_(True) for t in leaves(params)]
        from differential_transformer_replication_tpu_torch.train.optim import unflatten
        _, loss = model_forward(unflatten(params, p), idx[:, :-1].to(dev), cfg,
                                targets=idx[:, 1:].to(dev))
        out[dev] = (float(loss.detach()),
                    [t.cpu() for t in torch.autograd.grad(loss, p)])
    assert flash.flash_bh_fwd.launches == 2 and flash.flash_bh_bwd_dq.launches == 2
    (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-4
    for a, b in zip(gc, gh):
        assert _rel(a, b) <= 1e-3


def test_ndiff_past_four_streams_trains_on_the_card_like_the_cpu(gen):
    """ndiff with five terms (S = 5: past the token-major envelope, two
    passes over the streams in K1 and K4, the fused route), 2 layers at
    recipe width in fp32, dropout 0: loss and every gradient, the card
    against the CPU."""
    from differential_transformer_replication_tpu_torch.train.optim import unflatten

    cfg = ModelConfig(model="ndiff", n_terms=5, n_layer=2, vocab_size=512,
                      block_size=128, compute_dtype="float32")
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(7)
    params = init_model(cpu_gen, cfg)
    idx = torch.randint(0, 512, (2, 129), generator=cpu_gen)
    flash.reset_bh_counters()
    out = {}
    for dev in ("cuda", "cpu"):
        p = [t.to(dev).requires_grad_(True) for t in leaves(params)]
        _, loss = model_forward(unflatten(params, p), idx[:, :-1].to(dev), cfg,
                                targets=idx[:, 1:].to(dev))
        out[dev] = (float(loss.detach()),
                    [t.cpu() for t in torch.autograd.grad(loss, p)])
    assert flash.flash_bh_fwd.launches == 2 and flash.flash_bh_bwd_fused.launches == 2
    (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-4
    for a, b in zip(gc, gh):
        assert _rel(a, b) <= 1e-3


# ---------------------------------------------------------------------------
# the ring chunk's kernel modes: K1 without the combine, K2/K3 with one
# cotangent per stream, under a causal offset (csrc/flash_bh*.cu), against
# the plain versions row by row; and the ring's train step on the card
# ---------------------------------------------------------------------------


def _check_chunk(gen, dtype, S, B, T, H, d, dv, off, rate):
    BH = B * H
    q, k = (torch.randn(BH, S, T, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    v = torch.randn(BH, T, dv, generator=gen, device="cuda").to(dtype)
    do = torch.randn(BH, S, T, dv, generator=gen, device="cuda").to(dtype)
    delta = torch.randn(BH, S, T, generator=gen, device="cuda")
    words = (0x51F00D, 0x2A7E11) if rate > 0 else (0, 0)
    o_all, lse = flash.flash_chunk_fwd(q, k, v, off, rate, words)
    _, r_o, r_lse = flash.bh_attention_fwd_reference(q, k, v, None, rate, words, off)
    fwd = ((testing.FP32_FWD_ROW, testing.FP32_FWD_FLOOR) if dtype == torch.float32
           else (testing.BF16_ROW, testing.BF16_FLOOR))
    assert testing.row_ratio(o_all, r_o, *fwd) <= 1.0
    # rows with no visible key: lse exactly NEG_INF + log(1e-30) (-1e30 in
    # fp32) on both sides, o = 0; elsewhere the fp32 lse within 1e-5
    masked = r_lse < -1e29
    assert torch.isfinite(lse).all() and torch.equal(lse[masked], r_lse[masked])
    live = ~masked
    if live.any():
        assert _err(lse[live], r_lse[live]) <= 1e-5 * float(r_lse[live].abs().max())
    bwd = (q, k, v, do, r_lse, delta, off, rate, words)
    dq = flash.flash_chunk_bwd_dq(*bwd)
    dk, dv_ = flash.flash_chunk_bwd_dkv(*bwd)
    rq, rk, rv = flash.bh_attention_bwd_reference(q, k, v, do, r_lse, delta, None,
                                                  rate, words, off)
    for a, b in ((dq, rq), (dk, rk), (dv_, rv)):
        assert testing.grad_ratio(a, b) <= 1.0


@pytest.mark.parametrize("rate", [0.0, 0.5], ids=["p0", "p05"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("mult,extra", [(0, 0), (1, 0), (3, 0), (-1, 0), (0, 40),
                                        (0, -24)])
@pytest.mark.parametrize("S,B,T,H,d,dv", [
    (2, 1, 96, 2, 96, 192), (1, 2, 64, 2, 96, 96), (4, 1, 100, 1, 40, 80),
    (5, 1, 96, 1, 96, 192),
])
def test_flash_chunk_kernels_match_plain(gen, dtype, S, B, T, H, d, dv, mult,
                                         extra, rate):
    """K1 in the no-combine mode and K2/K3 with per-stream cotangents at
    offsets 0, +T, +3T, -T and two off the tile grid (+40: partly
    visible tiles; -24: rows with no visible key in a visited tile)."""
    n0 = [fn.launches for fn in flash.CHUNK_WRAPPERS]
    _check_chunk(gen, dtype, S, B, T, H, d, dv, mult * T + extra, rate)
    assert [fn.launches - n for fn, n in zip(flash.CHUNK_WRAPPERS, n0)] == [1, 1, 1]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("mult", [0, 1, -1])
def test_flash_chunk_kernels_match_plain_past_4096(gen, dtype, mult):
    """The chunk-tiled routes (T > 4096), diff width, dropout 0.1."""
    flash.reset_bh_counters()
    _check_chunk(gen, dtype, 2, 1, 4160, 1, 96, 192, mult * 4160, 0.1)
    assert dict(flash.flash_chunk_fwd.routes) == {"chunk-tiled": 1}
    assert dict(flash.flash_chunk_bwd_dkv.routes) == {"chunk-tiled": 1}


def test_chunk_row_bounds_reject_planted_faults(gen):
    """The kernel bounds above reject a kernel that ignores the offset or
    sums dv over one stream only (plain results with the fault planted)."""
    S, T, off = 2, 512, 256
    q, k = (torch.randn(2, S, T, 96, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    v = torch.randn(2, T, 192, generator=gen, device="cuda").to(torch.bfloat16)
    do = torch.randn(2, S, T, 192, generator=gen, device="cuda").to(torch.bfloat16)
    delta = torch.randn(2, S, T, generator=gen, device="cuda")
    _, r_o, r_lse = flash.bh_attention_fwd_reference(q, k, v, None, 0.1, (5, 7), off)
    _, f_o, _ = flash.bh_attention_fwd_reference(q, k, v, None, 0.1, (5, 7), 0)
    assert testing.row_ratio(f_o, r_o, testing.BF16_ROW, testing.BF16_FLOOR) > 1.0
    ref = flash.bh_attention_bwd_reference(q, k, v, do, r_lse, delta, None, 0.1,
                                           (5, 7), off)
    bad = flash.bh_attention_bwd_reference(q, k, v, do, r_lse, delta, None, 0.1,
                                           (5, 7), 0)
    assert min(testing.grad_ratio(a, b) for a, b in zip(bad, ref)) > 1.0
    one = do.clone()
    one[:, 1:] = 0
    bad_dv = flash.bh_attention_bwd_reference(q, k, v, one, r_lse, delta, None,
                                              0.1, (5, 7), off)[2]
    assert testing.grad_ratio(bad_dv, ref[2]) > 1.0


def test_ring_step_on_the_card_matches_the_single_card_step(gen, tmp_path):
    """One fp32 train step of a 2-layer diff model at recipe width, T 1024,
    micro-batch 2: two gloo ranks sharing the card (the ring through the
    chunk kernels) against the single-card head-major step on the same
    card, from the same params and batch; bounds as
    test_train_step_on_the_card_matches_the_cpu."""
    _ring_step_vs_single_card(tmp_path, 1024)


def test_ring_step_off_the_tile_grid_matches_the_single_card_step(gen, tmp_path):
    """As above at T 200: shards of 100 tokens, off the chunk kernels'
    32-row tile grid, with causal offsets of +-100 (the single-card step
    takes the token-major route at this length)."""
    _ring_step_vs_single_card(tmp_path, 200)


def _ring_step_vs_single_card(tmp_path, T):
    import json

    import numpy as np

    from torch_ring_worker import run_ranks

    P = 2
    mdict = dict(model="diff", n_layer=2, vocab_size=512, block_size=T,
                 compute_dtype="float32")
    tdict = dict(vocab_size=512, micro_batch_size=2, warmup_iters=0,
                 learning_rate=1e-3, sampler="replacement")
    cfg = ModelConfig(**mdict)
    tcfg = TrainConfig(model=cfg, **tdict)
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(9)
    params = init_model(cpu_gen, cfg)
    idx = torch.randint(0, 512, (1, 2, T + 1), generator=cpu_gen)
    batch = {"x": idx[..., :-1], "y": idx[..., 1:]}
    state = train_state(params, tcfg, "cuda")
    from differential_transformer_replication_tpu_torch.train.step import make_grad_fn
    loss, grads = make_grad_fn(tcfg)(state["params"], {k: t.cuda() for k, t in batch.items()})
    state, m = make_train_step(tcfg)(state, {k: t.cuda() for k, t in batch.items()})
    ref_p = [t.detach().cpu() for t in leaves(state["params"])]

    s0 = train_state(params, tcfg, "cpu")
    meta = {"model": mdict, "train": tdict, "count": 0, "step": 0,
            "guard": {"ema": 0.0, "good_steps": 0, "bad_streak": 0, "skipped": 0}}
    inputs = {"meta": np.array(json.dumps(meta)), "x": batch["x"].numpy(),
              "y": batch["y"].numpy(), "device": np.array("cuda")}
    for name, tree in (("p", s0["params"]), ("mu", s0["opt_state"]["mu"]),
                       ("nu", s0["opt_state"]["nu"])):
        inputs.update({f"{name}{i}": t.detach().numpy() for i, t in enumerate(leaves(tree))})
    outs = run_ranks("step", P, tmp_path, inputs, timeout=300)
    o = outs[0]
    assert abs(float(o["loss"]) - m["loss"]) <= 1e-5
    assert abs(float(o["grad_norm"]) - m["grad_norm"]) <= 1e-4 * m["grad_norm"]
    for i, (g, p) in enumerate(zip(grads, ref_p)):
        assert _rel(torch.from_numpy(o[f"g{i}"]), g.cpu()) <= 1e-3, i
        got = torch.from_numpy(o[f"p{i}"])
        assert _err(got, p) <= 2 * tcfg.learning_rate
        assert float((got - p).abs().mean()) <= 1e-6
        assert np.array_equal(outs[1][f"p{i}"], o[f"p{i}"]), i


def _train_cli(argv, **popen):
    import subprocess
    import sys
    from pathlib import Path

    return subprocess.Popen(
        [sys.executable, "-m", "differential_transformer_replication_tpu_torch.train",
         *argv], cwd=str(Path(__file__).resolve().parents[1]),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, **popen)


def test_killed_and_resumed_run_is_bit_equal_on_the_card(gen, tmp_path):
    """A 2-layer diff run at recipe width (bf16, T 512, vocab 12000, B 8,
    epoch sampler) through the command line: 8 uninterrupted steps
    against a run killed by SIGKILL once its step-4 checkpoint is
    certified, then resumed with ``--resume-from auto`` to 8. The train
    states end bit-equal (the same ``state.msgpack`` bytes) and every
    step's loss is equal."""
    import json
    import os
    import signal
    import time

    import numpy as np

    tokens = tmp_path / "t.npy"
    np.save(tokens, np.random.default_rng(0).integers(0, 12000, 6000).astype(np.int32))
    common = ["--model", "diff", "--tokens", str(tokens), "--device", "cuda",
              "--n-layer", "2", "--compute-dtype", "bfloat16",
              "--micro-batch-size", "8", "--max-iters", "8", "--eval-interval", "4",
              "--eval-iters", "1", "--log-interval", "1", "--warmup-iters", "2",
              "--ckpt-interval", "4"]

    def run(name, *extra):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        return _train_cli(common + ["--checkpoint-path", str(d / "best.ckpt"),
                                    "--metrics-path", str(d / "m.jsonl"), *extra])

    whole = run("a")
    out = whole.communicate(timeout=600)[0]
    assert whole.returncode == 0, out
    cut = run("b")
    manifest = tmp_path / "b" / "best.steps" / "step-00000004" / "manifest.json"
    deadline = time.time() + 600
    while not manifest.exists() and cut.poll() is None and time.time() < deadline:
        time.sleep(0.01)
    cut.send_signal(signal.SIGKILL)
    out = cut.communicate(timeout=60)[0]
    assert cut.returncode == -signal.SIGKILL, out
    resumed = run("b", "--resume-from", "auto")
    out = resumed.communicate(timeout=600)[0]
    assert resumed.returncode == 0 and "resuming from" in out, out

    def losses(name):
        recs = [json.loads(line) for line in open(tmp_path / name / "m.jsonl")]
        return [(r["iter"], r["loss"]) for r in recs if "loss" in r]

    a, b = dict(losses("a")), losses("b")
    assert sorted(a) == list(range(1, 9))
    assert all(a[i] == loss for i, loss in b) and {i for i, _ in b} == set(a)
    last = lambda n: open(os.path.join(tmp_path, n, "best.last.ckpt",  # noqa: E731
                                       "state.msgpack"), "rb").read()
    assert last("a") == last("b")


# ---------------------------------------------------------------------------
# generation: the two generators on the card against the CPU
# ---------------------------------------------------------------------------


def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("kind", ["control", "diff", "ndiff"])
@pytest.mark.parametrize("route", ["generate", "generate_cached"])
def test_generators_on_the_card_match_the_cpu(gen, monkeypatch, kind, route):
    """fp32, 2 layers, greedy: every step's logits on the card within
    1e-4 of the CPU's (the decode tests' bound), and the tokens equal up
    to the first step whose top-2 gap on the CPU is within that bound
    (past it the inputs differ). The windowed route runs past its window
    (30 + 40 > 64) and the cached one past block_size for the RoPE
    families; the kernels of each route launched on the card."""
    import importlib

    from differential_transformer_replication_tpu_torch.models import (
        generate,
        generate_cached,
    )

    pgen = importlib.import_module(
        "differential_transformer_replication_tpu_torch.models.generate")
    cfg = ModelConfig(model=kind, vocab_size=97, n_embd=64, n_head=2,
                      n_layer=2, block_size=64, n_terms=3,
                      compute_dtype="float32")
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(3)
    params = init_model(cpu_gen, cfg)
    fn = generate if route == "generate" else generate_cached
    T0, new = 30, (30 if (route, kind) == ("generate_cached", "diff") else 40)
    idx = torch.tensor([[(7 * i + j) % 97 for j in range(T0)] for i in range(2)])
    logs = []
    real = pgen.sample_token

    def spy(g, logits, temperature=1.0, top_k=None):
        logs.append(logits.detach().float().cpu())
        return real(g, logits, temperature, top_k)

    monkeypatch.setattr(pgen, "sample_token", spy)
    want = fn(params, idx, cfg, new, 0, temperature=0.0)
    cpu_logs = logs[:]
    logs.clear()
    wrappers = (fnr.fused_norm, ffn.fused_swiglu,
                dat.decode_attention if route == "generate_cached"
                else flash.flash_tm_fwd)
    before = [w.launches for w in wrappers]
    got = fn(_on(params, "cuda"), idx.cuda(), cfg, new, 0, temperature=0.0).cpu()
    assert all(w.launches > n for w, n in zip(wrappers, before))
    assert len(logs) == len(cpu_logs) == new
    for step, (a, b) in enumerate(zip(cpu_logs, logs)):
        assert _err(a, b) <= 1e-4, (step, _err(a, b))
        if not torch.equal(want[:, T0 + step], got[:, T0 + step]):
            top = a.topk(2, dim=-1).values
            assert float((top[:, 0] - top[:, 1]).min()) <= 1e-4, step
            break


# ---------------------------------------------------------------------------
# remat and the chunked loss on the card (models/common.py:remat_block,
# ops/losses.py:fused_linear_cross_entropy)
# ---------------------------------------------------------------------------


def _bf16_loss_and_grads(params, cfg, idx, seed=None):
    from differential_transformer_replication_tpu_torch.train.optim import unflatten

    p = [t.to("cuda").requires_grad_(True) for t in leaves(params)]
    _, loss = model_forward(unflatten(params, p), idx[:, :-1], cfg,
                            targets=idx[:, 1:], seed=seed)
    return loss.detach(), torch.autograd.grad(loss, p)


@pytest.mark.parametrize("policy", ["nothing", "dots", "everything"])
@pytest.mark.parametrize("route,T,rate", [("tm", 512, 0.0), ("split", 2048, 0.1)],
                         ids=["D-E", "K1-K3"])
def test_remat_is_bit_equal_to_unremat_on_the_card(gen, route, T, rate, policy):
    """A 2-layer diff model at recipe width in bf16: loss and every
    gradient under remat equal the unremat step's bit for bit, through
    kernels D/E (T 512, dropout 0) and through K1-K3 (T 2048, dropout
    0.1: K1 resident, K2 + K3 split; every mask redrawn in the recompute).
    The recompute launches each block's forward kernels once more under
    every policy but ``everything``; the backward kernels run once."""
    cfg = ModelConfig(model="diff", n_layer=2, vocab_size=512, block_size=T,
                      dropout=rate, compute_dtype="bfloat16")
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(10)
    params = init_model(cpu_gen, cfg)
    idx = torch.randint(0, 512, (2, T + 1), generator=cpu_gen).to("cuda")
    seed = 11 if rate else None
    fwd = flash.flash_tm_fwd if route == "tm" else flash.flash_bh_fwd
    bwd = flash.flash_tm_bwd if route == "tm" else flash.flash_bh_bwd_dq
    counted = (fwd, bwd, ffn.fused_swiglu, ffn.swiglu_bwd, fnr.fused_add_norm)
    runs = {}
    for remat in (False, True):
        for fn in counted:
            fn.launches = 0
        flash.reset_bh_counters()
        runs[remat] = (_bf16_loss_and_grads(
            params, cfg.replace(remat=remat, remat_policy=policy), idx, seed),
            [fn.launches for fn in counted])
    ((l0, g0), n0), ((l1, g1), n1) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    again = 1 if policy == "everything" else 2
    assert n0 == [2, 2, 2, 2, 2]
    assert n1 == [2 * again, 2, 2 * again, 2, 2 * again]


def test_chunked_loss_on_the_card_is_within_its_bound_of_the_dense_loss(gen):
    """A 2-layer diff model at recipe width in bf16, T 512, micro-batch 8,
    vocab 12000: the chunked loss (chunks of 1024 positions) against the
    dense loss. The logits are the same bf16 products, so the losses
    agree to fp32 sums in another order (1e-5 of the loss). Each chunk's
    lm-head dW is rounded to bf16 before the fp32 sum (the dense dW is an
    fp32 product), and ``d`` comes from ``softmax`` in place of ``exp(x -
    lse)``, so a bf16 rounding may flip on either side: every gradient
    within 2^-5 of its max |value|, as the fused and split backwards are
    held to each other."""
    cfg = ModelConfig(model="diff", n_layer=2, vocab_size=12000, block_size=512,
                      compute_dtype="bfloat16")
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(12)
    params = init_model(cpu_gen, cfg)
    idx = torch.randint(0, 12000, (8, 513), generator=cpu_gen).to("cuda")
    ld, gd = _bf16_loss_and_grads(params, cfg, idx)
    lc, gc = _bf16_loss_and_grads(params, cfg.replace(loss_chunk=1024), idx)
    assert abs(float(lc) - float(ld)) <= 1e-5 * abs(float(ld))
    for a, b in zip(gc, gd):
        assert _err(a, b) <= 2.0 ** -5 * float(b.abs().max())


def test_logit_pipeline_and_logprob_echo_on_the_card_equal_the_cpu(gen):
    """The request path's plain PyTorch on the card: ``apply_logit_pipeline``
    bit for bit against the CPU on the same fp32 logits (elementwise ops
    only), and the sampler's greedy tokens and logprob echo through it
    (ids exactly, logprobs within 1e-5: the log-softmax sums in another
    order)."""
    from differential_transformer_replication_tpu_torch.models.decode import (
        apply_logit_pipeline,
    )
    from differential_transformer_replication_tpu_torch.serving.engine import (
        Pipe,
        sample_tokens,
    )
    from differential_transformer_replication_tpu_torch.serving.request import (
        SamplingParams,
    )

    n, V = 8, 12000
    cpu = torch.Generator().manual_seed(3)
    logits = torch.randn(n, V, generator=cpu) * 4
    allowed = torch.rand(n, V, generator=cpu) > 0.5
    allowed[:4] = True
    counts = torch.randint(0, 3, (n, V), generator=cpu, dtype=torch.int32)
    pens = torch.tensor([[1.0, 0.0, 0.0], [1.3, 0.0, 0.0], [1.0, 2.0, 0.0],
                         [1.0, 0.0, 0.5]] * 2)
    args = (allowed, counts, pens[:, 0].contiguous(), pens[:, 1].contiguous(),
            pens[:, 2].contiguous())
    want = apply_logit_pipeline(logits, *args)
    got = apply_logit_pipeline(logits.cuda(), *(a.cuda() for a in args))
    assert torch.equal(got.cpu(), want)
    params = [SamplingParams(temperature=0.0, logprobs=5, top_k=k or None)
              for k in (0, 0, 7, 0, 0, 3, 0, 0)]
    outs = {}
    for dev in ("cpu", "cuda"):
        pipe = Pipe(allowed.to(dev), counts.to(dev), pens.to(dev))
        outs[dev] = sample_tokens(logits.to(dev), params, [0] * n, pipe=pipe, lp_k=5)
    (tc, okc, _, lpc), (tg, okg, _, lpg) = outs["cpu"], outs["cuda"]
    assert tc == tg and okc == okg
    assert (lpc[1] == lpg[1]).all()
    # top-k rows echo -inf past their k: equal infinities pass
    np.testing.assert_allclose(lpg[0], lpc[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(lpg[2], lpc[2], atol=1e-5, rtol=0)


def test_sampled_verify_rows_on_the_card_draw_by_the_host_rule(gen):
    """``spec_accept``'s sampled rows decide on the card without a copy
    to the host (every candidate correction drawn, the accepted count
    selecting one). Held against the rule step by step on the same card
    generators: each draft's uniform against its probability, stop at
    the first rejection, the correction's Gumbel-max draw from that row
    with the rejected draft masked out. Tokens exactly; the echo's
    chosen logprob against the log-softmax of the processed surface at
    each emitted token, within 1e-5."""
    from differential_transformer_replication_tpu_torch.serving.engine import (
        Pipe,
        _gumbel_argmax,
        _piped,
        _processed,
        _uniform,
        accept_seed,
        draw_seed,
        spec_accept,
    )
    from differential_transformer_replication_tpu_torch.serving.request import (
        SamplingParams,
    )

    n, L, V = 6, 5, 12000
    cpu = torch.Generator().manual_seed(5)
    logits = torch.randn(n, L, V, generator=cpu)
    drafts = [torch.randint(0, V, (dl,), generator=cpu).tolist()
              for dl in (4, 4, 3, 0, 4, 2)]
    # each draft lifted by a random margin: some accepted, some not
    for i, d in enumerate(drafts):
        for j, tok in enumerate(d):
            logits[i, j, tok] += 6 + 10 * torch.rand(1, generator=cpu).item()
    allowed = torch.rand(n, L, V, generator=cpu) > 0.3
    for i, d in enumerate(drafts):
        allowed[i, torch.arange(len(d)), torch.as_tensor(d, dtype=torch.long)] = True
    pipe = Pipe(allowed.cuda(),
                torch.randint(0, 3, (n, V), generator=cpu, dtype=torch.int32).cuda(),
                torch.tensor([[1.2, 0.5, 0.1]] * n).cuda())
    params = [SamplingParams(temperature=t, top_k=k, seed=s, logprobs=4)
              for t, k, s in ((0.8, None, 1), (1.1, 40, 2), (1.3, None, 3),
                              (0.9, 8, 4), (0.0, None, 0), (0.7, None, 6))]
    steps = [3, 0, 17, 5, 2, 9]
    x = logits.cuda()
    got, ok, _, (chosen, _, _) = spec_accept(x, drafts, params, steps, pipe=pipe,
                                             lp_k=4)
    dpad = torch.as_tensor([d + [0] * (L - len(d)) for d in drafts], device="cuda")
    proc, _ = _processed(_piped(x, pipe, dpad[:, :L - 1]), params)
    lsm = torch.log_softmax(proc, dim=-1).cpu()
    accepted = 0
    for i, (d, p, t0, out) in enumerate(zip(drafts, params, steps, got)):
        if p.temperature <= 0:
            continue
        a = 0
        probs = torch.softmax(proc[i, :len(d)], dim=-1)
        while a < len(d):
            u = _uniform(1, accept_seed(p.seed, t0 + a), "cuda")
            if not bool(u < probs[a, d[a]]):
                break
            a += 1
        row = proc[i, a].clone()
        if a < len(d):
            row[d[a]] = -float("inf")
        assert out == d[:a] + [int(_gumbel_argmax(row, draw_seed(p.seed, t0 + a)))]
        accepted += a
        for j, tok in enumerate(out):
            assert abs(float(chosen[i, j]) - float(lsm[i, j, tok])) <= 1e-5
    assert all(ok) and accepted > 0


def test_self_drafter_proposals_equal_the_targets_greedy_decode(gen):
    """A self drafter (the target's own params) on the card, bf16: from
    the state after the prompt and the first generated token, its k
    proposals are the target's next k greedy tokens, bit for bit (the
    same prefill chunks and the same pool-step shapes)."""
    from differential_transformer_replication_tpu_torch.serving.spec import (
        DraftSlot,
        ModelDrafter,
    )

    cfg = ModelConfig(model="diff", vocab_size=512, n_embd=256, n_head=2,
                      n_layer=2, block_size=128, compute_dtype="bfloat16")
    params = init_model(gen, cfg)
    prompt = torch.randint(0, 512, (45,), generator=torch.Generator().manual_seed(1),
                           ).tolist()
    k = 6
    engine = ServingEngine(params, cfg, ServingConfig(num_slots=4), device="cuda")
    out = engine.generate([prompt], max_new_tokens=k + 1, temperature=0.0)[0].tokens
    drafter = ModelDrafter(params, cfg, 4, cfg.block_size, draft_len=k, device="cuda")
    hist = prompt + out[:1]
    props = drafter.propose_all([DraftSlot(0, hist, len(hist) - 1, k)])
    assert props == {0: out[1:]}
    assert drafter.rounds_total == k and drafter.stats()["drafter_crashes_total"] == 0


def test_int8_weight_quantization_on_the_card_equals_the_cpu(gen):
    """``quantize_params_int8`` on the card gives the CPU's weights bit for
    bit (the per-channel scale divides on the card, not by a reciprocal)."""
    from differential_transformer_replication_tpu_torch.ops.decode_attention import (
        quantize_params_int8,
    )

    cfg = ModelConfig(model="diff", vocab_size=512, n_embd=256, n_head=2,
                      n_layer=2, block_size=128)
    params = init_model(gen, cfg)
    got = quantize_params_int8(params)
    want = quantize_params_int8(_host(params))
    for a, b in zip(_flat(got), _flat(want)):
        assert torch.equal(a.cpu(), b)


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host(v) for v in tree]
    return tree.cpu()


def _flat(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _flat(v)
    else:
        yield tree
