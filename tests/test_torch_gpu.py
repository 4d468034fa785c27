"""The port's hand-written kernels on the card, against their plain
PyTorch versions. These tests need a CUDA GPU (marker ``gpu``) and skip
without one; they import nothing of JAX, so they run on a machine
without it through the repository's test command minus the JAX
conftest:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

fp32 bounds: 1e-5 (norm, attention), 5e-5 (SwiGLU: fp32 accumulation
order over E products). bf16 bounds: one bf16 rounding step at the
largest output (2^-7 * max|ref|), and for attention also 2^-8 of
sum|c| * max|V| (the kernel rounds each stream's probabilities before
its PV product, the plain version rounds the combined map once).
"""

from __future__ import annotations

import pytest
import torch

from differential_transformer_replication_tpu_torch.config import (
    ModelConfig,
    ServingConfig,
)
from differential_transformer_replication_tpu_torch.models import init_model
from differential_transformer_replication_tpu_torch.ops import decode_attention as dat
from differential_transformer_replication_tpu_torch.ops import fused_ffn as ffn
from differential_transformer_replication_tpu_torch.ops import fused_norm_residual as fnr
from differential_transformer_replication_tpu_torch.serving.engine import ServingEngine

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


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("M,E,F", [(8, 768, 3072), (128, 768, 3072), (5, 70, 99)])
def test_swiglu_kernel_matches_plain(gen, dtype, M, E, F):
    x = torch.randn(M, E, generator=gen, device="cuda").to(dtype)
    ws = [(0.05 * torch.randn(*s, generator=gen, device="cuda")).to(dtype)
          for s in ((E, F), (F,), (E, F), (F,))]
    n0 = ffn.fused_swiglu.launches
    got = ffn.fused_swiglu(x, *ws)
    ref = ffn.swiglu_reference(x, *ws)
    assert got.dtype == dtype and got.shape == (M, F)
    assert _err(got, ref) <= (5e-5 if dtype == torch.float32 else _ulp(ref))
    assert ffn.fused_swiglu.launches - n0 == 1


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
