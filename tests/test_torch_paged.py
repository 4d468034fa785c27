"""The port's paged, multi-row and int8 decode path against the JAX
package's, on the CPU.

- Ops: the plain versions of rows 6-8 (``decode_attention_paged``,
  ``decode_attention_multi``, ``decode_attention_multi_paged``), float
  and int8, against the JAX Pallas kernels in interpret mode, with
  scrambled page tables, L = 1 and L = 3 rows and R = B + 1 cache rows.
  fp32 agrees to 1e-5; bf16 to 2^-8 of sum|c| * max|V| plus one bf16
  step of the output (the Pallas kernel rounds each stream's
  probabilities before its PV product, the plain version the combined
  map), as in tests/test_torch_ops.py.
- Models: ``forward_decode_pool_paged``, ``forward_decode_spec`` (exact
  and batched, R = B + 1 rows with the trash row) and
  ``forward_decode_spec_paged`` (exact and batched) against the JAX
  functions (XLA decode attention) from the same JAX-initialized params,
  for control, diff and ndiff, float and int8 caches. fp32 logits agree
  to 1e-4 (1e-3 with int8), caches on live rows and pages to 1e-5 (int8:
  dequantized, one quantization step) — the bounds of
  tests/test_torch_decode.py.
- Host state: the port's ``PagePool`` and the JAX one on one scripted
  trace of admissions, prefix hits, copy-on-write forks, releases,
  evictions, a full pool and a forced exhaustion give identical
  ``Admission``s, page tables and ``stats()``; ``NGramDrafter`` gives
  identical proposals on one evolving history.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu.config import ModelConfig as JModelConfig
from differential_transformer_replication_tpu.models import decode as jdec
from differential_transformer_replication_tpu.models import init_model as j_init_model
from differential_transformer_replication_tpu.serving import pages as jpages
from differential_transformer_replication_tpu.serving import spec as jspec
from differential_transformer_replication_tpu_torch.config import ModelConfig
from differential_transformer_replication_tpu_torch.models import decode as tdec
from differential_transformer_replication_tpu_torch.params import params_from_jax
from differential_transformer_replication_tpu_torch.serving import pages as tpages
from differential_transformer_replication_tpu_torch.serving import spec as tspec

from test_torch_decode import assert_caches_match

JDA = importlib.import_module("differential_transformer_replication_tpu.ops.decode_attention")
TDA = importlib.import_module(
    "differential_transformer_replication_tpu_torch.ops.decode_attention")

FP32_TOL = 1e-5
LOGIT_TOL = 1e-4
LOGIT_TOL_INT8 = 1e-3
DTYPES = [("float32", torch.float32), ("bfloat16", torch.bfloat16)]


def _err(j_out, t_out) -> float:
    return float(np.max(np.abs(np.asarray(j_out, np.float32)
                               - t_out.to(torch.float32).numpy())))


def _bf16_tol(ref, coeffs, vmax) -> float:
    return (2.0 ** -8 * float(np.abs(coeffs).sum(0).max()) * vmax
            + 2.0 ** -7 * float(np.max(np.abs(np.asarray(ref, np.float32)))))


# ---------------------------------------------------------------------------
# rows 6-8: the plain versions against the Pallas kernels (interpreted)
# ---------------------------------------------------------------------------


def _operands(rng, S, B, H, M, d, dv, L, ps, jdt, tdt, int8, R):
    """Queries, a contiguous cache of R rows and a paged pool holding the
    same B slots behind a scrambled table, as (JAX, port) pairs."""
    q = rng.standard_normal((S, B, L, H, d)).astype(np.float32)
    kc = rng.standard_normal((S, R, H, M, d)).astype(np.float32)
    vc = rng.standard_normal((R, H, M, dv)).astype(np.float32)
    pp = M // ps
    P = 1 + B * pp + 2  # trash page + the slots' pages + two spares
    kp = rng.standard_normal((S, P, H, ps, d)).astype(np.float32)
    vp = rng.standard_normal((P, H, ps, dv)).astype(np.float32)
    tab = (1 + rng.permutation(P - 1)[:B * pp]).reshape(B, pp).astype(np.int32)
    pos = np.stack([np.sort(rng.integers(0, M, size=L)) for _ in range(B)]).astype(np.int32)
    pos[0] = np.arange(L)  # a row at the start of its ring
    c = (rng.standard_normal((S, H)) * 0.5).astype(np.float32)
    c[0] = 1.0
    j = {"q": jnp.asarray(q).astype(jdt), "pos": jnp.asarray(pos),
         "c": jnp.asarray(c), "tab": jnp.asarray(tab)}
    t = {"q": torch.from_numpy(q).to(tdt), "pos": torch.from_numpy(pos),
         "c": torch.from_numpy(c), "tab": torch.from_numpy(tab)}
    vmax = 0.0
    for name, arr in (("kc", kc), ("vc", vc), ("kp", kp), ("vp", vp)):
        ja, ta = jnp.asarray(arr).astype(jdt), torch.from_numpy(arr).to(tdt)
        if int8:
            (ja, jsc), (ta, tsc) = JDA.quantize_kv(ja), TDA.quantize_kv(ta)
            j[name + "_s"], t[name + "_s"] = jsc, tsc
            if name.startswith("v"):
                vmax = max(vmax, float(tsc.max()) * 127.0)
        elif name.startswith("v"):
            vmax = max(vmax, float(np.abs(arr).max()))
        j[name], t[name] = ja, ta
    return j, t, c, vmax


def _scales(d, kname, vname):
    if kname + "_s" not in d:
        return {}
    return {"k_scale": d[kname + "_s"], "v_scale": d[vname + "_s"]}


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_cpu_path_matches_pallas(ps, int8, jdt, tdt):
    """Row 6: single-query attention through a scrambled page table."""
    S, B, H, M, d, dv = 2, 3, 2, 32, 8, 16
    j, t, c, vmax = _operands(np.random.default_rng(ps + 2 * int8), S, B, H, M,
                              d, dv, 1, ps, jdt, tdt, int8, B)
    ref = JDA.decode_attention_paged(j["q"][:, :, 0], j["kp"], j["vp"], j["tab"],
                                     j["pos"][:, 0], j["c"], **_scales(j, "kp", "vp"))
    got = TDA.decode_attention_paged(t["q"][:, :, 0], t["kp"], t["vp"], t["tab"],
                                     t["pos"][:, 0], t["c"], **_scales(t, "kp", "vp"))
    assert got.dtype == tdt and tuple(got.shape) == (B, H, dv)
    tol = FP32_TOL if tdt == torch.float32 else _bf16_tol(ref, c, vmax)
    assert _err(ref, got) <= tol
    assert TDA.decode_attention_paged.launches == 0


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("L", [1, 3, 9])
def test_multi_cpu_paths_match_pallas(L, int8, jdt, tdt):
    """Rows 7 and 8: L rows per slot with row-causal positions, over a
    contiguous cache of R = B + 1 rows (the trash row never read) and
    through a scrambled page table of pages of 8."""
    S, B, H, M, d, dv = 2, 3, 2, 32, 8, 16
    j, t, c, vmax = _operands(np.random.default_rng(10 + L + 2 * int8), S, B, H,
                              M, d, dv, L, 8, jdt, tdt, int8, B + 1)
    tol = None
    for name, jfn, tfn, jargs, targs, kv in (
        ("multi", JDA.decode_attention_multi, TDA.decode_attention_multi,
         (j["q"], j["kc"], j["vc"], j["pos"], j["c"]),
         (t["q"], t["kc"], t["vc"], t["pos"], t["c"]), ("kc", "vc")),
        ("multi_paged", JDA.decode_attention_multi_paged,
         TDA.decode_attention_multi_paged,
         (j["q"], j["kp"], j["vp"], j["tab"], j["pos"], j["c"]),
         (t["q"], t["kp"], t["vp"], t["tab"], t["pos"], t["c"]), ("kp", "vp")),
    ):
        ref = jfn(*jargs, **_scales(j, *kv))
        got = tfn(*targs, **_scales(t, *kv))
        assert got.dtype == tdt and tuple(got.shape) == (B, L, H, dv), name
        tol = FP32_TOL if tdt == torch.float32 else _bf16_tol(ref, c, vmax)
        assert _err(ref, got) <= tol, name
    assert TDA.decode_attention_multi.launches == 0
    assert TDA.decode_attention_multi_paged.launches == 0


def test_multi_rows_equal_single_row_calls():
    """Row l of the multi-row plain version is the single-row plain
    version at pos[:, l], bit for bit, on both storages (the unrolled
    formulation the greedy spec pin rests on)."""
    S, B, H, M, d, dv = 2, 3, 2, 32, 8, 16
    _, t, _, _ = _operands(np.random.default_rng(3), S, B, H, M, d, dv, 3, 8,
                           "float32", torch.float32, True, B + 1)
    multi = TDA.decode_attention_multi_paged(t["q"], t["kp"], t["vp"], t["tab"],
                                             t["pos"], t["c"], **_scales(t, "kp", "vp"))
    for l in range(3):
        one = TDA.decode_attention_paged(t["q"][:, :, l], t["kp"], t["vp"], t["tab"],
                                         t["pos"][:, l].contiguous(), t["c"],
                                         **_scales(t, "kp", "vp"))
        assert torch.equal(multi[:, l], one)


SMEM_OPT_IN = 232448  # the H100's per-block shared memory, 227 KB


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("S", [1, 2, 8])
# the envelope's edges (d 1..256, dv 1..512) and the recipes' widths
@pytest.mark.parametrize("d,dv", [(1, 1), (40, 80), (96, 192), (256, 1), (1, 512),
                                  (256, 512)])
def test_decode_instance_rule(dtype, S, d, dv):
    """``decode_instance``: fp32 takes the SIMT split body, bf16 queries
    (bf16 or int8 K/V) the tensor cores; the keys per tile are a power of
    two, the same for every L, and the largest whose block (the twin of
    the kernel's shared-memory layout) fits the 227 KB opt-in."""
    picks = {TDA.decode_instance(dtype, S, L, d, dv)
             for L in list(range(1, TDA.MAX_ROWS + 1)) + [9, 16]}
    assert len(picks) == 1
    (route, TK), = picks
    assert route == ("mma" if dtype == torch.bfloat16 else "simt")
    assert TK & (TK - 1) == 0 and (16 if route == "mma" else 8) <= TK <= TDA.MAX_TK
    assert TDA.decode_smem_bytes(route, S, TK, d, dv) <= SMEM_OPT_IN
    assert TK == TDA.MAX_TK or TDA.decode_smem_bytes(route, S, 2 * TK, d, dv) > SMEM_OPT_IN


def test_decode_instance_at_the_recipes_and_outside_the_envelope():
    """The recipes' decode widths take 64-key tiles in both dtypes; at the
    envelope's widest corner (S 8, d 256, dv 512) a bf16 K tile of 64 keys
    alone is 264 KB, so the tile halves; any L >= 1 is taken (the wrapper
    runs passes of MAX_ROWS rows); shapes past the envelope raise."""
    for S, d, dv in ((1, 96, 96), (2, 96, 192), (4, 96, 192)):
        assert TDA.decode_instance(torch.bfloat16, S, 5, d, dv) == ("mma", 64)
        assert TDA.decode_instance(torch.float32, S, 5, d, dv) == ("simt", 64)
        for L in (9, 16):
            assert TDA.decode_instance(torch.bfloat16, S, L, d, dv) == ("mma", 64)
    assert TDA.decode_instance(torch.bfloat16, 8, 1, 256, 512) == ("mma", 32)
    assert TDA.decode_instance(torch.float32, 8, 1, 256, 512) == ("simt", 8)
    for S, L, d, dv in ((9, 1, 96, 96), (9, 9, 96, 96), (9, 16, 96, 96),
                        (1, 0, 96, 96), (1, 1, 257, 96), (1, 1, 96, 513)):
        with pytest.raises(ValueError):
            TDA.decode_instance(torch.bfloat16, S, L, d, dv)
    with pytest.raises(TypeError):
        TDA.decode_instance(torch.float16, 1, 1, 96, 96)


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=61, n_embd=64, n_head=2, n_layer=2, block_size=32,
             dropout=0.0, n_terms=3, compute_dtype="float32")
PS = 8


def _setup(kind: str, kv: str, seed: int = 0):
    jcfg = JModelConfig(model=kind, kv_cache_dtype=kv, **SMALL)
    tcfg = ModelConfig(model=kind, kv_cache_dtype=kv, **SMALL)
    tree = jax.tree_util.tree_map(np.asarray, j_init_model(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 100)
    for blk in tree["blocks"]:
        for key in ("lambda_q", "lambda_k"):
            if key in blk["attn"]:
                blk["attn"][key] = (rng.standard_normal(blk["attn"][key].shape)
                                    * 0.1).astype(np.float32)
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), \
        params_from_jax(tree, tcfg, device="cpu")


_J_CHUNK = jax.jit(jdec.forward_chunk, static_argnums=(4, 5))
_J_POOL_PAGED = jax.jit(jdec.forward_decode_pool_paged, static_argnums=(6, 7))
_J_SPEC = jax.jit(jdec.forward_decode_spec, static_argnums=(4, 6, 7))
_J_SPEC_PAGED = jax.jit(jdec.forward_decode_spec_paged, static_argnums=(6, 7, 8))
PROMPTS = (13, 6, 20)  # prompt lengths of the three slots


def _prefill(jparams, tparams, jcfg, tcfg, jcache, tcache, rng, rows):
    """Prefill each slot in ladder chunks through ``rows(i)`` -> (JAX
    ring view getter/setter, port view, port write-back)."""
    last = []
    for i, n in enumerate(PROMPTS):
        prompt = rng.integers(0, SMALL["vocab_size"], size=n)
        start = 0
        while start < n:
            size = 1 << (min(n - start, 8).bit_length() - 1)
            toks = prompt[start:start + size][None]
            jget, jset, tview, tback = rows(i)
            jl, jrow = _J_CHUNK(jparams, jnp.asarray(toks), start, jget(jcache),
                                jcfg, 0)
            jcache = jset(jcache, jrow)
            trow = tview(tcache)
            tl, _ = tdec.forward_chunk(tparams, torch.from_numpy(toks), start, trow, tcfg)
            tback(tcache, trow)
            assert _err(jl, tl) <= LOGIT_TOL_INT8
            start += size
        last.append(int(prompt[-1]))
    return jcache, np.array(last)


def _valid_err(jl, tl, dlen) -> float:
    """Max-abs logit difference over each slot's used rows (rows past its
    draft length compute throwaway logits, differently by design: the
    JAX exact step writes and discards them, the port never writes)."""
    return max(_err(jl[b, :d + 1], tl[b, :d + 1]) for b, d in enumerate(dlen))


def _verify_block(rng, B, L, dlen):
    """Tokens and positions of one verify block: slot b's row 0 at its
    next position, rows 1..dlen[b] its drafts, the rest clamped."""
    p0 = np.array(PROMPTS, np.int32)
    toks = rng.integers(0, SMALL["vocab_size"], size=(B, L))
    pos = np.repeat(p0[:, None], L, axis=1)
    for b in range(B):
        pos[b, :dlen[b] + 1] = p0[b] + np.arange(dlen[b] + 1)
    return toks, pos.astype(np.int32)


@pytest.mark.parametrize("kv", ["auto", "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("kind", ["control", "diff", "ndiff"])
def test_contiguous_spec_steps_match_jax(kind, kv):
    """forward_decode_spec, exact then batched, over a pool with the
    trash row (R = B + 1), draft lengths 2, 0, 1 of L = 3 rows."""
    jcfg, tcfg, jparams, tparams = _setup(kind, kv)
    tol = LOGIT_TOL_INT8 if kv == "int8" else LOGIT_TOL
    B, L = len(PROMPTS), 3
    rng = np.random.default_rng(7)
    jcache = jdec.init_cache(jcfg, B + 1)
    tcache = tdec.init_cache(tcfg, B + 1)

    def rows(i):
        return (lambda c: [{k: (t[:, i:i + 1] if jdec.KV_CACHE_BATCH_AXIS[k] else t[i:i + 1])
                            for k, t in l.items()} for l in c],
                lambda c, r: [{k: (t.at[:, i].set(r_l[k][:, 0]) if jdec.KV_CACHE_BATCH_AXIS[k]
                                   else t.at[i].set(r_l[k][0])) for k, t in l.items()}
                              for l, r_l in zip(c, r)],
                lambda c: [{k: (t[:, i:i + 1] if tdec.KV_CACHE_BATCH_AXIS[k] else t[i:i + 1])
                            for k, t in l.items()} for l in c],
                lambda c, r: None)

    jcache, _ = _prefill(jparams, tparams, jcfg, tcfg, jcache, tcache, rng, rows)
    dlen = np.array([2, 0, 1])
    for batched in (False, True):
        toks, pos = _verify_block(rng, B, L, dlen)
        target = np.where(np.arange(L)[None, :] <= dlen[:, None],
                          np.arange(B)[:, None], B).astype(np.int32)
        jl, jcache = _J_SPEC(jparams, jnp.asarray(toks, jnp.int32), jnp.asarray(pos),
                             jcache, jcfg, jnp.asarray(target), 0, batched)
        tl, _ = tdec.forward_decode_spec(
            tparams, torch.from_numpy(toks), torch.from_numpy(pos), tcache, tcfg,
            torch.from_numpy(target), batched=batched)
        assert tuple(tl.shape) == (B, L, SMALL["vocab_size"])
        assert _valid_err(jl, tl, dlen) <= tol, batched
    live = [{k: (t[:, :B] if jdec.KV_CACHE_BATCH_AXIS[k] else t[:B]) for k, t in c.items()}
            for c in jcache]
    assert_caches_match(live, [{k: (t[:, :B] if tdec.KV_CACHE_BATCH_AXIS[k] else t[:B])
                                for k, t in c.items()} for c in tcache])


@pytest.mark.parametrize("kv", ["auto", "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("kind", ["control", "diff", "ndiff"])
def test_paged_steps_match_jax(kind, kv):
    """Prefill through gather/scatter_slot_cache, a paged L=1 pool step,
    then forward_decode_spec_paged exact and batched, all through one
    scrambled page table; caches compared on the live pages."""
    jcfg, tcfg, jparams, tparams = _setup(kind, kv, seed=1)
    tol = LOGIT_TOL_INT8 if kv == "int8" else LOGIT_TOL
    B, L, M = len(PROMPTS), 3, SMALL["block_size"]
    pp = M // PS
    P = 1 + B * pp + 3
    rng = np.random.default_rng(11)
    tab = (1 + rng.permutation(P - 1)[:B * pp]).reshape(B, pp).astype(np.int32)
    jtab, ttab = jnp.asarray(tab), torch.from_numpy(tab)
    jcache = jdec.init_cache_paged(jcfg, P, PS)
    tcache = tdec.init_cache_paged(tcfg, P, PS)

    def rows(i):
        return (lambda c: jdec.gather_slot_cache(c, jtab[i]),
                lambda c, r: jdec.scatter_slot_cache(c, r, jtab[i]),
                lambda c: tdec.gather_slot_cache(c, ttab[i]),
                lambda c, r: tdec.scatter_slot_cache(c, r, ttab[i]))

    jcache, last = _prefill(jparams, tparams, jcfg, tcfg, jcache, tcache, rng, rows)
    # one L=1 step; every slot writes its own page
    pos = np.array(PROMPTS, np.int32) - 1
    write = tab[np.arange(B), (pos % M) // PS].astype(np.int32)
    jl, jcache = _J_POOL_PAGED(jparams, jnp.asarray(last, jnp.int32), jnp.asarray(pos),
                               jcache, jtab, jnp.asarray(write), jcfg, 0)
    tl, _ = tdec.forward_decode_pool_paged(tparams, torch.from_numpy(last),
                                           torch.from_numpy(pos), tcache, ttab,
                                           torch.from_numpy(write), tcfg)
    assert _err(jl, tl) <= tol
    dlen = np.array([1, 2, 0])
    for batched in (False, True):
        toks, vpos = _verify_block(rng, B, L, dlen)
        wp = np.where(np.arange(L)[None, :] <= dlen[:, None],
                      tab[np.arange(B)[:, None], (vpos % M) // PS], 0).astype(np.int32)
        jl, jcache = _J_SPEC_PAGED(jparams, jnp.asarray(toks, jnp.int32),
                                   jnp.asarray(vpos), jcache, jtab, jnp.asarray(wp),
                                   jcfg, 0, batched)
        tl, _ = tdec.forward_decode_spec_paged(
            tparams, torch.from_numpy(toks), torch.from_numpy(vpos), tcache, ttab,
            torch.from_numpy(wp), tcfg, batched=batched)
        assert _valid_err(jl, tl, dlen) <= tol, batched
    live = np.sort(tab.reshape(-1))
    pick = lambda cache, take: [{k: take(t, jdec.KV_CACHE_BATCH_AXIS[k]) for k, t in c.items()}
                                for c in cache]
    assert_caches_match(
        pick(jcache, lambda t, ax: jnp.take(t, jnp.asarray(live), axis=ax)),
        pick(tcache, lambda t, ax: torch.index_select(t, ax, torch.from_numpy(live).long())))


def test_copy_cache_pages_and_trash_page_match_jax():
    """copy_cache_pages (the COW fork) copies one page on every leaf, and
    init_cache_paged refuses a page size that does not divide the block."""
    jcfg, tcfg, _, _ = _setup("diff", "int8")
    rng = np.random.default_rng(5)
    jc = jdec.init_cache_paged(jcfg, 6, PS)
    leaves = [{k: rng.standard_normal(np.asarray(t).shape).astype(np.float32)
               for k, t in c.items()} for c in jc]
    jc = [{k: jnp.asarray(v).astype(jc[0][k].dtype) for k, v in c.items()} for c in leaves]
    tc = [{k: torch.from_numpy(np.array(t)) for k, t in c.items()} for c in jc]
    jc = jdec.copy_cache_pages(jc, 2, 4)
    tdec.copy_cache_pages(tc, 2, 4)
    for j, t in zip(jc, tc):
        for k in j:
            assert np.array_equal(np.asarray(j[k]), t[k].numpy()), k
    with pytest.raises(ValueError, match="must divide"):
        tdec.init_cache_paged(tcfg, 4, 5)


# ---------------------------------------------------------------------------
# host state: PagePool and NGramDrafter
# ---------------------------------------------------------------------------


def _pool_trace(mod) -> list:
    """One scripted trace against a pool of module ``mod``: every
    Admission, table snapshot and stats() along the way."""
    pool = mod.PagePool(page_size=4, pages_per_slot=4, num_slots=3,
                        total_pages=12, prefix_cache=True)
    rng = np.random.default_rng(0)
    a = rng.integers(0, 50, 10).tolist()
    b = rng.integers(0, 50, 7).tolist()
    log = []

    def adm(slot, prompt, new):
        try:
            r = pool.plan_admission(slot, prompt, new)
        except mod.PagePoolExhaustedError as e:
            r = ("exhausted", e.retriable)
        if r is not None and not isinstance(r, tuple):
            r = (r.cached_len, r.copies, r.hit, r.device_cached, r.promotes)
        log.append((r, pool.tables().tolist(), pool.stats()))

    def rel(slot, prompt, cacheable=True):
        pool.release(slot, prompt, cacheable)
        log.append((pool.tables().tolist(), pool.stats()))

    adm(0, a, 4)              # miss
    rel(0, a)                 # donate 2 full pages + a partial tail
    adm(1, a[:9] + [7], 3)    # hit on 2 full pages + a COW fork of the tail
    adm(2, a, 2)              # hit: full pages shared, tail forked
    adm(0, b, 6)              # miss
    rel(1, a[:9] + [7])
    rel(2, a, cacheable=False)
    adm(1, rng.integers(0, 50, 14).tolist(), 2)  # evicts cached pages
    adm(2, rng.integers(0, 50, 15).tolist(), 1)  # pool too full: None
    rel(0, b)
    rel(1, [], cacheable=False)
    pool.force_exhaust()
    adm(0, b, 1)              # forced: the typed shed
    log.append(pool.probe_prefix(b))
    return log


def test_page_pool_trace_matches_jax():
    assert _pool_trace(tpages) == _pool_trace(jpages)
    assert [r[0] for r in _pool_trace(tpages)[:1]] == [(0, [], False, 0, [])]


def test_page_bytes_matches_jax():
    for kind in ("control", "diff", "ndiff"):
        for kv in ("auto", "bf16", "int8"):
            kw = dict(model=kind, kv_cache_dtype=kv, **SMALL)
            assert tpages.page_bytes(ModelConfig(**kw), 8) == \
                jpages.page_bytes(JModelConfig(**kw), 8)


def test_ngram_drafter_matches_jax():
    rng = np.random.default_rng(1)
    motif = [3, 4, 5, 6]
    hist = {0: motif * 3, 1: rng.integers(0, 20, 12).tolist(), 2: [9]}
    drafters = (tspec.NGramDrafter(), jspec.NGramDrafter())
    outs = ([], [])
    for step in range(12):
        slots_args = [(i, list(h), len(h) - 1, 1 + (i + step) % 4)
                      for i, h in hist.items()]
        for drafter, out, cls in zip(drafters, outs, (tspec.DraftSlot, jspec.DraftSlot)):
            out.append(drafter.propose_all([cls(*a) for a in slots_args]))
        for i in hist:
            h = hist[i]  # slot 1 random; slots 0 and 2 repeat a period of 4
            h.append(int(rng.integers(0, 20)) if i == 1 else h[max(len(h) - 4, 0)])
        if step == 6:  # slot 2 gets a new, shorter occupant
            for drafter in drafters:
                drafter.release(2)
            hist[2] = [1, 2, 1]
    assert outs[0] == outs[1]
    assert any(outs[0])
    assert drafters[0].stats()["proposed_total"] == drafters[1].stats()["proposed_total"]


def test_verify_passes_plan():
    """The multi-row wrappers' passes: MAX_ROWS rows at most, in order,
    covering every row once."""
    assert TDA.MAX_ROWS == 8
    assert TDA.verify_passes(1) == [(0, 1)]
    assert TDA.verify_passes(8) == [(0, 8)]
    assert TDA.verify_passes(9) == [(0, 8), (8, 9)]
    assert TDA.verify_passes(16) == [(0, 8), (8, 16)]
    assert TDA.verify_passes(17) == [(0, 8), (8, 16), (16, 17)]
    with pytest.raises(ValueError):
        TDA.verify_passes(0)


@pytest.mark.parametrize("L", [5, 9, 16, 19])
def test_verify_passes_join_to_the_whole_call(monkeypatch, L):
    """The pass loop of the multi-row wrappers (the card's path), with the
    kernel launch replaced by the plain version on each pass's rows: each
    pass sees at most MAX_ROWS contiguous rows with their own positions,
    and the joined passes equal the whole L-row plain call bit for bit."""
    S, B, H, M, d, dv = 2, 3, 2, 32, 8, 16
    _, t, _, _ = _operands(np.random.default_rng(20 + L), S, B, H, M, d, dv, L, 8,
                           "float32", torch.float32, False, B + 1)
    seen = []

    def fake_launch(what, qs, k, v, k_scale, v_scale, pos, tables, coeffs, *,
                    B, L, M, n_pages, page_size):
        assert qs.is_contiguous() and pos.is_contiguous()
        assert qs.shape[2] == L == pos.shape[1] <= TDA.MAX_ROWS
        seen.append(L)
        return TDA.decode_attention_multi_reference(qs, k, v, pos, coeffs)

    monkeypatch.setattr(TDA, "_launch", fake_launch)
    got = TDA._launch_rows("decode_attention_multi", t["q"], t["kc"], t["vc"], None,
                           None, t["pos"], None, t["c"], B=B, M=M, n_pages=B + 1,
                           page_size=M)
    want = TDA.decode_attention_multi_reference(t["q"], t["kc"], t["vc"], t["pos"], t["c"])
    assert seen == [b - a for a, b in TDA.verify_passes(L)]
    assert torch.equal(got, want)
