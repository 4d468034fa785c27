"""Live migration and replay of the port, on the CPU, against the JAX
package.

- The wire format (serving/migrate.py): the same page images and meta
  encode to the same bytes in both packages, fp32, int8 and bf16 leaves
  alike (bf16 as ``torch.bfloat16`` here, through ``ml_dtypes`` there),
  each package decodes the other's blob, and a flipped byte, a bad
  magic, a version skew and torn framing all fail typed.
- Engines: export -> release -> import between two engines. Within the
  port, greedy and sampled continuations equal the uninterrupted run bit
  for bit; against the JAX engines, the greedy tokens and the migration
  counters are equal; ACROSS packages (a JAX export imported by the port
  and the port's by JAX) the greedy continuation equals the source's
  uninterrupted tokens, fp32 and int8 KV, with and without dedup. All
  token comparisons are exact.
- The typed failures (contiguous pool, request not active, geometry,
  dedup miss, a field of a later slice) and the ``migrate_corrupt`` and
  ``migrate_hang`` faults, alone and in one plan with the three tier
  faults, with the JAX engine's outcome.
- Replay: a ``key_offset`` continuation equals the uninterrupted tail
  (greedy equal to JAX's, sampled to the port's own), on the contiguous
  and the paged pool, with n-gram speculation too, and a stop sequence
  that spans the boundary is matched.
"""

from __future__ import annotations

import json
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu.serving import migrate as jmigrate
from differential_transformer_replication_tpu.utils import faults as jfaults
from differential_transformer_replication_tpu_torch.serving import migrate
from differential_transformer_replication_tpu_torch.serving.migrate import (
    MIGRATE_MAGIC,
    MIGRATE_VERSION,
    MigrateExportError,
    MigratePayloadError,
    ReplayJournal,
    decode_slot_state,
    encode_slot_state,
    from_wire,
    params_from_dict,
    params_to_dict,
    to_wire,
)
from differential_transformer_replication_tpu_torch.serving.request import (
    SamplingParams,
)
from differential_transformer_replication_tpu_torch.utils import faults
from torch_tier_common import (
    COUNTERS,
    drive,
    fillers,
    jax_engine,
    port_engine,
    prompts,
)


@pytest.fixture(autouse=True)
def _disarm():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


# -- the wire format ----------------------------------------------------------


def _np_page(dtype, layers=2, seed=0):
    """A page image as the JAX engine holds one: numpy leaves (bf16
    through ml_dtypes), int8 with its fp32 scale planes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(layers):
        if dtype == "int8":
            out.append({
                "k": rng.integers(-127, 128, (2, 2, 8, 4)).astype(np.int8),
                "v": rng.integers(-127, 128, (2, 8, 4)).astype(np.int8),
                "k_scale": rng.random((2, 2, 8)).astype(np.float32),
                "v_scale": rng.random((2, 8)).astype(np.float32)})
        else:
            dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
            out.append({"k": rng.normal(size=(2, 2, 8, 4)).astype(dt),
                        "v": rng.normal(size=(2, 8, 4)).astype(dt)})
    return out


def _to_torch(page):
    return [{k: (torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
                 if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a.copy()))
             for k, a in layer.items()} for layer in page]


def _meta(**kw):
    return {"prompt": [1, 2, 3], "params": params_to_dict(SamplingParams()),
            "generated": [4, 5], "n_live": 3, "dedup_pages": 1,
            "page_size": 8, "model": "diff", "block_size": 32, "filled": 3,
            "cached_len": 0, "spec_proposed": 0, "spec_accepted": 0,
            "fsm_state": 0, "token_logprobs": None, "top_logprobs": None,
            "deadline_left_s": 0.0, **kw}


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_wire_bytes_equal_and_each_package_reads_the_others(dtype):
    pages = [None, _np_page(dtype, seed=1), _np_page(dtype, seed=2)]
    jblob = jmigrate.encode_slot_state(_meta(), pages)
    tpages = [None] + [_to_torch(p) for p in pages[1:]]
    tblob = encode_slot_state(_meta(), tpages)
    assert tblob == jblob
    layout = json.loads(tblob[10:10 + int.from_bytes(tblob[6:10], "big")])
    assert layout["page_layout"][0][0][1] == dtype  # never "int16"
    meta, got = decode_slot_state(jblob)
    assert meta == jmigrate.decode_slot_state(jblob)[0]
    assert got[0] is None
    for payload, want in zip(got[1:], tpages[1:]):
        for lg, lw in zip(payload, want):
            for key in lw:
                assert lg[key].dtype == lw[key].dtype
                assert torch.equal(lg[key], lw[key])
                lg[key].reshape(-1).view(torch.uint8)[0] ^= 0  # owned, writable
    _, jgot = jmigrate.decode_slot_state(tblob)
    for payload, want in zip(jgot[1:], pages[1:]):
        for lg, lw in zip(payload, want):
            for key in lw:
                assert lg[key].dtype == lw[key].dtype
                np.testing.assert_array_equal(lg[key], lw[key])


def test_wire_failures_are_typed():
    blob = encode_slot_state(_meta(n_live=1, dedup_pages=0),
                             [_to_torch(_np_page("float32"))])
    assert from_wire(to_wire(blob)) == blob
    with pytest.raises(MigratePayloadError, match="undecodable"):
        from_wire("!!! not base64 !!!")
    torn = bytearray(blob)
    torn[-1] ^= 0x01  # inside the last page's bytes
    with pytest.raises(MigratePayloadError, match="convicted"):
        decode_slot_state(bytes(torn))
    assert blob[:4] == MIGRATE_MAGIC
    with pytest.raises(MigratePayloadError, match="magic"):
        decode_slot_state(b"NOPE" + blob[4:])
    skew = bytearray(blob)
    skew[5] = MIGRATE_VERSION + 1  # big-endian u16 at offset 4
    with pytest.raises(MigratePayloadError, match="version"):
        decode_slot_state(bytes(skew))
    for cut in (blob[:3], blob[:len(blob) // 2]):
        with pytest.raises(MigratePayloadError, match="torn"):
            decode_slot_state(cut)
    with pytest.raises(MigratePayloadError, match="trailing"):
        decode_slot_state(blob + b"x")
    p = SamplingParams(max_new_tokens=7, temperature=0.9, seed=42, top_k=5,
                       stop=((1, 2), (3,)), priority="batch", key_offset=3)
    assert params_from_dict(json.loads(json.dumps(params_to_dict(p)))) == p


def test_replay_journal_is_bounded_and_grow_only():
    j = ReplayJournal(max_tokens=4, max_finished=2)
    j.begin("a")
    j.update("a", [1, 2, 3])
    j.update("a", [1, 2])  # a stale probe cannot shrink it
    assert j.tokens("a") == [1, 2, 3]
    j.update("a", list(range(100)))
    assert j.tokens("a") == [0, 1, 2, 3]
    j.begin("a")  # idempotent
    assert j.tokens("a") == [0, 1, 2, 3]
    assert j.tokens("never") is None
    assert j.stats()["bytes"] == 4 * ReplayJournal._TOKEN_BYTES
    for name in ("a", "b", "c"):
        j.begin(name)
        j.finish(name)
    assert not j.finished("a") and j.finished("b") and j.finished("c")
    assert j.stats() == {"bytes": 0, "entries": 0, "finished": 2,
                         "evicted_total": 1}


# -- export -> release -> import --------------------------------------------

PROMPT = prompts([12], 30)[0]  # one full page of 8 and a partial one


def _decode_until(eng, rid, n):
    for _ in range(400):
        slot = eng._slot_for(rid)
        if slot is not None and len(slot.generated) >= n:
            return
        eng.step()
    raise AssertionError(f"request {rid} never reached {n} tokens")


def _migrate(src, dst, kw, n=4, dedup=False):
    """Serve PROMPT on ``src`` until n tokens, move it to ``dst``, finish
    it there. Returns (tokens, export bytes, src stats, dst stats)."""
    rid = src.submit(PROMPT, **kw)
    _decode_until(src, rid, n)
    pool = getattr(dst, "pages", None) or dst._pages  # the port's or JAX's
    cached = pool.probe_prefix(PROMPT)
    blob = src.export_slot_state(rid, dedup_pages=cached if dedup else 0)
    assert src.release_migrated(rid) is True
    assert not src.has_work()
    new = dst.import_state(blob)
    (out,) = [o for o in dst.run() if o.request_id == new]
    return (out.tokens, len(blob), {k: src.stats[k] for k in COUNTERS},
            {k: dst.stats[k] for k in COUNTERS})


@pytest.mark.parametrize("kv,temp", [("auto", 0.0), ("auto", 0.9),
                                     ("int8", 0.0), ("int8", 0.9)],
                         ids=["fp32-greedy", "fp32-sampled", "int8-greedy",
                              "int8-sampled"])
def test_migrated_continuation_equals_the_uninterrupted_run(kv, temp):
    kw = dict(max_new_tokens=10, temperature=temp, seed=77)
    ref = port_engine(kv_cache_dtype=kv).generate([PROMPT], **kw)[0].tokens
    got = _migrate(port_engine(kv_cache_dtype=kv),
                   port_engine(kv_cache_dtype=kv), kw)
    assert got[0] == ref and len(ref) == 10
    assert got[2]["migrate_exports"] == 1 and got[3]["migrate_imports"] == 1
    assert got[3]["resumes"] == 1
    if temp == 0.0:  # greedy: the JAX engines give the same tokens, counts
        want = _migrate(jax_engine(kv_cache_dtype=kv),
                        jax_engine(kv_cache_dtype=kv), kw)
        assert got[0] == want[0]
        assert got[2:] == want[2:]


@pytest.mark.parametrize("kv", ["auto", "int8"])
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("dedup", [False, True], ids=["full", "dedup"])
def test_an_export_continues_in_the_other_package(kv, direction, dedup):
    """A JAX engine's slot state continues on the port's engine and the
    port's on JAX's, to the source's uninterrupted greedy tokens; with
    the destination warmed on the prompt, dedup ships fewer pages."""
    kw = dict(max_new_tokens=10, temperature=0.0)
    make_src, make_dst = ((jax_engine, port_engine) if direction == "jax-to-port"
                          else (port_engine, jax_engine))
    ref = make_src(kv_cache_dtype=kv).generate([PROMPT], **kw)[0].tokens
    dst = make_dst(kv_cache_dtype=kv)
    if dedup:
        dst.generate([PROMPT], max_new_tokens=2, temperature=0.0)
    tokens, nbytes, src_c, dst_c = _migrate(make_src(kv_cache_dtype=kv), dst,
                                            kw, dedup=dedup)
    assert tokens == ref
    assert dst_c["migrate_imports"] == 1 and dst_c["migrate_failed"] == 0
    if dedup:
        assert src_c["migrate_pages_deduped"] == 1
        full = _migrate(make_src(kv_cache_dtype=kv), make_dst(kv_cache_dtype=kv), kw)
        assert nbytes < full[1] and full[0] == ref


def test_typed_failures_leave_both_engines_clean():
    kw = dict(max_new_tokens=10, temperature=0.9, seed=79)
    ref = port_engine().generate([PROMPT], **kw)[0].tokens
    with pytest.raises(MigrateExportError, match="paged"):
        port_engine(kv_page_size=0, host_tier_bytes=0).export_slot_state(0)
    src, dst = port_engine(), port_engine()
    with pytest.raises(MigrateExportError) as ei:
        src.export_slot_state(12345)
    assert ei.value.code == "migrate_not_active"
    rid = src.submit(PROMPT, **kw)
    _decode_until(src, rid, 4)
    with pytest.raises(MigrateExportError) as ei:  # page 4 against 8
        port_engine(kv_page_size=4, kv_pool_pages=24).import_state(
            src.export_slot_state(rid))
    assert ei.value.code == "migrate_geometry"
    with pytest.raises(MigrateExportError) as ei:  # the peer's radix is cold
        dst.import_state(src.export_slot_state(rid, dedup_pages=1))
    assert ei.value.code == "migrate_dedup_miss"
    assert not dst.has_work() and dst.stats["migrate_failed"] == 1
    (out,) = [o for o in src.run() if o.request_id == rid]
    assert out.tokens == ref  # the source finished it, undisturbed


def test_an_image_with_a_later_slice_field_is_refused_typed():
    """A JAX request with penalties (not served by the port yet) is
    refused at import, never served with the field dropped."""
    src = jax_engine()
    rid = src.submit(PROMPT, max_new_tokens=10, temperature=0.0,
                     repetition_penalty=1.3)
    _decode_until(src, rid, 3)
    dst = port_engine()
    with pytest.raises(MigrateExportError, match="repetition_penalty") as ei:
        dst.import_state(src.export_slot_state(rid))
    assert ei.value.code == "migrate_unsupported"
    assert not dst.has_work() and dst.stats["migrate_imports"] == 0


def _corrupt_then_clean(make, fmod, monkeypatch):
    """``migrate_hang`` and ``migrate_corrupt`` armed in one plan: the
    first export stalls and carries a flipped byte that the import
    convicts; the clean re-export lands. Returns what both packages must
    agree on."""
    monkeypatch.setenv("DTX_MIGRATE_HANG_S", "0.1")
    src, dst = make(), make()
    rid = src.submit(PROMPT, max_new_tokens=10, temperature=0.0)
    _decode_until(src, rid, 4)
    fmod.arm("migrate_hang,migrate_corrupt")
    t0 = time.perf_counter()
    blob = src.export_slot_state(rid)
    stalled = time.perf_counter() - t0 >= 0.1
    with pytest.raises(Exception, match="convicted") as ei:
        dst.import_state(blob)
    assert not dst.has_work()
    new = dst.import_state(src.export_slot_state(rid))
    assert src.release_migrated(rid)
    (out,) = [o for o in dst.run() if o.request_id == new]
    return (type(ei.value).__name__, stalled, out.tokens,
            {k: src.stats[k] for k in COUNTERS},
            {k: dst.stats[k] for k in COUNTERS})


def test_migrate_faults_match_the_jax_engines(monkeypatch):
    got = _corrupt_then_clean(port_engine, faults, monkeypatch)
    want = _corrupt_then_clean(jax_engine, jfaults, monkeypatch)
    assert got == want
    assert got[:2] == ("MigratePayloadError", True)
    assert got[3]["migrate_exports"] == 2 and got[4]["migrate_imports"] == 1


def test_all_five_tier_and_migrate_faults_in_one_plan(monkeypatch):
    """One plan, armed in parts as the script reaches each phase:
    ``page_demote_fail`` over the last filler's admissions (earlier
    fillers demote A's pages), ``page_promote_hang`` over A's revisit,
    ``page_swap_corrupt`` over a preemption, and both migrate kinds at
    an export. The two packages' engines must end in the same state and
    every request must finish with a normal reason."""
    monkeypatch.setenv("DTX_TIER_HANG_S", "0.02")
    monkeypatch.setenv("DTX_MIGRATE_HANG_S", "0.02")
    A = [1] + prompts([16], 7)[0]
    batch_p, high_p = prompts([9, 9], 3)

    def span(name):
        return ("arm", lambda it: ",".join(f"{name}@{i}"
                                           for i in range(it, it + 40)))

    script = [("submit", A, dict(max_new_tokens=3)), ("run",)]
    for j, f in enumerate(fillers(4)):
        if j == 3:
            script.append(span("page_demote_fail"))
        script += [("submit", f, dict(max_new_tokens=2)), ("run",)]
    script += [("disarm",), span("page_promote_hang"),
               ("submit", A, dict(max_new_tokens=3)), ("run",), ("disarm",),
               ("submit", batch_p, dict(max_new_tokens=8, priority="batch")),
               ("decoded", 2), span("page_swap_corrupt"),
               ("submit", high_p, dict(max_new_tokens=23, priority="high")),
               ("decoded", 4), ("arm", lambda it: "migrate_hang,migrate_corrupt"),
               ("export", 7), ("run",)]
    results = []
    for make, fmod in ((port_engine, faults), (jax_engine, jfaults)):
        r = drive(make(kv_pool_pages=5), fmod, script)
        dst = make(kv_pool_pages=5)
        with pytest.raises(Exception, match="convicted") as ei:
            dst.import_state(r["blobs"][0])
        r["import"] = type(ei.value).__name__
        del r["blobs"]
        results.append(r)
        fmod.reset()
    got, want = results
    assert got == want
    c, tier = got["counters"], got["tier"]
    # each kind fired: a failed demotion, a hung promotion (A's revisit
    # recomputed), a convicted swap-in (a restart), a convicted export
    assert c["tier_demotions"] > 0 and c["tier_promotions"] == 0
    assert c["tier_fallbacks"] >= 3 and tier["corrupt_total"] >= 1
    assert c["preemptions"] >= 1 and c["resumes"] == 0
    assert c["migrate_exports"] == 1 and got["import"] == "MigratePayloadError"
    assert got["outs"][0] == got["outs"][5]
    assert all(r in ("length", "eos", "stop_sequence") for _, r in got["outs"])


# -- replay by key_offset ----------------------------------------------------

REPLAY = {"contiguous": dict(kv_page_size=0, host_tier_bytes=0),
          "contiguous-ngram": dict(kv_page_size=0, host_tier_bytes=0,
                                   spec_mode="ngram", spec_draft_len=3),
          "paged-int8": dict(kv_cache_dtype="int8"),
          "paged-ngram-batched": dict(spec_mode="ngram", spec_draft_len=3,
                                      spec_verify="batched")}


@pytest.mark.parametrize("case", list(REPLAY))
def test_replay_continuation_equals_the_uninterrupted_tail(case):
    kw = REPLAY[case]
    eng = port_engine(**kw)
    prompt = [5, 9, 2] * 3  # a motif, so the n-gram drafter proposes
    n = 8
    ref = eng.generate([prompt], max_new_tokens=n, temperature=0.0)[0].tokens
    assert ref == jax_engine(**kw).generate(
        [prompt], max_new_tokens=n, temperature=0.0)[0].tokens
    for k in (1, 4, 7):
        out = eng.generate([prompt + ref[:k]], max_new_tokens=n - k,
                           temperature=0.0, key_offset=k)[0]
        assert out.tokens == ref[k:], k
    ref_s = eng.generate([prompt], max_new_tokens=n, temperature=0.9,
                         seed=123)[0].tokens
    out_s = eng.generate([prompt + ref_s[:3]], max_new_tokens=n - 3,
                         temperature=0.9, seed=123, key_offset=3)[0]
    assert out_s.tokens == ref_s[3:]


def test_a_stop_sequence_spanning_the_replay_boundary_is_matched():
    eng = port_engine(kv_page_size=0, host_tier_bytes=0)
    prompt = prompts([7], 22)[0]
    ref = eng.generate([prompt], max_new_tokens=8, temperature=0.0)[0]
    stop = (tuple(ref.tokens[2:4]),)
    full = eng.generate([prompt], max_new_tokens=8, temperature=0.0,
                        stop=stop)[0]
    assert full.finish_reason == "stop_sequence"
    k = len(full.tokens) - 1  # split inside the stop pair
    out = eng.generate([prompt + full.tokens[:k]], max_new_tokens=8 - k,
                       temperature=0.0, stop=stop, key_offset=k)[0]
    assert out.tokens == full.tokens[k:]
    assert out.finish_reason == "stop_sequence"
    assert migrate.MIGRATE_VERSION == jmigrate.MIGRATE_VERSION
