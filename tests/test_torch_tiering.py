"""The host-RAM page tier and preemption of the port, on the CPU, against
the JAX package.

- serving/host_tier.py: the JAX tests' cases (round trip, LRU, the
  budget, corruption as a counted miss, pinned stashes), on host torch
  tensors, and one page image's CRC32 equal in both packages (a bf16
  leaf's raw two-byte values included).
- The engine: the same scripts of submissions and fault plans go
  through the port's engine and the JAX engine, step by step: demote
  then promote, preempt then resume, a crash while a request is
  stashed, and the three tier faults (``page_demote_fail``,
  ``page_promote_hang``, ``page_swap_corrupt``). Greedy tokens, finish
  reasons, the tier, preemption and migration counters and
  ``tier_stats()`` must be equal (exact: the tokens are integers, the
  counters counts).
- A preempted SAMPLED request equals the port's own uninterrupted run
  bit for bit (its draws are not ``jax.random``'s, so JAX is not the
  reference there), and a stash never aliases the live pool.
"""

from __future__ import annotations

import ml_dtypes
import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu.serving.host_tier import (
    payload_checksum as j_payload_checksum,
)
from differential_transformer_replication_tpu.utils import faults as jfaults
from differential_transformer_replication_tpu_torch.config import ServingConfig
from differential_transformer_replication_tpu_torch.serving.host_tier import (
    HostTier,
    payload_checksum,
    payload_nbytes,
)
from differential_transformer_replication_tpu_torch.utils import faults
from torch_tier_common import (
    both,
    drive,
    fillers,
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


def _payload(n=64, layers=2, seed=0):
    """A fake page image: per-layer dicts of byte tensors (2 * layers * n
    bytes)."""
    gen = torch.Generator().manual_seed(seed)
    return [{"k": torch.randint(0, 255, (n,), dtype=torch.uint8, generator=gen),
             "v": torch.randint(0, 255, (n,), dtype=torch.uint8, generator=gen)}
            for _ in range(layers)]


# -- serving/host_tier.py ----------------------------------------------------


def test_tier_put_get_roundtrip():
    tier = HostTier(budget_bytes=10_000)
    p = _payload(seed=1)
    assert tier.put(("a",), p)
    ent = tier.get(("a",))
    assert ent is not None and ent.verify()
    for got, want in zip(ent.payload, p):
        assert torch.equal(got["k"], want["k"]) and torch.equal(got["v"], want["v"])
    assert tier.get(("zz",)) is None
    st = tier.stats()
    assert st["hits_total"] == 1 and st["misses_total"] == 1
    assert st["entries"] == 1 and st["bytes"] == payload_nbytes(p) == 256
    with pytest.raises(ValueError):
        HostTier(budget_bytes=0)


def test_tier_lru_eviction_respects_recency():
    tier = HostTier(budget_bytes=600)  # each payload is 256 bytes
    tier.put(("a",), _payload(seed=1))
    tier.put(("b",), _payload(seed=2))
    assert tier.get(("a",)) is not None  # b is now the LRU
    tier.put(("c",), _payload(seed=3))
    assert tier.get(("b",)) is None
    assert tier.get(("a",)) is not None and tier.get(("c",)) is not None
    assert tier.stats()["evictions_total"] == 1


def test_tier_refuses_a_payload_over_budget():
    tier = HostTier(budget_bytes=100)
    assert not tier.put(("a",), _payload(seed=1))
    st = tier.stats()
    assert st["rejected_total"] == 1 and st["entries"] == 0


def test_tier_corruption_reads_as_a_counted_miss():
    tier = HostTier(budget_bytes=10_000)
    p = _payload(seed=4)
    tier.put(("a",), p)
    p[0]["k"][0] ^= 0xFF  # a torn host copy: the tier holds it by reference
    assert tier.get(("a",)) is None
    st = tier.stats()
    assert st["corrupt_total"] == 1 and st["entries"] == 0
    assert st["misses_total"] == 1 and st["hits_total"] == 0


def test_tier_stash_is_pinned_and_never_refused():
    tier = HostTier(budget_bytes=600)
    tier.put(("a",), _payload(seed=1))
    tier.put(("b",), _payload(seed=2))
    tier.stash("req1", [_payload(seed=3), _payload(seed=4)])
    st = tier.stats()
    assert st["stashes"] == 1 and st["stash_bytes"] == 512
    assert st["entries"] <= 1  # cached entries made way
    tier.stash("req2", [_payload(n=512, seed=5)])  # may overshoot
    assert tier.stats()["bytes"] > 600
    ents = tier.unstash("req1")
    assert ents is not None and len(ents) == 2 and all(e.verify() for e in ents)
    assert tier.unstash("req1") is None
    tier.drop_stash("req2")
    assert tier.stats()["stash_bytes"] == 0
    tier.put(("c",), _payload(seed=6))
    tier.stash("req3", [_payload(seed=7)])
    tier.clear_cache()  # the crash path: stashes and counters survive
    st = tier.stats()
    assert st["entries"] == 0 and st["stashes"] == 1


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_one_page_image_has_one_crc_in_both_packages(dtype):
    """The CRC covers the leaves' raw bytes in (layer, sorted key) order:
    a torch page image (bf16 as torch.bfloat16) and the numpy image the
    JAX engine would hold (bf16 through ml_dtypes) share one checksum."""
    rng = np.random.default_rng(3)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    layers = [{"v": rng.normal(size=(2, 8, 4)).astype(np_dt),
               "k": rng.normal(size=(2, 2, 8, 4)).astype(np_dt)}
              for _ in range(2)]
    tl = [{key: (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                 if dtype == "bfloat16" else torch.from_numpy(a))
           for key, a in layer.items()} for layer in layers]
    assert payload_checksum(tl) == j_payload_checksum(layers)
    assert payload_checksum([{k: a for k, a in layer.items()}
                             for layer in layers]) == j_payload_checksum(layers)


# -- the engine against the JAX engine ---------------------------------------


A = [1] + prompts([16], 7)[0]  # two full pages
BATCH_P, HIGH_P = prompts([9, 9], 3)


def _revisit(arm_at=None, name=None, n_fill=4):
    """Serve A, push fillers through (A's pages evict and demote), then
    serve A again (its pages promote back). ``name`` arms that fault
    over a range of iterations before the fillers (``arm_at="fill"``) or
    before the revisit (``"revisit"``)."""
    arm = [("arm", lambda it: ",".join(f"{name}@{i}" for i in range(it, it + 300)))]
    script = [("submit", A, dict(max_new_tokens=3)), ("run",)]
    if arm_at == "fill":
        script += arm
    for f in fillers(n_fill):
        script += [("submit", f, dict(max_new_tokens=2)), ("run",)]
    if arm_at == "fill":
        script += [("disarm",)]
    if arm_at == "revisit":
        script += arm
    return script + [("submit", A, dict(max_new_tokens=3)), ("run",)]


def _preempt(name=None, crash=False):
    """A batch request decodes two tokens; a high request that the pool
    cannot also hold arrives and preempts it; both finish. ``name`` arms
    that fault over a range from the high request's arrival; ``crash``
    raises in the step after the preemption, while the batch request is
    stashed."""
    script = [("submit", BATCH_P, dict(max_new_tokens=8, priority="batch")),
              ("decoded", 2),
              ("submit", HIGH_P, dict(max_new_tokens=23, priority="high"))]
    if name:
        script.append(("arm", lambda it: ",".join(
            f"{name}@{i}" for i in range(it, it + 300))))
    if crash:
        script.append(("arm", lambda it: f"serve_raise@{it + 1}"))
    return script + [("run",)]


CASES = {
    "demote-promote": (_revisit(), {}),
    "demote-promote-int8": (_revisit(), dict(kv_cache_dtype="int8")),
    "demote-promote-control": (_revisit(), dict(family="control")),
    "preempt-resume": (_preempt(), dict(kv_pool_pages=5)),
    "preempt-resume-int8": (_preempt(), dict(kv_pool_pages=5,
                                             kv_cache_dtype="int8")),
    "crash-while-stashed": (_preempt(crash=True), dict(kv_pool_pages=5)),
    "page_demote_fail": (_revisit("fill", "page_demote_fail"), {}),
    "page_promote_hang": (_revisit("revisit", "page_promote_hang"), {}),
    "page_swap_corrupt": (_preempt("page_swap_corrupt"), dict(kv_pool_pages=5)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_agrees_with_the_jax_engine(case, monkeypatch):
    monkeypatch.setenv("DTX_TIER_HANG_S", "0.02")
    script, kw = CASES[case]
    got, want = both(script, **kw)
    assert got["outs"] == want["outs"]
    assert got["crashes"] == want["crashes"]
    assert got["counters"] == want["counters"]
    assert got["tier"] == want["tier"]
    c = got["counters"]
    # and each mechanism ran: the outcome is not that of a plain run
    if case.startswith("demote-promote"):
        assert c["tier_demotions"] > 0 and c["tier_promotions"] > 0
        assert c["tier_fallbacks"] == 0 and got["tier"]["hits_total"] > 0
        assert got["outs"][0] == got["outs"][-1]  # promoted == computed
    elif case.startswith("preempt-resume"):
        assert c["preemptions"] >= 1 and c["resumes"] == c["preemptions"]
        assert c["tier_fallbacks"] == 0
    elif case == "crash-while-stashed":
        # the running high request is lost, the stashed one survives
        assert [lost for _, _, lost in got["crashes"]] == [[1]]
        assert c["preemptions"] >= 1 and got["outs"][1] is None
        assert got["outs"][0][1] == "length"
        return
    elif case == "page_demote_fail":
        # A's pages were lost, not demoted: its revisit recomputes them
        assert c["tier_fallbacks"] > 0 and c["tier_promotions"] == 0
        assert got["outs"][0] == got["outs"][-1]
    elif case == "page_promote_hang":
        assert c["tier_fallbacks"] > 0 and c["tier_promotions"] == 0
        assert got["outs"][0] == got["outs"][-1]
    else:  # page_swap_corrupt: the CRC convicts the stash, a restart
        assert got["tier"]["corrupt_total"] >= 1 and c["tier_fallbacks"] >= 1
        assert c["preemptions"] >= 1 and c["resumes"] == 0
    assert all(r in ("length", "eos", "stop_sequence")
               for _, r in got["outs"])


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_preempted_sampled_request_equals_its_uninterrupted_run(kv):
    """Token t draws from a generator seeded by (seed, t), so the
    swapped-in request continues the stream it would have drawn."""
    kw = dict(kv_pool_pages=5, kv_cache_dtype=kv)
    ref = port_engine(**kw).generate([BATCH_P], max_new_tokens=8,
                                     temperature=0.9, seed=5)[0]
    got = drive(port_engine(**kw), faults, [
        ("submit", BATCH_P, dict(max_new_tokens=8, temperature=0.9,
                                 seed=5, priority="batch")),
        ("decoded", 2),
        ("submit", HIGH_P, dict(max_new_tokens=23, priority="high")),
        ("run",)])
    assert got["counters"]["preemptions"] >= 1
    assert got["counters"]["resumes"] == got["counters"]["preemptions"]
    assert got["outs"][0] == (ref.tokens, "length")


def test_a_stash_never_aliases_the_live_pool():
    """Flipping a byte of every stashed leaf (what ``page_swap_corrupt``
    does to one) leaves the pool's bytes as they were."""
    eng = port_engine(kv_pool_pages=5)
    drive(eng, faults, [
        ("submit", BATCH_P, dict(max_new_tokens=8, priority="batch")),
        ("decoded", 2),
        ("submit", HIGH_P, dict(max_new_tokens=23, priority="high"))])
    # the step that admits the high request preempts the batch one
    while not eng.tier_stats()["stashes"]:
        eng.step()
    before = [{k: t.clone() for k, t in layer.items()} for layer in eng.cache]
    (rid,) = eng._resume
    ents = eng._tier._stashes[rid]
    for ent in ents:
        for layer in ent.payload:
            for leaf in layer.values():
                leaf.reshape(-1).view(torch.uint8)[0] ^= 0xFF
    assert not any(ent.verify() for ent in ents)
    for layer, snap in zip(eng.cache, before):
        for key, t in layer.items():
            assert torch.equal(t, snap[key]), key


def test_tiered_config_and_its_validation():
    assert ServingConfig(kv_page_size=8, host_tier_bytes=1 << 20).tiered()
    assert not ServingConfig(host_tier_bytes=1 << 20).tiered()  # contiguous
    assert not ServingConfig(kv_page_size=8).tiered()
    with pytest.raises(ValueError, match="host_tier_bytes"):
        ServingConfig(kv_page_size=8, host_tier_bytes=-1)
