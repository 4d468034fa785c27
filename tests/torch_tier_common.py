"""Shared set-up of the host-tier, preemption and migration tests of the
port (tests/test_torch_tiering.py, tests/test_torch_migrate.py,
tests/test_torch_migrate_http.py): a tiny model built once per family
in both packages from the same JAX-initialized params, engine
factories, and a step-by-step runner of one script of submissions,
fault plans and exports through either package's engine that returns
what both must agree on."""

from __future__ import annotations

from functools import lru_cache

import jax
import numpy as np

from differential_transformer_replication_tpu.config import ModelConfig as JModelConfig
from differential_transformer_replication_tpu.config import ServingConfig as JServingConfig
from differential_transformer_replication_tpu.models import init_model as j_init_model
from differential_transformer_replication_tpu.serving.engine import (
    ServingEngine as JServingEngine,
)
from differential_transformer_replication_tpu_torch.config import (
    ModelConfig,
    ServingConfig,
)
from differential_transformer_replication_tpu_torch.params import params_from_jax
from differential_transformer_replication_tpu_torch.serving.engine import (
    ServingEngine,
)

# 2 layers, width 64; block 32 and pages of 8 give 4 pages a slot, so a
# pool of a few pages is under real pressure
SMALL = dict(vocab_size=61, n_embd=64, n_head=2, n_layer=2, block_size=32,
             dropout=0.0, n_terms=3, compute_dtype="float32")
TIERED = dict(num_slots=2, prefill_chunk=4, prefill_budget=6,
              kv_page_size=8, kv_pool_pages=6, host_tier_bytes=1 << 30)

# what the two packages' engines must agree on
COUNTERS = ("tier_demotions", "tier_promotions", "tier_fallbacks",
            "preemptions", "resumes", "migrate_exports", "migrate_imports",
            "migrate_pages_shipped", "migrate_pages_deduped",
            "migrate_failed")


@lru_cache(maxsize=None)
def models(family: str = "diff"):
    """(JAX cfg, JAX params, port cfg, port params) of one family."""
    jcfg = JModelConfig(model=family, **SMALL)
    jparams = j_init_model(jax.random.PRNGKey(0), jcfg)
    tcfg = ModelConfig(model=family, **SMALL)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, params_from_jax(tree, tcfg)


def port_engine(family="diff", **kw):
    _, _, tcfg, tparams = models(family)
    return ServingEngine(tparams, tcfg, ServingConfig(**{**TIERED, **kw}),
                         device="cpu")


def jax_engine(family="diff", **kw):
    jcfg, jparams, _, _ = models(family)
    return JServingEngine(jparams, jcfg, JServingConfig(**{**TIERED, **kw}))


def prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, SMALL["vocab_size"], size=n).tolist() for n in lens]


def fillers(n, base=100):
    """n distinct 17-token prompts: under a tiny pool their admissions
    evict (and, tiered, demote) earlier prompts' cached pages."""
    return [[(base + k) % SMALL["vocab_size"]] + prompts([16], base + k)[0]
            for k in range(n)]


def drive(engine, fmod, script):
    """Run ``script`` through ``engine`` step by step, with ``fmod`` the
    fault module of the engine's package. Actions:

    - ``("submit", prompt, kw)``: submit (greedy unless kw says);
    - ``("arm", f)``: arm the plan ``f(iteration)``; ``("disarm",)``;
    - ``("decoded", n)``: step until n more tokens were decoded;
    - ``("run",)``: step until the engine has no work;
    - ``("export", i)``: export submission i's slot state (the blob is
      kept in the result's ``blobs``).

    A step that raises hands back what finished and rebuilds, as the
    supervised runner does. Returns the outputs by submission index
    (tokens, finish reason), the crashes, the COUNTERS, ``tier_stats()``
    and the exported blobs."""
    rids, done, crashes, blobs = [], {}, [], []

    def step():
        it = engine.stats["iterations"]
        try:
            outs = engine.step()
        except Exception as e:
            outs = engine.take_finished()
            lost = engine.reset_after_crash()
            crashes.append((it, type(e).__name__, sorted(lost)))
        for o in outs:
            done[o.request_id] = (list(o.tokens), o.finish_reason)

    for act in script:
        if act[0] == "submit":
            kw = {"temperature": 0.0, **act[2]}
            rids.append(engine.submit(act[1], **kw))
        elif act[0] == "arm":
            fmod.arm(act[1](engine.stats["iterations"]))
        elif act[0] == "disarm":
            fmod.reset()
        elif act[0] == "decoded":
            d0 = engine.stats["decode_tokens"]
            for _ in range(300):
                if engine.stats["decode_tokens"] - d0 >= act[1]:
                    break
                step()
            assert engine.stats["decode_tokens"] - d0 >= act[1]
        elif act[0] == "run":
            while engine.has_work():
                step()
        elif act[0] == "export":
            blobs.append(engine.export_slot_state(rids[act[1]]))
    return dict(
        outs=[done.get(r) for r in rids], crashes=crashes,
        counters={k: engine.stats[k] for k in COUNTERS},
        tier=engine.tier_stats(), blobs=blobs)


def both(script, family="diff", **kw):
    """``drive`` the same script through the port's engine and the JAX
    engine built with the same serving knobs; returns (port, jax)."""
    from differential_transformer_replication_tpu.utils import faults as jfaults
    from differential_transformer_replication_tpu_torch.utils import faults

    got = drive(port_engine(family, **kw), faults, script)
    faults.reset()
    want = drive(jax_engine(family, **kw), jfaults, script)
    jfaults.reset()
    return got, want
