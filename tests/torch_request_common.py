"""Shared set-up of the request-path tests of the port
(tests/test_torch_constrain.py, tests/test_torch_model_drafter.py): a
byte-level BPE trained once on a small synthetic corpus, whose id -> text
table is the vocabulary the constraint FSMs walk; a 2-layer width-64 diff
target and a 2-layer control drafter at the tokenizer's vocab, built once
from JAX-initialized params in both packages; engine factories; and the
requests the parity tests send."""

from __future__ import annotations

import json
from functools import lru_cache

import jax
import numpy as np

from differential_transformer_replication_tpu.config import ModelConfig as JModelConfig
from differential_transformer_replication_tpu.config import ServingConfig as JServingConfig
from differential_transformer_replication_tpu.models import init_model as j_init_model
from differential_transformer_replication_tpu.serving.engine import (
    ServingEngine as JServingEngine,
)
from differential_transformer_replication_tpu.serving.request import (
    SamplingParams as JSamplingParams,
)
from differential_transformer_replication_tpu_torch.config import (
    ModelConfig,
    ServingConfig,
)
from differential_transformer_replication_tpu_torch.data.corpus import synthetic_corpus
from differential_transformer_replication_tpu_torch.data.tokenizer import (
    train_bpe_tokenizer,
    vocab_strings,
)
from differential_transformer_replication_tpu_torch.params import params_from_jax
from differential_transformer_replication_tpu_torch.serving.engine import (
    ServingEngine,
)
from differential_transformer_replication_tpu_torch.serving.request import (
    SamplingParams,
)

POOL = dict(num_slots=3, prefill_chunk=4, prefill_budget=8)
SCHEMA = {"type": "object",
          "properties": {"name": {"type": "string"}, "age": {"type": "integer"}},
          "required": ["name", "age"]}
# the greedy requests the engine parity tests send: three constraint
# families, penalties with an echo, an echo under top-k, and a plain row
REQUESTS = (
    dict(regex="[a-z ]+\\.", max_new_tokens=10, logprobs=3),
    dict(choices=("Tom went home.", "Sue saw a dog.", "yes"), max_new_tokens=10),
    dict(json_schema=json.dumps(SCHEMA), max_new_tokens=12, logprobs=2),
    dict(presence_penalty=1.5, frequency_penalty=0.5, repetition_penalty=1.3,
         max_new_tokens=10, logprobs=4),
    dict(logprobs=5, top_k=4, max_new_tokens=10),
    dict(max_new_tokens=10),
)


@lru_cache(maxsize=None)
def vocab():
    """The BPE's id -> text table (its size is the models' vocab)."""
    tok = train_bpe_tokenizer(synthetic_corpus(60, seed=3), 400, 2, None)
    return tuple(vocab_strings(tok, tok.get_vocab_size()))


@lru_cache(maxsize=None)
def models(family: str = "diff", n_layer: int = 2, seed: int = 0):
    """(JAX cfg, JAX params, port cfg, port params) at the BPE's vocab."""
    small = dict(vocab_size=len(vocab()), n_embd=64, n_head=2, n_layer=n_layer,
                 block_size=48, dropout=0.0, n_terms=3,
                 compute_dtype="float32")
    jcfg = JModelConfig(model=family, **small)
    jparams = j_init_model(jax.random.PRNGKey(seed), jcfg)
    tcfg = ModelConfig(model=family, **small)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, params_from_jax(tree, tcfg)


def drafter(kind: str):
    """(JAX pair, port pair) of a drafter: the target itself ("self") or
    a random 2-layer control model ("control")."""
    jcfg, jparams, tcfg, tparams = (models("diff") if kind == "self"
                                    else models("control", seed=1))
    return (jparams, jcfg), (tparams, tcfg)


def engines(drafter_kind: str = "", **kw):
    """(port engine, JAX engine) with the same serving knobs over the diff
    target, the BPE vocab and, for ``spec_mode="model"``, the drafter."""
    jcfg, jparams, tcfg, tparams = models("diff")
    jd = td = None
    if kw.get("spec_mode") == "model":
        jd, td = drafter(drafter_kind or "control")
    serving = {**POOL, **kw}
    return (ServingEngine(tparams, tcfg, ServingConfig(**serving), device="cpu",
                          spec_drafter=td, vocab=vocab()),
            JServingEngine(jparams, jcfg, JServingConfig(**serving),
                           spec_drafter=jd, vocab=vocab()))


def prompts(n: int = len(REQUESTS), seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, len(vocab()), size=int(m)).tolist()
            for m in rng.integers(3, 9, size=n)]


def both_params(req: dict):
    """(port, JAX) SamplingParams of one greedy request."""
    kw = {"temperature": 0.0, **req}
    return SamplingParams(**kw), JSamplingParams(**kw)
