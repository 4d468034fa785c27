"""The port's model drafter (``serving/spec.py:ModelDrafter``) against the
JAX package's, on the CPU.

- ``propose_all`` gives JAX's proposals on the same params and token
  histories, for a self drafter (the target's params) and for a random
  2-layer control drafter: catch-up of fresh slots, caps that differ per
  slot, the drafter's own window, a rewind by ``commit`` and a second
  round fed from the rewound cursor; ``window()`` and ``bytes_total()``
  equal JAX's.
- A self drafter accepts every draft (JAX's tests/test_spec.py
  self-params case) and leaves the greedy tokens unchanged; a random
  drafter accepts few and leaves them unchanged too.
- ``spec_drafter_crash@N`` fires at JAX's point: the same crash count,
  proposals resume after the rebuild, the same tokens and counters as
  the JAX engine under the same plan.
- A drafter whose vocab differs from the target's raises; a model
  drafter without a checkpoint or params raises.

Tolerance: none — token ids and counters equal (argmaxes of fp32 logits
at these sizes carry no near-ties in the histories used).
"""

from __future__ import annotations

import numpy as np
import pytest

from differential_transformer_replication_tpu.serving.spec import (
    DraftSlot as JDraftSlot,
)
from differential_transformer_replication_tpu.serving.spec import (
    ModelDrafter as JModelDrafter,
)
from differential_transformer_replication_tpu.utils import faults as jfaults
from differential_transformer_replication_tpu_torch.config import ServingConfig
from differential_transformer_replication_tpu_torch.serving.spec import (
    DraftSlot,
    ModelDrafter,
    build_drafter,
)
from differential_transformer_replication_tpu_torch.utils import faults as tfaults

from torch_request_common import drafter, engines, models, prompts, vocab

SLOTS, K = 4, 3


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    tfaults.reset()
    jfaults.reset()


def _pair(kind):
    (jp, jc), (tp, tc) = drafter(kind)
    rope = models("diff")[0].block_size
    return (JModelDrafter(jp, jc, SLOTS, rope, prefill_chunk=4, draft_len=K),
            ModelDrafter(tp, tc, SLOTS, rope, prefill_chunk=4, draft_len=K))


@pytest.mark.parametrize("kind", ["self", "control"])
def test_propose_all_equals_jax(kind):
    jd, td = _pair(kind)
    assert td.window() == jd.window()
    assert td.bytes_total() == jd.bytes_total() > 0
    rng = np.random.default_rng(11)
    V = len(vocab())
    hist = [rng.integers(0, V, size=n).tolist() for n in (9, 5, 14, 3)]
    block = td.window()
    hist[3] = rng.integers(0, V, size=block - 1).tolist()  # at the window's end
    caps = [3, 1, 2, 3]

    def slots(cls):
        return [cls(i, h, len(h) - 1, c) for i, (h, c) in enumerate(zip(hist, caps))]

    jprops, tprops = jd.propose_all(slots(JDraftSlot)), td.propose_all(slots(DraftSlot))
    assert tprops == jprops and set(tprops) == {0, 1, 2, 3}
    assert len(tprops[3]) == 1  # the drafter's own window clamps the cap
    # slot 0 accepted one draft, slot 2 none: rewind, extend the
    # histories by what the target emitted, and propose again
    jd.commit(0, len(hist[0]))
    td.commit(0, len(hist[0]))
    jd.commit(2, len(hist[2]) - 1)
    td.commit(2, len(hist[2]) - 1)
    hist[0] = hist[0] + tprops[0][:1] + [7]
    hist[2] = hist[2] + [5]
    jprops, tprops = jd.propose_all(slots(JDraftSlot)[:3]), td.propose_all(slots(DraftSlot)[:3])
    assert tprops == jprops
    assert td.stats() == jd.stats()
    assert td.rounds_total == 2 * K and td.catchup_chunks > 0
    td.release(1)
    jd.release(1)
    assert td.propose_all(slots(DraftSlot)[1:2]) == jd.propose_all(slots(JDraftSlot)[1:2])


@pytest.mark.parametrize("kind", ["self", "control"])
def test_spec_engine_with_a_model_drafter_keeps_greedy_tokens(kind):
    """The self drafter accepts every draft; both drafters leave the
    greedy tokens equal to the engine's without speculation; the random
    drafter's tokens and ``spec_stats()`` equal the JAX engine's with
    the same drafter."""
    teng, jeng = engines(kind, spec_mode="model", spec_draft_len=K)
    plain, _ = engines()
    ps = prompts(3, seed=9)
    kw = dict(max_new_tokens=12, temperature=0.0)
    got = [o.tokens for o in teng.generate(ps, **kw)]
    assert got == [o.tokens for o in plain.generate(ps, **kw)]
    st = teng.spec_stats()
    assert st["proposed"] > 0 and st["drafter"]["kind"] == "model"
    if kind == "self":
        assert st["acceptance_rate"] == 1.0
    else:
        assert got == [o.tokens for o in jeng.generate(ps, **kw)]
        js = jeng.spec_stats()
        assert {k: st[k] for k in js} == js
    assert "serving_spec_drafter_kv_bytes" in {m.name for m in teng.registry.metrics()}


def test_drafter_crash_fires_at_jax_point_and_proposals_resume():
    out = {}
    for name, idx, fmod in (("port", 0, tfaults), ("jax", 1, jfaults)):
        eng = engines("self", spec_mode="model", spec_draft_len=K)[idx]
        fmod.arm("spec_drafter_crash@2")
        outs = eng.generate(prompts(3, seed=9), max_new_tokens=20, temperature=0.0)
        fmod.reset()
        st = eng.spec_stats()
        out[name] = ([o.tokens for o in outs], st["drafter_crashes"],
                     st["proposed"], st["accepted"],
                     eng.stats["spec_drafter_crashes"])
        assert st["drafter"]["drafter_crashes_total"] == 1
    assert out["port"] == out["jax"]
    assert out["port"][1] == 1 and out["port"][2] > 0
    plain, _ = engines()
    assert out["port"][0] == [o.tokens for o in plain.generate(
        prompts(3, seed=9), max_new_tokens=20, temperature=0.0)]


def test_vocab_mismatch_and_missing_drafter_raise():
    _, _, tcfg, tparams = models("diff")
    other = tcfg.replace(vocab_size=tcfg.vocab_size + 1)
    serving = ServingConfig(spec_mode="model")
    with pytest.raises(ValueError, match="vocab"):
        build_drafter(serving, other, 64, drafter=(tparams, tcfg))
    with pytest.raises(ValueError, match="spec_drafter_ckpt"):
        build_drafter(serving, tcfg, 64)
    d = build_drafter(serving, tcfg, 64, drafter=(tparams, tcfg))
    assert isinstance(d, ModelDrafter) and d.rope_len == 64
