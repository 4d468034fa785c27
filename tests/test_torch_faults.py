"""The port's fault-injection plan (``utils/faults.py``) against the JAX
package's, on the CPU.

The port's module is a copy: every kind of JAX's ``_STEP_KINDS`` and
``_POINT_KINDS`` parses to the same plan on both sides, an unknown kind
raises the same message, and ``fire``, ``check``, ``consume``, ``stall``
and the step queries act alike. Each behavioural case runs once per
module (the ``side`` fixture, as in tests/test_torch_ckpt.py).
"""

from __future__ import annotations

import signal

import pytest

from differential_transformer_replication_tpu.utils import faults as jfaults
from differential_transformer_replication_tpu_torch.utils import faults as tfaults

ALL_KINDS = jfaults._STEP_KINDS + jfaults._POINT_KINDS


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(jfaults.ENV_VAR, raising=False)
    for mod in (jfaults, tfaults):
        mod.reset()
    yield
    for mod in (jfaults, tfaults):
        mod.reset()


@pytest.fixture(params=["jax", "port"])
def side(request):
    return jfaults if request.param == "jax" else tfaults


def test_the_kind_lists_and_variables_are_the_jax_packages():
    assert tfaults._STEP_KINDS == jfaults._STEP_KINDS
    assert tfaults._POINT_KINDS == jfaults._POINT_KINDS
    for name in ("ENV_VAR", "HANG_ENV_VAR", "CKPT_HANG_ENV_VAR",
                 "ROUTER_HANG_ENV_VAR", "TRAIN_HANG_ENV_VAR", "SKEW_ENV_VAR",
                 "TIER_HANG_ENV_VAR", "CANARY_REGRESS_ENV_VAR",
                 "MIGRATE_HANG_ENV_VAR"):
        assert getattr(tfaults, name) == getattr(jfaults, name), name


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_every_kind_parses_to_the_same_plan(kind):
    if kind in jfaults._STEP_KINDS:
        specs = [f"{kind}@7", f"{kind}@3-5", f"{kind}@2,{kind}@9-10"]
    else:
        specs = [kind, f"{kind}@3", f" {kind}@2 , "]
    for spec in specs:
        assert tfaults._parse(spec) == jfaults._parse(spec), spec


@pytest.mark.parametrize("spec", ["bogus@3", "nan", "sigkill@", "ckpt_write@x",
                                  "nan@a-b"])
def test_bad_specs_raise_the_same_error(spec):
    errors = []
    for mod in (jfaults, tfaults):
        with pytest.raises(ValueError) as e:
            mod._parse(spec)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_the_environment_arms_both_sides_alike(monkeypatch):
    monkeypatch.setenv(jfaults.ENV_VAR, "nan@3-4,ckpt_gc@2,train_hang@8")
    for mod in (jfaults, tfaults):
        mod._plan = None  # as at a process's start: armed on first use
    assert tfaults._get() == jfaults._get() == jfaults._parse(
        "nan@3-4,ckpt_gc@2,train_hang@8")
    for mod in (jfaults, tfaults):
        mod.arm("corrupt_params@5,ckpt_write")
    assert tfaults._get() == jfaults._get()
    assert tfaults.armed() and tfaults.nan_armed()
    # reset with the variable still set: a stale spec does not re-arm
    for mod in (jfaults, tfaults):
        mod.reset()
    assert tfaults._get() == jfaults._get() and not tfaults.armed()


def test_inert_when_unarmed(side):
    side.arm(None)
    assert not side.armed()
    side.fire(3)
    side.check("ckpt_write")
    side.stall("ckpt_hang")
    assert not side.consume("router_stale_metrics")
    assert not side.nan_armed() and not side.poison_at(3)
    assert not side.corrupt_params_at(3)


def test_fire_raise_is_one_shot(side):
    side.arm("raise@4")
    side.fire(3)
    with pytest.raises(side.FaultInjected, match="iteration 4"):
        side.fire(4)
    side.fire(4)  # disarmed once fired


def test_fire_sigterm_signals_this_process_once(side):
    got = []
    prev = signal.signal(signal.SIGTERM, lambda *a: got.append(1))
    try:
        side.arm("sigterm@2")
        side.fire(2)
        side.fire(2)
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert got == [1]


def test_check_fires_on_the_nth_call(side):
    side.arm("ckpt_write@3")
    side.check("ckpt_write")
    side.check("ckpt_write")
    with pytest.raises(side.FaultInjected, match="ckpt_write"):
        side.check("ckpt_write")
    side.check("ckpt_write")  # spent
    assert not side.armed()


def test_consume_fires_on_the_next_n_calls(side):
    side.arm("router_stale_metrics@2")
    assert [side.consume("router_stale_metrics") for _ in range(4)] == \
        [True, True, False, False]


def test_stall_sleeps_on_the_nth_call_with_its_variable(side, monkeypatch):
    slept = []
    monkeypatch.setattr(side.time, "sleep", slept.append)
    monkeypatch.setenv(side.CKPT_HANG_ENV_VAR, "0.25")
    monkeypatch.setenv(side.ROUTER_HANG_ENV_VAR, "0.5")
    monkeypatch.setenv(side.MIGRATE_HANG_ENV_VAR, "0.75")
    side.arm("ckpt_hang@2,router_replica_hang,migrate_hang")
    side.stall("ckpt_hang")
    assert slept == []
    side.stall("ckpt_hang")
    side.stall("router_replica_hang")
    side.stall("migrate_hang")
    side.stall("ckpt_hang")
    assert slept == [0.25, 0.5, 0.75]


def test_step_queries(side, monkeypatch):
    slept = []
    monkeypatch.setattr(side.time, "sleep", slept.append)
    monkeypatch.setenv(side.TRAIN_HANG_ENV_VAR, "7")
    monkeypatch.setenv(side.SKEW_ENV_VAR, "0.1")
    side.arm("nan@3-4,corrupt_params@5,train_hang@6,collective_skew@6,"
             "heartbeat_silence@1")
    assert side.nan_armed()
    assert [side.poison_at(i) for i in range(2, 6)] == [False, True, True, False]
    assert side.poison_at(3)  # nan is not one-shot
    assert side.corrupt_params_at(5) and not side.corrupt_params_at(5)
    side.train_stall(5)
    side.train_stall(6)
    side.train_stall(6)
    assert slept == [7.0, 0.1]
    assert side.heartbeat_silenced(1) and side.heartbeat_silenced(1)
    assert not side.heartbeat_silenced(0)


def test_serving_kinds_parse_and_answer_alike():
    """The serving kinds parse in the port and answer their queries as in
    JAX; nothing in the port fires them until their subsystems land."""
    spec = ("serve_corrupt@2,page_exhaust@3,prefix_corrupt@4,"
            "spec_drafter_crash@5,spec_reject_storm@6-7,constrain_dead_end@8,"
            "page_demote_fail@9,page_swap_corrupt@10,quality_drift@11,"
            "quality_nan@12,scale_flap@13,canary_regress")
    answers = []
    for mod in (jfaults, tfaults):
        mod.arm(spec)
        answers.append([
            mod.serve_corrupt_at(2), mod.serve_corrupt_at(2),
            mod.page_exhaust_at(3), mod.prefix_corrupt_at(4),
            mod.spec_drafter_crash_at(5), mod.spec_reject_storm_at(6),
            mod.spec_reject_storm_at(7), mod.spec_reject_storm_at(8),
            mod.constrain_dead_end_at(8), mod.page_demote_fail_at(9),
            mod.page_swap_corrupt_at(10), mod.quality_drift_at(11),
            mod.quality_nan_at(12), mod.scale_flap_at(13),
            mod.canary_regress_armed()])
    assert answers[0] == answers[1]
    assert answers[1][:2] == [True, False]


def test_the_port_ckpt_writer_finds_the_port_plan(tmp_path):
    from differential_transformer_replication_tpu_torch.train import ckpt_writer as cw

    assert cw._faults() is tfaults
    tfaults.arm("ckpt_write")
    with pytest.raises(tfaults.FaultInjected):
        cw.atomic_write(str(tmp_path / "f"), b"x")
    jfaults.arm("ckpt_write")  # the JAX plan does not reach the port
    cw.atomic_write(str(tmp_path / "f"), b"y")
    assert (tmp_path / "f").read_bytes() == b"y"
