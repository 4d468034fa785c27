"""Predictive admission of the port (serving/admission.py) against the
JAX package's, on the CPU.

Both modules are pure host code, so the port's copy is held to the JAX
one exactly, in one process, on the same inputs: the math functions on
a grid that includes negative gauges, a missing rate and unknown
priority classes; and two ``AdmissionController``s fed the same
``/metrics`` expositions at the same injected clock readings (a replica
restart whose counter goes backwards, a replica without per-class
gauges, samples closer than the rate's floor, a forgotten replica) give
the same rates, predicted waits, ``Retry-After`` values, shed rulings
and gauge expositions. Behind the router, a proactive shed is the same
typed 503 with the same honest ``Retry-After`` in both packages.
"""

from __future__ import annotations

import itertools
import random
import re

import pytest

from differential_transformer_replication_tpu.config import RouterConfig as JRouterConfig
from differential_transformer_replication_tpu.obs.registry import Registry as JRegistry
from differential_transformer_replication_tpu.serving import admission as jadm
from differential_transformer_replication_tpu.serving.router import Router as JRouter
from differential_transformer_replication_tpu_torch.config import RouterConfig
from differential_transformer_replication_tpu_torch.obs.registry import Registry
from differential_transformer_replication_tpu_torch.serving import admission as tadm
from differential_transformer_replication_tpu_torch.serving.router import Router

CLASSES = ("high", "normal", "batch", "weird")


def _expo(high=0, normal=0, batch=0, running=0, completed=0, by_class=True):
    """One replica's /metrics body, admission-relevant families only
    (as the JAX package's tests/test_autoscaler.py builds it)."""
    lines = []
    if by_class:
        lines += [f'serving_queue_depth_by_class{{priority="high"}} {high}',
                  f'serving_queue_depth_by_class{{priority="normal"}} {normal}',
                  f'serving_queue_depth_by_class{{priority="batch"}} {batch}']
    lines += [f"serving_queue_depth {high + normal + batch}",
              f"serving_slot_occupancy {running}",
              f"serving_requests_completed_total {completed}",
              "# TYPE unrelated_total counter", "unrelated_total 3"]
    return "\n".join(lines) + "\n"


def test_constants_equal():
    assert tadm.CLASS_WAIT_MULT == jadm.CLASS_WAIT_MULT


QUEUED = [{}, {"high": 1.0, "normal": 3.0, "batch": 2.0}, {"normal": -5.0},
          {"weird": 4.0, "batch": 1.5}, {"high": -1.0, "batch": 7.0}]


@pytest.mark.parametrize("queued", QUEUED)
def test_backlog_ahead_equals_jax(queued):
    for running, prio in itertools.product((-1.0, 0.0, 4.0), CLASSES):
        assert (tadm.backlog_ahead(queued, running, prio)
                == jadm.backlog_ahead(queued, running, prio)), (queued, running, prio)


def test_wait_and_retry_after_equal_jax():
    for backlog, rate in itertools.product((-3.0, 0.0, 2.5, 10.0),
                                           (None, -1.0, 0.0, 0.5, 2.0)):
        assert tadm.predicted_wait_s(backlog, rate) == jadm.predicted_wait_s(backlog, rate)
    for wait, fb, cap in itertools.product((None, 0.0, 0.1, 12.5, 1000.0),
                                           (0.2, 3.0), (0.5, 30.0)):
        assert (tadm.honest_retry_after(wait, fb, cap)
                == jadm.honest_retry_after(wait, fb, cap)), (wait, fb, cap)


def _script():
    """(replica, exposition, now) rows of one fleet's probe history."""
    return [
        ("r0", _expo(completed=0), 0.0),
        ("r1", _expo(normal=2, running=1, completed=4), 0.5),
        ("r0", _expo(high=1, normal=3, batch=2, running=4, completed=20), 10.0),
        ("r0", _expo(high=1, normal=3, batch=2, running=4, completed=21), 10.01),  # < floor
        ("r1", _expo(normal=5, running=2, completed=30), 12.0),
        ("r2", _expo(normal=7, running=3, completed=1, by_class=False), 13.0),
        ("r0", _expo(completed=5), 20.0),  # relaunch: counter went backwards
        ("forget", "r1", 21.0),
        ("r2", _expo(batch=9, running=8, completed=40, by_class=False), 25.0),
        ("r0", _expo(high=4, normal=1, batch=30, running=8, completed=60), 30.0),
    ]


def _rulings(ac, cfg):
    out = {"rate": ac.service_rate()}
    for prio in CLASSES:
        d = ac.admit(prio)
        out[prio] = (ac.predicted_wait(prio), ac.retry_after_s(prio),
                     d.admitted, d.retry_after_s, d.predicted_wait_s, d.reason)
    return out


@pytest.mark.parametrize("bound", [0.0, 0.8, 2.5])
def test_controllers_agree_on_the_same_expositions(bound):
    kw = dict(admission_wait_bound_s=bound, admission_rate_halflife_s=4.0,
              shed_retry_after_s=3.0, admission_max_retry_after_s=12.0)
    tcfg, jcfg = RouterConfig(**kw), JRouterConfig(**kw)
    treg, jreg = Registry(), JRegistry()
    tac = tadm.AdmissionController(tcfg, registry=treg, now_fn=lambda: 0.0)
    jac = jadm.AdmissionController(jcfg, registry=jreg, now_fn=lambda: 0.0)
    assert _rulings(tac, tcfg) == _rulings(jac, jcfg)  # unmeasured
    sheds = 0
    for row in _script():
        if row[0] == "forget":
            tac.forget_replica(row[1])
            jac.forget_replica(row[1])
        else:
            tac.observe_replica(*row)
            jac.observe_replica(*row)
        got, want = _rulings(tac, tcfg), _rulings(jac, jcfg)
        assert got == want, row
        sheds += sum(not got[p][2] for p in CLASSES)
        assert treg.render() == jreg.render()
    assert tac.service_rate() is not None
    # a bound sheds somewhere in the history, and none sheds without one
    assert (sheds > 0) == (bound > 0)


@pytest.mark.parametrize("prio", ["normal", "high", "batch"])
def test_router_admission_shed_equals_jax(prio):
    """Behind the router: the proactive shed (or, for a class within its
    bound, the no_replica shed) is the same status, code and honest
    Retry-After in both packages."""
    out = []
    for router_cls, cfg_cls in ((Router, RouterConfig), (JRouter, JRouterConfig)):
        router = router_cls(["http://127.0.0.1:19000"],
                            cfg_cls(admission_wait_bound_s=2.5,
                                    wait_for_replica_s=0.0),
                            rng=random.Random(0))
        router.admission.observe_replica("r", _expo(completed=0), now=0.0)
        router.admission.observe_replica(
            "r", _expo(normal=8, running=2, completed=10), now=10.0)
        status, body, headers = router.handle_generate(
            {"prompt_ids": [1], "priority": prio})
        shed = re.findall(r"router_(?:admission_)?shed_total.*", router.registry.render())
        out.append((status, body["code"], body["error"], headers, shed))
        router.close()
    assert out[0] == out[1]
    assert out[0][0] == 503
