"""The port's SLO math and monitor against the JAX package's.

``obs/slo.py`` of the port is a copy of the JAX package's over the port's
registry. The pure math (the error ratio at and between bucket edges,
the burn rate) gives JAX's numbers on the same inputs, and a
``SLOMonitor`` with the stock serving objectives, fed the same
observations through each package's registry, evaluates to the same
lifetime and window figures and renders the same ``slo_*`` series.
"""

from __future__ import annotations

import numpy as np
import pytest

from differential_transformer_replication_tpu.obs import registry as j_reg
from differential_transformer_replication_tpu.obs import slo as j_slo
from differential_transformer_replication_tpu_torch.obs import registry as t_reg
from differential_transformer_replication_tpu_torch.obs import slo as t_slo

BOUNDS = (0.1, 0.5, 1.0)
CUM = (60, 90, 99)


@pytest.mark.parametrize("count", [100, 0])
@pytest.mark.parametrize("threshold", [0.05, 0.1, 0.3, 0.5, 0.75, 1.0, 2.0])
def test_error_ratio_and_burn_equal_jax(threshold, count):
    je = j_slo.latency_error_ratio(BOUNDS, CUM, count, threshold)
    te = t_slo.latency_error_ratio(BOUNDS, CUM, count, threshold)
    assert te == je
    assert t_slo.good_count_under(BOUNDS, CUM, threshold) == \
        j_slo.good_count_under(BOUNDS, CUM, threshold)
    for target in (0.9, 0.99, 0.999, 1.0):
        assert t_slo.burn_rate(te, target) == j_slo.burn_rate(je, target)


def test_objectives_refuse_what_jax_refuses():
    for kw in ({"threshold_s": 0.0, "target": 0.9}, {"threshold_s": 1.0, "target": 1.5},
               {"threshold_s": 1.0, "target": 0.0}):
        for mod in (j_slo, t_slo):
            with pytest.raises(ValueError):
                mod.LatencyObjective("x", "h", **kw)
    with pytest.raises(ValueError):
        t_slo.SLOMonitor(t_reg.Registry(), latency=[
            t_slo.LatencyObjective("x", "h", 1.0, 0.9),
            t_slo.LatencyObjective("x", "h", 1.0, 0.9)])


def _feed(reg_mod, samples):
    """A registry with the serving engine's histograms and counters fed
    the same observations (two waves, the monitor evaluating after each)."""
    reg = reg_mod.Registry()
    ttft = reg.histogram("serving_ttft_seconds", "t")
    itl = reg.histogram("serving_itl_seconds", "i")
    cttft = reg.histogram("serving_class_ttft_seconds", "ct",
                          labelnames=("priority",))
    citl = reg.histogram("serving_class_itl_seconds", "ci",
                         labelnames=("priority",))
    done = reg.counter("serving_requests_completed_total", "c")
    rej = reg.counter("serving_requests_rejected_total", "r")
    late = reg.counter("serving_requests_deadline_expired_total", "d")

    def wave(part):
        for cls, t, gaps in part:
            ttft.observe(t)
            cttft.observe(t, priority=cls)
            for g in gaps:
                itl.observe(g)
                citl.observe(g, priority=cls)
            done.inc()
        rej.inc(2)
        late.inc(1)

    return reg, wave


def _samples(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        cls = ("high", "normal", "batch")[i % 3]
        out.append((cls, float(rng.gamma(2.0, 0.4)),
                    [float(g) for g in rng.gamma(2.0, 0.08, 5)]))
    return out


def test_monitor_evaluates_as_jax_does_on_the_same_registry():
    data = _samples(3)
    results = []
    for reg_mod, slo_mod in ((j_reg, j_slo), (t_reg, t_slo)):
        reg, wave = _feed(reg_mod, data)
        lat, avail = slo_mod.default_serving_objectives(
            ttft_threshold_s=1.0, itl_threshold_s=0.25, latency_target=0.99,
            availability_target=0.999)
        mon = slo_mod.SLOMonitor(reg, latency=lat, availability=avail)
        wave(data[:25])
        first = mon.evaluate()
        wave(data[25:])
        second = mon.evaluate()
        results.append((first, second, reg_mod.parse_exposition(reg.render())))
    (jf, js, jx), (tf, ts, tx) = results
    assert tf == jf and ts == js
    assert set(tf) == {"ttft", "itl", "ttft_high", "itl_high", "ttft_normal",
                       "itl_normal", "ttft_batch", "itl_batch", "availability"}
    assert ts["availability"]["error_ratio"] == pytest.approx(6 / 46)
    jslo = sorted((n, sorted(lab.items()), v) for n, lab, v in jx[1]
                  if n.startswith("slo_"))
    tslo = sorted((n, sorted(lab.items()), v) for n, lab, v in tx[1]
                  if n.startswith("slo_"))
    assert tslo == jslo and len(tslo) > 0
    assert {n: t for n, t in tx[0].items() if n.startswith("slo_")} == \
        {n: t for n, t in jx[0].items() if n.startswith("slo_")}


def test_histogram_from_samples_equal_jax():
    reg = t_reg.Registry()
    h = reg.histogram("y_seconds", "", labelnames=("replica",), buckets=(0.5, 2.0))
    for v, r in ((0.1, "a"), (0.1, "a"), (9.0, "a"), (0.7, "b"), (3.0, "b")):
        h.observe(v, replica=r)
    _, samples = t_reg.parse_exposition(reg.render())
    for match in (None, {"replica": "a"}, {"replica": "b"}):
        assert t_slo.histogram_from_samples(samples, "y_seconds", match) == \
            j_slo.histogram_from_samples(samples, "y_seconds", match)
    assert t_slo.histogram_from_samples(samples, "y_seconds") == \
        ([0.5, 2.0], [2.0, 3.0], 5.0)
