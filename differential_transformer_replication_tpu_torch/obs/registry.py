"""Thread-safe metrics registry with a Prometheus text-exposition writer.

The smallest useful subset of the Prometheus client model, stdlib-only
(the container must not grow dependencies):

- :class:`Counter` — monotonically increasing float (``inc``). ``set``
  exists for compatibility shims (serving/engine.py's stats mapping
  exposes ``+=`` through it) but instrumented code should ``inc``.
- :class:`Gauge` — settable value with ``set``/``inc``/``dec`` and a
  ``set_max`` watermark helper (device-memory high-water mark).
- :class:`Histogram` — fixed cumulative buckets + sum + count; the
  preset :data:`LATENCY_BUCKETS_S` ladder covers sub-ms sampling ticks
  through multi-minute prefill storms.

Labels: a metric created with ``labelnames`` is a family; calling
``.labels(k=v)`` returns (creating on first use) the child for that
label set. Unlabeled metrics are their own single child.

Every mutation takes the metric's own lock, so concurrent increments
from the engine thread and HTTP handler threads never tear; a
whole-registry snapshot (``render`` / ``snapshot``) takes the registry
lock so the metric SET is stable while iterating (per-child values are
each read atomically — the standard Prometheus consistency level).

A copy of the JAX package's ``obs/registry.py``: the same metric types,
exposition bytes and parser, and the same ``build_info`` label names, so
one fleet scrape reads both packages. The port's trainer passes the
torch version as ``build_info``'s ``jax_version`` label; the default
resolution reads torch's package metadata.
"""

from __future__ import annotations

import math
import re
import threading
import time
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

# Latency ladder in seconds: 0.5 ms .. 60 s. Wide enough for sampling
# ticks, decode iterations, prefill chunks, and whole train steps.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:"
)


def _check_name(name: str) -> str:
    if not name or name[0].isdigit() or not set(name) <= _NAME_OK:
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(text: str) -> str:
    return (
        text.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 2**53:
        return str(int(v))
    return repr(float(v))


def _labels_key(
    labelnames: Sequence[str], labels: dict
) -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"expected labels {tuple(labelnames)}, got {tuple(labels)}"
        )
    return tuple(str(labels[n]) for n in labelnames)


def _render_labels(labelnames: Sequence[str],
                   values: Sequence[str],
                   extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = [
        f'{n}="{_escape_label_value(v)}"'
        for n, v in zip(labelnames, values)
    ]
    if extra is not None:
        pairs.append(f'{extra[0]}="{_escape_label_value(extra[1])}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Child:
    """One (metric, label-set) time series; scalar value + lock."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _Metric:
    """Common family machinery: child management by label set."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()) -> None:
        self.name = _check_name(name)
        self.help = help
        self.labelnames = tuple(labelnames)
        for ln in self.labelnames:
            _check_name(ln)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **labels):
        key = _labels_key(self.labelnames, labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"metric {self.name} has labels {self.labelnames}; "
                "call .labels(...) first"
            )
        return self._children[()]

    def _items(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


class Counter(_Metric):
    kind = "counter"

    def _make_child(self) -> _Child:
        return _Child()

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up (inc {amount})")
        child = self.labels(**labels) if labels else self._default()
        with child._lock:
            child._value += amount

    def set(self, value: float, **labels) -> None:
        """Compat shim for mapping-style stats (``stats[k] = v``); only
        monotone assignments make sense for a counter and callers that
        rewind one get what they asked for."""
        child = self.labels(**labels) if labels else self._default()
        with child._lock:
            child._value = float(value)

    @property
    def value(self) -> float:
        return self._default().value

    def render(self, out: List[str]) -> None:
        out.append(f"# HELP {self.name} {_escape_help(self.help)}")
        out.append(f"# TYPE {self.name} counter")
        for key, child in self._items():
            lbl = _render_labels(self.labelnames, key)
            out.append(f"{self.name}{lbl} {_fmt_value(child.value)}")


class Gauge(_Metric):
    kind = "gauge"

    def _make_child(self) -> _Child:
        return _Child()

    def set(self, value: float, **labels) -> None:
        child = self.labels(**labels) if labels else self._default()
        with child._lock:
            child._value = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        child = self.labels(**labels) if labels else self._default()
        with child._lock:
            child._value += amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def set_max(self, value: float, **labels) -> None:
        """Watermark update: keep the max of the current and new value."""
        child = self.labels(**labels) if labels else self._default()
        with child._lock:
            if value > child._value:
                child._value = float(value)

    @property
    def value(self) -> float:
        return self._default().value

    def render(self, out: List[str]) -> None:
        out.append(f"# HELP {self.name} {_escape_help(self.help)}")
        out.append(f"# TYPE {self.name} gauge")
        for key, child in self._items():
            lbl = _render_labels(self.labelnames, key)
            out.append(f"{self.name}{lbl} {_fmt_value(child.value)}")


class _HistChild:
    __slots__ = ("_lock", "counts", "sum", "count")

    def __init__(self, n_buckets: int) -> None:
        self._lock = threading.Lock()
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = LATENCY_BUCKETS_S) -> None:
        bounds = sorted(float(b) for b in buckets)
        if not bounds or any(
            b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])
        ):
            raise ValueError(f"buckets must be strictly increasing: {buckets}")
        self.buckets = tuple(bounds)  # upper bounds, +Inf implicit
        super().__init__(name, help, labelnames)

    def _make_child(self) -> _HistChild:
        return _HistChild(len(self.buckets) + 1)

    def observe(self, value: float, **labels) -> None:
        child = self.labels(**labels) if labels else self._default()
        i = bisect_left(self.buckets, value)
        with child._lock:
            child.counts[i] += 1
            child.sum += value
            child.count += 1

    def snapshot(self, **labels) -> dict:
        """(cumulative bucket counts, sum, count) for one child."""
        child = self.labels(**labels) if labels else self._default()
        with child._lock:
            counts, total, n = list(child.counts), child.sum, child.count
        cum, acc = [], 0
        for c in counts:
            acc += c
            cum.append(acc)
        return {"buckets": self.buckets, "cumulative": cum,
                "sum": total, "count": n}

    def render(self, out: List[str]) -> None:
        out.append(f"# HELP {self.name} {_escape_help(self.help)}")
        out.append(f"# TYPE {self.name} histogram")
        for key, child in self._items():
            with child._lock:
                counts = list(child.counts)
                total, n = child.sum, child.count
            acc = 0
            for bound, c in zip(self.buckets, counts):
                acc += c
                lbl = _render_labels(
                    self.labelnames, key, extra=("le", _fmt_value(bound))
                )
                out.append(f"{self.name}_bucket{lbl} {acc}")
            lbl = _render_labels(self.labelnames, key, extra=("le", "+Inf"))
            out.append(f"{self.name}_bucket{lbl} {n}")
            lbl = _render_labels(self.labelnames, key)
            out.append(f"{self.name}_sum{lbl} {_fmt_value(total)}")
            out.append(f"{self.name}_count{lbl} {n}")


class Registry:
    """Named metric collection; get-or-create semantics so instrumented
    modules can share one registry without import-order coupling."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or (
                    existing.labelnames != tuple(labelnames)
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}{existing.labelnames}"
                    )
                return existing
            metric = cls(name, help, labelnames, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS_S) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4 (what ``GET /metrics``
        returns; ``promtool check metrics``-clean)."""
        out: List[str] = []
        for metric in self.metrics():
            metric.render(out)
        return "\n".join(out) + "\n" if out else ""


class StatsMap:
    """Dict-compatible view over a fixed set of registry counters.

    Keeps call sites (and the ``/health`` JSON shape) that grew around a
    plain stats dict working — ``stats["completed"]``, ``dict(stats)``,
    ``"rejected" in stats`` — while the authoritative values live in
    Prometheus counters, so the ``/metrics`` exposition and the stats
    snapshot can never disagree. Mutation through :meth:`inc` is atomic
    (the counter's own lock); ``stats[k] = v`` / ``stats[k] += 1`` stay
    supported for compatibility but the read-modify-write of ``+=`` is
    only safe on a single thread (the engine loop) — concurrent writers
    must use :meth:`inc`.
    """

    def __init__(self, registry: "Registry", spec: dict) -> None:
        """``spec``: ordered ``{key: (metric_name, help)}``."""
        self._counters: Dict[str, Counter] = {
            key: registry.counter(name, help)
            for key, (name, help) in spec.items()
        }

    def inc(self, key: str, amount: float = 1.0) -> None:
        self._counters[key].inc(amount)

    def snapshot(self) -> Dict[str, int]:
        """Point-in-time copy; each value read under its counter's
        lock (no torn reads from a mid-increment engine thread)."""
        return {k: int(c.value) for k, c in self._counters.items()}

    # -- mapping compatibility ----------------------------------------

    def __getitem__(self, key: str) -> int:
        return int(self._counters[key].value)

    def __setitem__(self, key: str, value: float) -> None:
        self._counters[key].set(value)

    def __contains__(self, key: str) -> bool:
        return key in self._counters

    def __iter__(self):
        return iter(self._counters)

    def __len__(self) -> int:
        return len(self._counters)

    def keys(self):
        return self._counters.keys()

    def items(self):
        return [(k, int(c.value)) for k, c in self._counters.items()]

    def __repr__(self) -> str:
        return f"StatsMap({self.snapshot()!r})"


CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


# -- reading expositions back (the scrape side) -------------------------
#
# The router aggregates its replicas' /metrics bodies into one fleet
# exposition, and tools/slo_report.py computes burn rates from a
# scraped snapshot — both need to PARSE the format this module writes.
# One canonical parser here keeps writer and reader in lockstep.

_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label_value(text: str) -> str:
    out, i = [], 0
    while i < len(text):
        c = text[i]
        if c == "\\" and i + 1 < len(text):
            nxt = text[i + 1]
            out.append("\n" if nxt == "n" else nxt)
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_value(raw: str) -> float:
    if raw == "+Inf":
        return math.inf
    if raw == "-Inf":
        return -math.inf
    return float(raw)  # "NaN" parses natively


def parse_exposition(
    text: str,
) -> Tuple[Dict[str, str], List[Tuple[str, Dict[str, str], float]]]:
    """Parse a text exposition into ``(types, samples)``:
    ``types[name] = kind`` from ``# TYPE`` lines, ``samples`` a list of
    ``(sample_name, labels, value)``. Malformed lines are skipped —
    a scrape of a foreign (or half-written) endpoint must degrade to
    partial data, not an exception."""
    types: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) == 4:
                types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        labels: Dict[str, str] = {}
        if m.group(2):
            for lm in _LABEL_RE.finditer(m.group(2)):
                labels[lm.group(1)] = _unescape_label_value(lm.group(2))
        try:
            samples.append((m.group(1), labels, _parse_value(m.group(3))))
        except ValueError:
            continue
    return types, samples


def set_build_info(registry: "Registry", role: str,
                   config_hash: str = "",
                   version: Optional[str] = None,
                   start_time: Optional[float] = None) -> None:
    """Stamp a registry with process identity: a ``build_info`` info
    gauge (constant 1; the identity rides the labels, the standard
    Prometheus idiom) plus ``process_start_time_seconds``. With these,
    an aggregated fleet scrape (router ``/fleet/metrics``) can tell a
    router from a replica from a trainer, spot config drift between
    replicas, and detect silent restarts (start time moved).

    ``role`` is ``router`` | ``replica`` | ``trainer``. ``version`` is
    the framework version (the label keeps the JAX package's name,
    ``jax_version``); resolved from torch's package metadata when omitted
    — WITHOUT importing torch, so a stdlib-only process can stamp itself.
    """
    if version is None:
        try:
            from importlib.metadata import version as _pkg_version

            version = _pkg_version("torch")
        except Exception:
            version = "unknown"
    registry.gauge(
        "build_info",
        "Process identity (constant 1; role/config/version in labels).",
        labelnames=("role", "config_hash", "jax_version"),
    ).set(1, role=role, config_hash=config_hash, jax_version=version)
    registry.gauge(
        "process_start_time_seconds",
        "Unix time this process's registry was stamped (a moved value "
        "across scrapes of one target means a restart).",
    ).set(time.time() if start_time is None else start_time)
