"""Cross-process trace context: mint, parse, and propagate request ids.

PR 4's span tracer (obs/spans.py) shows one PROCESS's timeline; PR 6's
router spreads one REQUEST over several processes (router pick, a
failed attempt on replica A, a retried attempt on replica B, prefill
chunks and decode iterations). Nothing correlated those events — this
module is the missing join key, Dapper-style:

- every request carries a :class:`TraceContext` — a fleet-unique
  ``trace_id`` plus the ``span_id`` of the operation that currently
  owns it;
- the context travels between processes as a ``traceparent`` string
  (the W3C Trace Context shape, ``00-<trace>-<span>-01``) in the
  request's JSON body — no new headers, no proxy cooperation needed;
- each hop derives a :meth:`child` context (same ``trace_id``, fresh
  ``span_id``) and stamps its spans/instants with ``trace_id`` /
  ``span_id`` / ``parent_id`` args, so ``tools/trace_stitch.py`` can
  merge per-process trace files into one timeline and follow one
  request across lanes.

Everything here is host-side strings — trace state never reaches a
jitted function, so tracing adds ZERO recompiles (pinned by
tests/test_trace.py). Stdlib only: the router and fleet tools import
this without jax.

A copy of the JAX package's ``obs/trace.py``: the same ``traceparent``
shape and span args, so one trace id follows a request through either
package's server.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Optional

_HEX = frozenset("0123456789abcdef")

# W3C trace-context field widths (hex chars)
_TRACE_LEN = 32
_SPAN_LEN = 16
_VERSION = "00"
_FLAGS = "01"  # sampled


def mint_trace_id() -> str:
    """A fleet-unique 128-bit trace id (32 lowercase hex chars)."""
    return secrets.token_hex(_TRACE_LEN // 2)


def mint_span_id() -> str:
    """A 64-bit span id (16 lowercase hex chars)."""
    return secrets.token_hex(_SPAN_LEN // 2)


def _valid_hex(s: str, n: int) -> bool:
    return len(s) == n and set(s) <= _HEX and set(s) != {"0"}


@dataclass(frozen=True)
class TraceContext:
    """One request's position in its trace: the shared ``trace_id``
    plus the ``span_id`` of the current owning operation (what child
    spans parent to)."""

    trace_id: str
    span_id: str

    def child(self) -> "TraceContext":
        """Derive the context for a sub-operation: same trace, fresh
        span id. The caller's ``span_id`` becomes the child's
        ``parent_id`` in emitted span args."""
        return TraceContext(self.trace_id, mint_span_id())

    def to_traceparent(self) -> str:
        """Serialize for the wire (the W3C ``traceparent`` shape)."""
        return f"{_VERSION}-{self.trace_id}-{self.span_id}-{_FLAGS}"


def mint() -> TraceContext:
    """A brand-new root context (the router — or a replica hit
    directly — mints one for requests that arrive without)."""
    return TraceContext(mint_trace_id(), mint_span_id())


def parse_traceparent(value) -> Optional[TraceContext]:
    """Parse a ``traceparent`` string into a :class:`TraceContext`;
    returns None for anything malformed (an unparseable header must
    degrade into a fresh trace, never a failed request)."""
    if not isinstance(value, str):
        return None
    parts = value.strip().lower().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if version != _VERSION and not (
        len(version) == 2 and set(version) <= _HEX
    ):
        return None
    if not _valid_hex(trace_id, _TRACE_LEN):
        return None
    if not _valid_hex(span_id, _SPAN_LEN):
        return None
    return TraceContext(trace_id, span_id)


def child_span_args(ctx: TraceContext) -> dict:
    """Args for a NEW span emitted under ``ctx``: fresh ``span_id``,
    parented to the context's current span."""
    child = ctx.child()
    return {"trace_id": ctx.trace_id, "span_id": child.span_id,
            "parent_id": ctx.span_id}


def instant_args(ctx: TraceContext) -> dict:
    """Args for a zero-duration marker under ``ctx`` (markers need no
    span id of their own — they hang off the owning span)."""
    return {"trace_id": ctx.trace_id, "parent_id": ctx.span_id}


def from_payload(payload: dict,
                 mint_if_absent: bool = True) -> Optional[TraceContext]:
    """Extract (or mint) the trace context of one JSON request body.
    The ``traceparent`` field is the wire contract shared by the
    router, the replica server, and any client that wants to follow
    its own request."""
    ctx = parse_traceparent(payload.get("traceparent"))
    if ctx is None and mint_if_absent:
        ctx = mint()
    return ctx
