"""The port's request traces and event log against the JAX package's.

``obs/trace.py`` and ``obs/events.py`` of the port are copies of the JAX
package's stdlib modules with their imports re-pointed. The same
``traceparent`` strings must parse to the same contexts (malformed ones
to None in both), a child must keep its trace id, and the same
``EventLog`` calls must write the same lines into the same files,
rotation included.
"""

from __future__ import annotations

import os

import pytest

from differential_transformer_replication_tpu.obs import events as j_events
from differential_transformer_replication_tpu.obs import trace as j_trace
from differential_transformer_replication_tpu_torch.obs import events as t_events
from differential_transformer_replication_tpu_torch.obs import trace as t_trace

TID = "4bf92f3577b34da6a3ce929d0e0e4736"
SID = "00f067aa0ba902b7"

HEADERS = [
    f"00-{TID}-{SID}-01",
    f"00-{TID.upper()}-{SID}-00",              # case folds
    f"  00-{TID}-{SID}-01  ",                   # whitespace strips
    f"ab-{TID}-{SID}-01",                       # another hex version
    f"zz-{TID}-{SID}-01",                       # non-hex version
    f"00-{'0' * 32}-{SID}-01",                  # all-zero trace id
    f"00-{TID}-{'0' * 16}-01",                  # all-zero span id
    f"00-{TID[:-1]}-{SID}-01",                  # short trace id
    f"00-{TID}-{SID[:-1]}g-01",                 # non-hex span id
    f"00-{TID}-{SID}",                          # three fields
    "",
    None,
    42,
    ["00", TID, SID, "01"],
]


@pytest.mark.parametrize("value", HEADERS, ids=[repr(h)[:24] for h in HEADERS])
def test_traceparent_parses_as_jax_does(value):
    j, t = j_trace.parse_traceparent(value), t_trace.parse_traceparent(value)
    if j is None:
        assert t is None
        assert t_trace.from_payload({"traceparent": value},
                                    mint_if_absent=False) is None
        return
    assert (t.trace_id, t.span_id) == (j.trace_id, j.span_id)
    assert t.to_traceparent() == j.to_traceparent()
    assert t_trace.parse_traceparent(t.to_traceparent()) == t


def test_mint_child_and_span_args():
    ctx = t_trace.mint()
    assert t_trace.parse_traceparent(ctx.to_traceparent()) == ctx
    assert len(ctx.trace_id) == 32 and len(ctx.span_id) == 16
    child = ctx.child()
    assert child.trace_id == ctx.trace_id and child.span_id != ctx.span_id
    jctx = j_trace.TraceContext(ctx.trace_id, ctx.span_id)
    args, jargs = t_trace.child_span_args(ctx), j_trace.child_span_args(jctx)
    assert set(args) == set(jargs) == {"trace_id", "span_id", "parent_id"}
    assert (args["trace_id"], args["parent_id"]) == (ctx.trace_id, ctx.span_id)
    assert t_trace.instant_args(ctx) == j_trace.instant_args(jctx)
    # a body without a traceparent mints a fresh root
    fresh = t_trace.from_payload({})
    assert fresh is not None and fresh.trace_id != ctx.trace_id


def _drive(mod, path, **kw):
    log = mod.EventLog(str(path), process="replica", flush_every=2, **kw)
    for i in range(7):
        log.emit("request_finished", trace_id=TID, reason="length", tokens=i)
    log.emit("odd", value=object.__new__(_Unserializable))
    log.flush()
    log.emit("drained")
    log.close()
    log.emit("after_close")  # dropped, never raises
    return log


class _Unserializable:
    def __repr__(self):
        return "<unserializable>"


def _files(d):
    return {name: open(os.path.join(d, name)).read()
            for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("max_bytes,keep", [(0, 3), (120, 2), (120, 0)],
                         ids=["no-rotation", "rotate-keep-2", "rotate-keep-0"])
def test_event_log_writes_the_jax_lines(tmp_path, monkeypatch, max_bytes, keep):
    for mod in (j_events, t_events):
        monkeypatch.setattr(mod.time, "time", lambda: 1700000000.123456)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    _drive(j_events, jdir / "events.jsonl", max_bytes=max_bytes, keep=keep)
    _drive(t_events, tdir / "events.jsonl", max_bytes=max_bytes, keep=keep)
    jf, tf = _files(jdir), _files(tdir)
    assert tf == jf
    if max_bytes:
        assert len(tf) == 1 + keep  # rotated generations exist
    text = "".join(tf.values())
    assert "after_close" not in text and '"drained"' in text
    # keep=0 truncates at each rotation: the early lines are gone
    assert ('"<unserializable>"' in text) == (keep > 0)
    assert all(line.startswith('{"ts": 1700000000.123')
               for body in tf.values() for line in body.splitlines())


def test_event_log_refuses_bad_rotation_and_noop_sink(tmp_path):
    for kw in ({"max_bytes": -1}, {"keep": -1}):
        with pytest.raises(ValueError):
            t_events.EventLog(str(tmp_path / "e.jsonl"), **kw)
    assert t_events.open_event_log(None) is t_events.NOOP_EVENTS
    t_events.NOOP_EVENTS.emit("anything", x=1)
    log = t_events.open_event_log(str(tmp_path / "sub" / "e.jsonl"),
                                  process="replica", max_bytes=10, keep=1)
    assert isinstance(log, t_events.EventLog) and log.max_bytes == 10
    log.close()
