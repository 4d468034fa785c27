"""Host-side span tracer emitting Chrome trace-event JSON.

Where a ``torch.profiler`` trace (utils/profiling.py) shows the DEVICE
timeline — kernels, copies, memory — this tracer shows the HOST side the
device view cannot: how long the trainer waited for data vs. dispatched
vs. blocked on results, or where one serving iteration spent its wall
time across schedule / prefill / decode / sample / emit. Both views
open in the same UI (Perfetto, https://ui.perfetto.dev, or
``chrome://tracing``).

Design points:

- **Complete events** (``"ph": "X"``): each span is one record with a
  start timestamp and duration, so nesting needs no begin/end pairing
  and a crashed process loses at most the spans still open.
- **Thread-safe**: spans record the emitting thread's id (``tid``), so
  the trainer loop, the serving engine thread, and HTTP handler threads
  each get their own track; the buffer append is lock-protected.
- **Bounded**: the in-memory buffer flushes to disk every
  ``flush_every`` events; ``close()`` finalizes a VALID JSON document
  (the JSON Array Format — a trailing ``]`` is optional for Perfetto,
  but we always write one so ``json.load`` round-trips in tests/tools).
- **Free when off**: :data:`NOOP_TRACER` is a singleton whose ``span``
  returns a shared no-op context manager — the instrumented hot loops
  pay one attribute call and no allocation when tracing is disabled.
- **Parented spans**: cross-process correlation rides the ordinary
  ``args`` dict — a span emitted with ``trace_id``/``span_id``/
  ``parent_id`` args (minted by obs/trace.py) joins the fleet-wide
  timeline ``tools/trace_stitch.py`` assembles; :meth:`complete` emits
  one over an already-measured interval (a request's submit→finish
  lifetime). NOOP-safe: the no-op tracer accepts the same calls.
- **Crash-safe tail**: every tracer registers an ``atexit`` close, so
  a process that exits without reaching its explicit closer (SIGTERM
  drain paths close eagerly) still terminates a valid JSON document.

A copy of the JAX package's ``obs/spans.py``: the same events, so
``tools/trace_stitch.py`` reads either package's trace.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import List, Optional


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer._emit_complete(
            self._name, self._t0, time.perf_counter(), self._args
        )
        return False


class SpanTracer:
    """Append-to-file Chrome tracer; see module docstring.

    ``path`` is the output ``.trace.json``. The file is (re)created at
    construction; events stream into it as the buffer fills, and
    :meth:`close` terminates the JSON array. ``process_name`` labels the
    track group in the viewer (trainer vs. serving engine).
    """

    def __init__(self, path: str, process_name: str = "host",
                 flush_every: int = 512):
        self.path = path
        self.pid = os.getpid()
        self._lock = threading.Lock()
        self._buf: List[dict] = []
        self._flush_every = max(1, flush_every)
        self._wrote_any = False
        self._closed = False
        # perf_counter has an arbitrary epoch; anchor it to wall clock
        # once so trace timestamps are meaningful across processes
        self._epoch = time.time() - time.perf_counter()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = open(path, "w", encoding="utf-8")
        self._fh.write("[\n")
        self._meta("process_name", {"name": process_name})
        self._meta("process_sort_index", {"sort_index": 0})
        # safety net: a SIGTERM'd (or plainly exiting) process must not
        # lose its buffered tail — the graceful-drain paths close
        # explicitly, and close() is idempotent, so double-closing here
        # is free
        atexit.register(self.close)

    # -- recording -----------------------------------------------------

    def span(self, name: str, **args) -> _Span:
        """``with tracer.span("decode", iteration=i): ...`` — one
        complete event covering the with-block, on the calling thread's
        track."""
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker (``"ph": "i"``)."""
        self._append({
            "name": name, "ph": "i", "s": "t",
            "ts": self._ts(time.perf_counter()),
            "pid": self.pid, "tid": threading.get_ident() % 2**31,
            **({"args": args} if args else {}),
        })

    def counter(self, name: str, **values) -> None:
        """A counter track sample (``"ph": "C"``) — queue depth, slot
        occupancy — rendered as a stacked area chart by the viewer."""
        self._append({
            "name": name, "ph": "C",
            "ts": self._ts(time.perf_counter()),
            "pid": self.pid, "tid": 0, "args": values,
        })

    def complete(self, name: str, t0: float, t1: float, **args) -> None:
        """One complete event over an ALREADY-MEASURED
        ``perf_counter`` interval — for spans whose start was recorded
        before the emitter knew whether (or where) they would end, e.g.
        a request's submit→finish lifetime stamped with its trace
        context (``trace_id``/``span_id``/``parent_id`` ride in
        ``args`` like any other; obs/trace.py mints them)."""
        self._emit_complete(name, t0, t1, args or None)

    # -- internals -----------------------------------------------------

    def _ts(self, perf_t: float) -> float:
        return (perf_t + self._epoch) * 1e6  # microseconds

    def _meta(self, name: str, args: dict) -> None:
        self._append({
            "name": name, "ph": "M", "pid": self.pid, "tid": 0,
            "args": args,
        })

    def _emit_complete(self, name: str, t0: float, t1: float,
                       args: Optional[dict]) -> None:
        ev = {
            "name": name, "ph": "X",
            "ts": self._ts(t0), "dur": max(0.0, (t1 - t0) * 1e6),
            "pid": self.pid, "tid": threading.get_ident() % 2**31,
        }
        if args:
            ev["args"] = args
        self._append(ev)

    def _append(self, event: dict) -> None:
        with self._lock:
            if self._closed:
                return
            self._buf.append(event)
            if len(self._buf) >= self._flush_every:
                self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._buf:
            return
        chunks = []
        for ev in self._buf:
            chunks.append(("," if self._wrote_any else "")
                          + json.dumps(ev, separators=(",", ":")) + "\n")
            self._wrote_any = True
        self._buf.clear()
        self._fh.write("".join(chunks))

    def flush(self) -> None:
        with self._lock:
            if not self._closed:
                self._flush_locked()
                self._fh.flush()

    def close(self) -> None:
        """Flush and terminate the JSON array; idempotent."""
        with self._lock:
            if self._closed:
                return
            self._flush_locked()
            self._fh.write("]\n")
            self._fh.close()
            self._closed = True


class _NoopTracer:
    """Shared do-nothing tracer so instrumentation sites never branch."""

    __slots__ = ()
    path = None

    def span(self, name: str, **args) -> _NoopSpan:
        return _NOOP_SPAN

    def instant(self, name: str, **args) -> None:
        pass

    def counter(self, name: str, **values) -> None:
        pass

    def complete(self, name: str, t0: float, t1: float, **args) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


NOOP_TRACER = _NoopTracer()
