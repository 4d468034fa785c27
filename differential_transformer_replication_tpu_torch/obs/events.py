"""Structured JSONL event log: the fleet's append-only flight record.

The router, the fleet supervisor, and the serving server each grew ad
hoc ``print(..., file=sys.stderr)`` forensics — useful to a human
tailing one process, useless for answering "what happened to request
X" across a fleet. This module unifies them into one machine-readable
shape: one JSON object per line, every record carrying

- ``ts`` — unix wall-clock seconds (joinable across processes),
- ``event`` — a stable snake_case name (``request_finished``,
  ``replica_ejected``, ``rolling_drain``, ...),
- ``process`` — who wrote it (``router`` / ``replica`` / ``fleet``),
- whatever fields the emitter adds — request-scoped events carry
  ``trace_id``, so ``grep trace_id events.jsonl`` and
  ``tools/trace_stitch.py`` tell the same story from two angles.

Same durability posture as obs/spans.py: buffered appends under a
lock, explicit ``flush``/``close`` wired into the graceful-drain and
SIGTERM paths, and an ``atexit`` safety net so an un-drained exit
still lands the buffered tail. Append mode — supervisor relaunches
extend the log rather than truncating the forensics they exist to
explain. Stdlib only; :data:`NOOP_EVENTS` keeps instrumentation sites
branch-free when logging is off.

Size-based rotation (``max_bytes`` > 0): a long-lived fleet must not
grow one unbounded file. Rotation happens at FLUSH boundaries only —
every write is a batch of whole lines, so neither the active file nor
any rotated generation ever ends in a torn line. The cascade is
``events.jsonl`` -> ``.1`` -> ... -> ``.keep`` via atomic
``os.replace`` (the oldest generation falls off); ``keep=0`` just
truncates. A crash between renames leaves at worst a duplicated
generation — never a missing or torn one.

A copy of the JAX package's ``obs/events.py``: the same record shape
and rotation, so one fleet's logs read alike from either package.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import List, Optional


class EventLog:
    """Append-only JSONL event sink; see module docstring."""

    def __init__(self, path: str, process: str = "",
                 flush_every: int = 64, max_bytes: int = 0,
                 keep: int = 3):
        if max_bytes < 0 or keep < 0:
            raise ValueError(
                f"max_bytes/keep must be >= 0, got {max_bytes}/{keep}"
            )
        self.path = path
        self.process = process
        self.max_bytes = int(max_bytes)  # 0 = rotation off
        self.keep = int(keep)
        self._lock = threading.Lock()
        self._buf: List[str] = []
        self._flush_every = max(1, flush_every)
        self._closed = False
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = open(path, "a", encoding="utf-8")
        atexit.register(self.close)

    def emit(self, event: str, **fields) -> None:
        """Append one record; ``ts`` and ``process`` are added for the
        caller. Non-JSON-serializable field values are stringified —
        a forensic log must never throw back at its emitter."""
        record = {"ts": round(time.time(), 3), "event": event}
        if self.process:
            record["process"] = self.process
        record.update(fields)
        try:
            line = json.dumps(record)
        except (TypeError, ValueError):
            line = json.dumps({
                k: v if isinstance(v, (str, int, float, bool, type(None)))
                else repr(v)
                for k, v in record.items()
            })
        with self._lock:
            if self._closed:
                return
            self._buf.append(line)
            if len(self._buf) >= self._flush_every:
                self._flush_locked()

    def _flush_locked(self) -> None:
        if self._buf:
            self._fh.write("\n".join(self._buf) + "\n")
            self._buf.clear()
        if self.max_bytes and self._fh.tell() >= self.max_bytes:
            self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Close, cascade the generations, reopen fresh. Flush-boundary
        only, so every file involved holds whole lines."""
        self._fh.close()
        if self.keep > 0:
            for i in range(self.keep - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i + 1}")
            os.replace(self.path, f"{self.path}.1")
        else:
            os.remove(self.path)
        self._fh = open(self.path, "a", encoding="utf-8")

    def flush(self) -> None:
        with self._lock:
            if not self._closed:
                self._flush_locked()
                self._fh.flush()

    def close(self) -> None:
        """Flush and close; idempotent (the atexit net double-closes)."""
        with self._lock:
            if self._closed:
                return
            self._flush_locked()
            self._fh.close()
            self._closed = True


class _NoopEventLog:
    """Shared do-nothing sink so emit sites never branch."""

    __slots__ = ()
    path = None
    process = ""

    def emit(self, event: str, **fields) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


NOOP_EVENTS = _NoopEventLog()


def open_event_log(path: Optional[str], process: str = "",
                   max_bytes: int = 0, keep: int = 3):
    """``EventLog`` when a path is given, else the shared no-op — the
    one-liner every CLI flag funnels through. ``max_bytes``/``keep``
    arm size-based rotation (module docstring)."""
    if not path:
        return NOOP_EVENTS
    return EventLog(path, process=process, max_bytes=max_bytes, keep=keep)
