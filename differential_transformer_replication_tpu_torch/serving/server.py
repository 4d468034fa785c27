"""Serving front-ends of the port over the continuous-batching engine.

Counterpart of the JAX package's serving/server.py for this slice:

- :class:`EngineRunner` — a background thread that owns the
  :class:`ServingEngine` (which is not thread-safe) and drains it:
  callers enqueue through a lock, the loop moves requests into the
  engine and steps until idle, then parks on a condition variable. It
  also supervises: a crashed step fails the in-flight requests with a
  typed, retriable :class:`EngineCrashError`, rebuilds the slot pool
  after a bounded exponential backoff, and keeps serving; queued
  requests survive the restart. A wall-time watchdog marks the engine
  "degraded" when a step exceeds ``ServingConfig.step_time_budget_s``.
- :class:`ServingClient` — blocking ``generate()`` per caller thread;
  n callers = n concurrent streams batched by the engine.
- :func:`serve` / ``python -m differential_transformer_replication_tpu_torch.serving.server``
  — a stdlib ``http.server`` JSON endpoint: ``POST /generate`` with
  ``{"prompt_ids": [...]}`` or, when the server was started with a
  tokenizer (``--tokenizer DIR``), ``{"prompt": "text"}``, whose reply
  carries the decoded ``"text"`` too (same request and reply keys as
  the JAX server, ``"quality"`` included with quality telemetry on),
  ``GET /health`` for engine state and stats, with ``kv_pages`` (the
  paged pool and its prefix cache) and ``spec`` (speculative decoding)
  when those are on, ``GET /ready``: 200 while the runner accepts work,
  503 with ``Retry-After`` while it drains, restarts or has failed
  (:meth:`EngineRunner.accepting`), and ``GET /metrics``: the engine's
  registry in the Prometheus text format, the ``slo_*`` burn-rate
  gauges refreshed on each scrape. A request the page pool cannot take
  answers HTTP 503 ``page_pool_exhausted``. ``/health`` carries
  ``host_tier`` with the host tier on.
- Live migration (serving/migrate.py), as in the JAX server: ``GET
  /inflight`` lists each in-flight request's emitted tokens (with the
  ``journal_id`` its ``/generate`` carried); ``POST /migrate/export``
  ``{request_id, dest, migrate_id, budget_s}`` moves an ACTIVE request's
  decode state to the peer at ``dest`` (probe its radix tree, export,
  ``POST dest/migrate/import``, then release the slot), and the blocked
  ``/generate`` answers 200 ``{"code": "migrated", "dest",
  "migrate_id"}``; ``POST /migrate/await {migrate_id}`` on the peer
  returns the whole continuation in ``/generate``'s shape;
  ``POST /migrate/probe {prompt_ids}`` answers ``cached_pages``. HTTP
  handlers reach the engine only through
  :meth:`EngineRunner.run_on_engine`, between steps; the network legs of
  a migration run on the handler's thread, so the other slots decode on.

A request's ``traceparent`` field (W3C shape, obs/trace.py) gives the
engine its trace context, so the span trace (``--trace-path``) stamps
the request's lifecycle with its trace id; a request without one gets a
fresh id. Every reply carries ``trace_id``. ``--event-log`` appends
``request_received``, ``request_finished`` and ``request_failed`` lines
and ``drained`` at shutdown (obs/events.py).

``/generate`` takes the JAX server's request fields: ``json_schema``
(an object or its JSON text), ``regex`` or ``choices`` constrain the
output (serving/constrain.py); ``repetition_penalty``,
``presence_penalty`` and ``frequency_penalty`` run the logit pipeline;
``logprobs`` N echoes ``token_logprobs`` and ``top_logprobs`` in the
reply; ``key_offset`` replays a continuation and ``journal_id`` tags it.
A constraint that does not compile answers 400
``constraint_compile_failed``, one that dead-ends mid-decode 400
``constraint_dead_end`` with ``partial_tokens``; ``/health`` carries
``constraints``. ``--spec-mode model --spec-drafter-ckpt DIR`` loads a
drafter through the same verified (and, with ``--quantize-weights
int8``, quantized) path as the target.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence

from differential_transformer_replication_tpu_torch.obs.events import NOOP_EVENTS
from differential_transformer_replication_tpu_torch.obs.registry import (
    CONTENT_TYPE as METRICS_CONTENT_TYPE,
)
from differential_transformer_replication_tpu_torch.obs.trace import (
    from_payload as trace_from_payload,
)
from differential_transformer_replication_tpu_torch.serving.constrain import (
    ConstraintCompileError,
    ConstraintDeadEndError,
)
from differential_transformer_replication_tpu_torch.serving.engine import (
    EngineCrashError,
    ServingEngine,
)
from differential_transformer_replication_tpu_torch.serving.migrate import (
    MigrateExportError,
    MigratePayloadError,
    from_wire,
    to_wire,
)
from differential_transformer_replication_tpu_torch.serving.pages import (
    PagePoolExhaustedError,
)
from differential_transformer_replication_tpu_torch.serving.request import (
    RequestOutput,
    SamplingParams,
)
from differential_transformer_replication_tpu_torch.serving.retry import (
    http_post_json_with_retries,
)
from differential_transformer_replication_tpu_torch.serving.scheduler import (
    DeadlineExceededError,
    QueueFullError,
)

# /generate body keys the server serves; any other key is refused with a
# 400 naming it. LATER_SLICE_KEYS (served by a later slice) is empty now.
# ``session_id`` is the router's affinity key: the router forwards the
# client's body whole, and the server accepts and ignores the key, as
# the JAX server does
GENERATE_KEYS = (
    "prompt_ids", "max_new_tokens", "temperature", "top_k", "seed",
    "eos_token_id", "stop", "priority", "deadline_s", "timeout",
    "traceparent", "draft_len", "prompt", "key_offset", "journal_id",
    "json_schema", "regex", "choices", "repetition_penalty",
    "presence_penalty", "frequency_penalty", "logprobs", "session_id",
)
LATER_SLICE_KEYS = ()

# the JAX server's flags that wait for a later slice -> the ROADMAP item
LATER_FLAGS = {
    "--profile-every": "the continuous device profile (ROADMAP Queue A: "
                       "tooling and analysis, item 10)",
    "--profile-dir": "the continuous device profile (ROADMAP Queue A: "
                     "tooling and analysis, item 10)",
}


class ShuttingDownError(RuntimeError):
    """Admission refused: the server is draining (or already stopped)."""

    retriable = True


class MigratedError(RuntimeError):
    """Settle marker, not a failure: the request's live decode state
    moved to a peer replica mid-flight (serving/migrate.py). The HTTP
    handler maps it to 200 ``{"code": "migrated", "dest", "migrate_id"}``
    so the caller follows with ``POST dest/migrate/await``."""

    def __init__(self, dest: str, migrate_id: str):
        super().__init__(f"request migrated to {dest}")
        self.dest = dest
        self.migrate_id = migrate_id


class _Pending:
    """One submitted request's handle across the thread boundary."""

    __slots__ = ("prompt", "params", "deadline", "trace", "done", "result",
                 "error", "rid", "cancelled", "settled", "journal_id")

    def __init__(self, prompt, params, deadline=None, trace=None,
                 journal_id=None):
        self.prompt = prompt
        self.params = params
        self.deadline = deadline  # absolute perf_counter ts, or None
        self.trace = trace  # TraceContext (obs/trace.py) or None
        # a router's replay-journal handle, echoed on /inflight
        self.journal_id = journal_id
        self.done = threading.Event()
        self.result: Optional[RequestOutput] = None
        self.error: Optional[BaseException] = None
        self.rid: Optional[int] = None  # set once the engine admits it
        self.cancelled = False
        self.settled = False


class EngineRunner:
    """Owns and supervises the engine on a background thread (see the
    module docstring). Supervision knobs come from ``ServingConfig``."""

    def __init__(self, engine: ServingEngine):
        self.engine = engine
        serving = engine.serving
        self.max_restarts = serving.max_restarts
        self._backoff_base = serving.restart_backoff_s
        self._backoff_max = serving.restart_backoff_max_s
        self._step_budget = serving.step_time_budget_s
        self._cond = threading.Condition()
        self._incoming: deque = deque()
        self._cancels: deque = deque()
        self._commands: deque = deque()  # run_on_engine thunks
        self._inflight: list = []  # the last step's progress snapshot
        # migrate_id -> the waiter of an imported request (/migrate/await)
        self._migrated: "OrderedDict[str, _Pending]" = OrderedDict()
        self._migrated_cap = 256
        self._waiters: dict = {}  # request_id -> _Pending (engine thread)
        self._stop = False
        self._abort = False
        self._draining = False
        self._failed = False
        self._restarting = False
        self._degraded = False
        self._open = 0  # unsettled pendings (drain accounting)
        self.restarts = 0
        self._step_started: Optional[float] = None
        self.last_step_s: Optional[float] = None
        self._thread = threading.Thread(
            target=self._loop, name="serving-engine", daemon=True
        )
        self._thread.start()

    def status(self) -> str:
        """``healthy | degraded | restarting | draining | failed``."""
        now = time.perf_counter()
        with self._cond:
            if self._failed:
                return "failed"
            if self._draining or self._stop:
                return "draining"
            if self._restarting:
                return "restarting"
            started = self._step_started
            overrunning = (self._step_budget > 0 and started is not None
                           and now - started > self._step_budget)
            return "degraded" if self._degraded or overrunning else "healthy"

    def accepting(self) -> bool:
        """What ``GET /ready`` answers: should traffic come here? False
        while draining or failed (submits are refused) and while
        restarting (submits queue behind the rebuild, but a balancer with
        other replicas should prefer them)."""
        return self.status() in ("healthy", "degraded")

    def stats_snapshot(self) -> dict:
        with self._cond:
            return self.engine.stats.snapshot()

    def submit(self, prompt: Sequence[int],
               params: Optional[SamplingParams] = None,
               deadline_s: Optional[float] = None, trace=None,
               journal_id=None, **kw) -> _Pending:
        """Thread-safe enqueue. Raises :class:`QueueFullError` at the
        admission bound and :class:`ShuttingDownError` while draining.
        ``trace`` is the request's TraceContext, handed to the engine;
        ``journal_id`` rides the request's ``/inflight`` entries."""
        params = params or SamplingParams(**kw)
        deadline = (time.perf_counter() + deadline_s
                    if deadline_s is not None else None)
        pending = _Pending(list(prompt), params, deadline, trace, journal_id)
        with self._cond:
            if self._failed:
                err = EngineCrashError(
                    f"engine restart budget exhausted ({self.max_restarts}); "
                    "runner is dead"
                )
                err.retriable = False
                raise err
            if self._draining or self._stop:
                raise ShuttingDownError(
                    "server is draining; retry against another replica"
                )
            maxq = self.engine.serving.max_queue_len
            waiting = sum(1 for p in self._incoming if not p.cancelled)
            if maxq and waiting + self.engine.queue_len() >= maxq:
                self.engine.stats.inc("rejected")
                raise QueueFullError(
                    f"admission queue full ({maxq} waiting); retry later"
                )
            self._incoming.append(pending)
            self._open += 1
            self._cond.notify()
        return pending

    def cancel(self, pending: _Pending) -> None:
        with self._cond:
            pending.cancelled = True
            self._cancels.append(pending)
            self._cond.notify()

    def generate(self, prompt: Sequence[int],
                 params: Optional[SamplingParams] = None,
                 timeout: Optional[float] = None,
                 deadline_s: Optional[float] = None, trace=None,
                 journal_id=None, **kw) -> RequestOutput:
        pending = self.submit(prompt, params, deadline_s=deadline_s,
                              trace=trace, journal_id=journal_id, **kw)
        if not pending.done.wait(timeout):
            self.cancel(pending)
            raise TimeoutError("generation timed out")
        if pending.error is not None:
            raise pending.error
        return pending.result

    # -- live migration (serving/migrate.py) ---------------------------

    def run_on_engine(self, fn, timeout: float = 30.0):
        """Run ``fn()`` ON the engine thread between steps and return its
        result (or raise its exception) in the calling thread: the only
        way an HTTP handler touches engine state. Accepted while draining
        (a drain may migrate), refused once the runner is stopped or
        failed."""
        done = threading.Event()
        box: dict = {}

        def thunk():
            try:
                box["result"] = fn()
            except BaseException as e:
                box["error"] = e
            finally:
                done.set()

        with self._cond:
            if self._failed or self._stop:
                raise ShuttingDownError(
                    "runner is stopped; no engine thread to run on")
            self._commands.append(thunk)
            self._cond.notify()
        if not done.wait(timeout):
            raise TimeoutError(
                f"engine command did not complete within {timeout}s")
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def migrate_out(self, request_id: int, dest_url: str,
                    migrate_id: str, budget_s: float = 10.0) -> dict:
        """Move one in-flight request's live decode state to a peer:
        probe the peer's radix tree (dedup), export the slot's wire
        image, POST it to ``dest/migrate/import`` within the budget, then
        release the local slot and settle its waiter with
        :class:`MigratedError`. Only the export and the release run on
        the engine thread; the network legs run on the caller's thread,
        so the other slots keep decoding through a slow transfer. The
        slot decodes on between export and release, and the tokens it
        emits past the image are emitted again, identically, at the
        destination (draws are pure functions of (seed, t)). Raises
        :class:`MigrateExportError` (typed ``code``) when a leg fails;
        the request itself is unharmed."""
        budget = max(0.1, float(budget_s))
        deadline = time.monotonic() + budget

        def read_prompt():
            if self._waiters.get(request_id) is None:
                return None
            slot = self.engine._slot_for(request_id)
            return [int(t) for t in slot.prompt] if slot is not None else []

        prompt = self.run_on_engine(read_prompt)
        if prompt is None:
            # finished (or never admitted here): its /generate answered
            return {"outcome": "finished"}
        cached = 0
        if prompt:
            try:
                status, body, _ = http_post_json_with_retries(
                    dest_url + "/migrate/probe", {"prompt_ids": prompt},
                    timeout=min(5.0, budget), max_retries=0,
                    deadline_s=max(0.1, deadline - time.monotonic()))
                if status == 200:
                    cached = int(body.get("cached_pages", 0) or 0)
            except Exception:
                cached = 0  # the probe is best-effort: no dedup

        def export():
            if self._waiters.get(request_id) is None:
                return None
            return self.engine.export_slot_state(request_id,
                                                 dedup_pages=cached)

        blob = self.run_on_engine(export)
        if blob is None:
            return {"outcome": "finished"}
        status, body, _ = http_post_json_with_retries(
            dest_url + "/migrate/import",
            {"state": to_wire(blob), "migrate_id": migrate_id},
            timeout=max(0.1, deadline - time.monotonic()), max_retries=2,
            deadline_s=max(0.1, deadline - time.monotonic()))
        if status != 200:
            code = body.get("code") if isinstance(body, dict) else None
            self.engine.stats.inc("migrate_failed")
            raise MigrateExportError(
                f"destination import failed (status {status}, code {code})",
                code="migrate_transfer")

        def release():
            pending = self._waiters.get(request_id)
            if pending is None or pending.settled:
                # finished here during the transfer: the real result
                # answered; the imported copy decodes the same tokens
                return {"outcome": "finished"}
            self.engine.release_migrated(request_id)
            self._waiters.pop(request_id, None)
            self._settle(pending, error=MigratedError(dest_url, migrate_id))
            return {"outcome": "migrated", "bytes": len(blob),
                    "dedup_pages": cached, "dest": dest_url,
                    "migrate_id": migrate_id}

        return self.run_on_engine(release)

    def import_state(self, blob: bytes, migrate_id: str,
                     timeout: float = 30.0) -> int:
        """Land a migrated slot here: decode and CRC-verify the wire
        image, readmit it through the swap-in path
        (serving/engine.py:``import_state``) and register a waiter under
        ``migrate_id`` for ``/migrate/await``. Runs on the engine
        thread. Raises ``MigratePayloadError`` on a convicted transfer,
        ``MigrateExportError`` on a typed refusal, and the admission
        errors when full."""
        with self._cond:
            if self._draining or self._stop or self._failed:
                raise ShuttingDownError("replica is draining; migrate elsewhere")

        def thunk():
            rid = self.engine.import_state(blob)
            pending = _Pending([], None)
            pending.rid = rid
            self._waiters[rid] = pending
            with self._cond:
                self._open += 1
                self._migrated[migrate_id] = pending
                while len(self._migrated) > self._migrated_cap:
                    oldest = next(iter(self._migrated))
                    if not self._migrated[oldest].settled:
                        break  # never drop a live import
                    self._migrated.popitem(last=False)
            return rid

        return self.run_on_engine(thunk, timeout=timeout)

    def migrated_pending(self, migrate_id: str) -> Optional[_Pending]:
        with self._cond:
            return self._migrated.get(migrate_id)

    def inflight_snapshot(self) -> list:
        """The last completed step's per-request progress (request_id,
        prompt_len, emitted tokens, and journal_id when the request
        carried one). A stale snapshot only means a replay regenerates a
        few tokens, identically."""
        with self._cond:
            return list(self._inflight)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admission, wait for everything in flight within the drain
        budget, then close. True when all in-flight work completed."""
        budget = (self.engine.serving.drain_timeout_s
                  if timeout is None else timeout)
        end = time.monotonic() + budget
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            while ((self._open > 0 or self._incoming or self.engine.has_work())
                   and self._thread.is_alive()):
                left = end - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(min(left, 0.1))
            drained = (self._open == 0 and not self._incoming
                       and not self.engine.has_work())
            if not drained:
                self._abort = True
                self._cond.notify_all()
        self.close()
        return drained

    def close(self, timeout: float = 30.0) -> None:
        """Stop the loop and join the thread; raises when it does not
        stop in time (a stuck step leaves engine state untrusted)."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout)
        if self._thread.is_alive():
            with self._cond:
                self._failed = True
            raise RuntimeError(
                f"serving-engine thread failed to stop within {timeout}s"
            )

    def _settle(self, pending: _Pending, result=None, error=None) -> bool:
        with self._cond:
            if pending.settled:
                return False
            pending.settled = True
            pending.result = result
            pending.error = error
            self._open -= 1
            self._cond.notify_all()
        pending.done.set()
        return True

    def _deliver(self, outs, waiters: dict) -> None:
        for out in outs:
            pending = waiters.pop(out.request_id, None)
            if pending is None:
                continue
            if out.finish_reason == "deadline":
                self._settle(pending, error=DeadlineExceededError(
                    f"request {out.request_id} exceeded its server-side "
                    f"deadline after {len(out.tokens)} generated tokens",
                    output=out,
                ))
            elif out.finish_reason == "page_exhausted":
                err = PagePoolExhaustedError(
                    f"request {out.request_id} shed at admission: KV page "
                    "pool exhausted; retry later")
                err.output = out
                err.retry_after = out.retry_after
                self._settle(pending, error=err)
            elif out.finish_reason == "constraint_dead_end":
                # typed failure with the partial output: HTTP 400
                self._settle(pending, error=ConstraintDeadEndError(
                    f"request {out.request_id} hit a constraint dead end "
                    f"after {len(out.tokens)} generated tokens", output=out))
            else:
                self._settle(pending, result=out)

    def _handle_engine_crash(self, exc: BaseException, waiters: dict) -> bool:
        """Supervised recovery; True to continue on the rebuilt engine."""
        crash = exc if isinstance(exc, EngineCrashError) else EngineCrashError(
            f"engine step failed: {exc!r}")
        if crash is not exc:
            crash.__cause__ = exc
        self._deliver(self.engine.take_finished(), waiters)
        with self._cond:
            self.restarts += 1
        fatal = self.restarts > self.max_restarts
        lost: List[int] = []
        if not fatal:
            with self._cond:
                self._restarting = True
            try:
                lost = self.engine.reset_after_crash()
            except Exception as e:  # cannot rebuild: give up
                print(f"[serving] engine rebuild failed: {e!r}", file=sys.stderr)
                fatal = True
        if fatal:
            crash.retriable = False
            with self._cond:
                self._failed = True
                self._stop = True
                incoming = list(self._incoming)
                self._incoming.clear()
                self._restarting = False
            for p in list(waiters.values()) + incoming:
                self._settle(p, error=crash)
            waiters.clear()
            print(f"[serving] engine crashed ({exc!r}); restart budget "
                  f"exhausted ({self.max_restarts})", file=sys.stderr)
            return False
        for rid in lost:
            p = waiters.pop(rid, None)
            if p is not None:
                self._settle(p, error=crash)
        delay = min(self._backoff_base * (2 ** (self.restarts - 1)),
                    self._backoff_max)
        print(f"[serving] engine crashed ({exc!r}); slot pool rebuilt, "
              f"restart {self.restarts}/{self.max_restarts}, resuming in "
              f"{delay:.2f}s", file=sys.stderr)
        end = time.monotonic() + delay
        while time.monotonic() < end:
            with self._cond:
                if self._stop or self._abort:
                    break
            time.sleep(min(0.05, max(0.0, end - time.monotonic())))
        with self._cond:
            self._restarting = False
        return True

    def _loop(self) -> None:
        waiters = self._waiters
        while True:
            with self._cond:
                while (not self._incoming and not self._cancels
                       and not self._commands
                       and not self.engine.has_work() and not self._abort):
                    if self._stop:
                        return
                    self._cond.wait()
                incoming = list(self._incoming)
                self._incoming.clear()
                cancels = list(self._cancels)
                self._cancels.clear()
                commands = list(self._commands)
                self._commands.clear()
                stopping = self._stop
                aborting = self._abort
            if aborting:
                err = ShuttingDownError(
                    "server shut down before completing this request "
                    "(drain budget expired)"
                )
                for p in list(waiters.values()) + incoming:
                    self._settle(p, error=err)
                return
            for pending in cancels:
                if pending.rid is not None and self.engine.cancel(pending.rid):
                    w = waiters.pop(pending.rid, None)
                    if w is not None:
                        self._settle(w, error=TimeoutError("cancelled"))
            for pending in incoming:
                if pending.cancelled:
                    self._settle(pending, error=TimeoutError(
                        "cancelled before admission"))
                    continue
                try:
                    pending.rid = self.engine.submit(
                        pending.prompt, params=pending.params,
                        deadline=pending.deadline, trace=pending.trace,
                    )
                    waiters[pending.rid] = pending
                except Exception as e:  # invalid request: fail the caller
                    self._settle(pending, error=e)
            for thunk in commands:
                # run_on_engine thunks: each catches its own exception
                # and signals its caller
                thunk()
            try:
                t0 = time.perf_counter()
                with self._cond:
                    self._step_started = t0
                outs = self.engine.step()
                dt = time.perf_counter() - t0
                with self._cond:
                    self._step_started = None
                    self.last_step_s = dt
                    if self._step_budget > 0:
                        self._degraded = dt > self._step_budget
            except Exception as e:
                with self._cond:
                    self._step_started = None
                if not self._handle_engine_crash(e, waiters):
                    return
                continue
            self._deliver(outs, waiters)
            entries = self.engine.progress_snapshot()
            for ent in entries:
                p = waiters.get(ent["request_id"])
                if p is not None and p.journal_id is not None:
                    ent["journal_id"] = p.journal_id
            with self._cond:
                self._inflight = entries
            if stopping and not self.engine.has_work():
                return


class ServingClient:
    """In-process client: one engine, blocking calls from any thread."""

    def __init__(self, engine: ServingEngine):
        self.runner = EngineRunner(engine)

    def generate(self, prompt: Sequence[int],
                 params: Optional[SamplingParams] = None,
                 timeout: Optional[float] = None,
                 deadline_s: Optional[float] = None, trace=None,
                 journal_id=None, **kw) -> RequestOutput:
        return self.runner.generate(prompt, params, timeout=timeout,
                                    deadline_s=deadline_s, trace=trace,
                                    journal_id=journal_id, **kw)

    def generate_batch(self, prompts: Sequence[Sequence[int]],
                       params: Optional[Sequence[SamplingParams]] = None,
                       timeout: Optional[float] = None,
                       **kw) -> List[RequestOutput]:
        """Submit all prompts, then wait. A timeout or a failed request
        cancels every unfinished sibling before raising."""
        shared = SamplingParams(**kw) if params is None else None
        handles = []
        try:
            for i, p in enumerate(prompts):
                handles.append(self.runner.submit(p, shared if shared else params[i]))
        except Exception:
            for h in handles:
                if not h.done.is_set():
                    self.runner.cancel(h)
            raise
        outs = []
        for pending in handles:
            ok = pending.done.wait(timeout)
            if not ok or pending.error is not None:
                for h in handles:
                    if not h.done.is_set():
                        self.runner.cancel(h)
                if not ok:
                    raise TimeoutError("generation timed out")
                raise pending.error
            outs.append(pending.result)
        return outs

    @property
    def stats(self) -> dict:
        return self.runner.stats_snapshot()

    @property
    def registry(self):
        """The engine's metrics registry: what ``GET /metrics`` renders."""
        return self.runner.engine.registry

    def status(self) -> str:
        return self.runner.status()

    def drain(self, timeout: Optional[float] = None) -> bool:
        return self.runner.drain(timeout)

    def close(self) -> None:
        self.runner.close()


def _make_handler(client: ServingClient, tokenizer=None, events=None,
                  slo=None):
    events = events or NOOP_EVENTS

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict,
                   headers: Optional[dict] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _retry_after(self) -> dict:
            serving = client.runner.engine.serving
            if client.status() == "draining":
                secs = max(1, int(serving.drain_timeout_s))
            else:
                secs = max(1, int(serving.restart_backoff_s))
            return {"Retry-After": str(secs)}

        def do_GET(self):
            if self.path == "/metrics":
                if slo is not None:
                    # every scrape carries a current judgment (obs/slo.py)
                    slo.evaluate()
                body = client.registry.render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", METRICS_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/health":
                status = client.status()
                self._reply(200, {
                    "ok": status in ("healthy", "degraded"),
                    "status": status,
                    "restarts": client.runner.restarts,
                    "last_step_s": client.runner.last_step_s,
                    "stats": client.stats,
                    "device": str(client.runner.engine.device),
                    **{key: val for key, val in (
                        ("kv_pages", client.runner.engine.page_stats()),
                        ("spec", client.runner.engine.spec_stats()),
                        ("host_tier", client.runner.engine.tier_stats()))
                       if val is not None},
                    "constraints": client.runner.engine.constrain_stats(),
                })
            elif self.path == "/ready":
                if client.runner.accepting():
                    self._reply(200, {"ready": True, "status": client.status()})
                else:
                    self._reply(503, {"ready": False, "status": client.status()},
                                headers=self._retry_after())
            elif self.path == "/inflight":
                # per-request progress: a router's replay-journal harvest
                # and a drain's migration list
                self._reply(200, {"inflight": client.runner.inflight_snapshot()})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        # -- live migration endpoints (serving/migrate.py) ------------

        def _read_json(self) -> dict:
            n = int(self.headers.get("Content-Length", "0"))
            return json.loads(self.rfile.read(n) or b"{}")

        def _migrate_probe(self) -> None:
            """How many leading prompt pages this replica's radix tree
            holds: the source ships holes for them (dedup)."""
            try:
                req = self._read_json()
                prompt = [int(t) for t in req.get("prompt_ids") or []]
                pool = client.runner.engine.pages
                cached = pool.probe_prefix(prompt) if pool is not None and prompt else 0
                self._reply(200, {"cached_pages": int(cached)})
            except Exception as e:
                self._reply(400, {"error": str(e), "code": "bad_request"})

        def _migrate_import(self) -> None:
            """Land a migrated slot. A convicted (corrupt or torn) image
            answers a typed 409: garbage KV never lands."""
            try:
                req = self._read_json()
                migrate_id = str(req.get("migrate_id") or "")
                if not migrate_id or "state" not in req:
                    raise ValueError("migrate_id and state required")
                blob = from_wire(str(req["state"]))
                rid = client.runner.import_state(blob, migrate_id)
            except MigratePayloadError as e:
                self._reply(409, {"error": str(e), "code": "migrate_corrupt"})
            except MigrateExportError as e:
                self._reply(409, {"error": str(e), "code": e.code})
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e), "code": "bad_request"})
            except QueueFullError as e:
                self._reply(503, {"error": str(e), "code": "queue_full"},
                            headers=self._retry_after())
            except PagePoolExhaustedError as e:
                self._reply(503, {"error": str(e),
                                  "code": "page_pool_exhausted"},
                            headers=self._retry_after())
            except ShuttingDownError as e:
                self._reply(503, {"error": str(e), "code": "shutting_down"},
                            headers=self._retry_after())
            except TimeoutError as e:
                self._reply(503, {"error": str(e), "code": "migrate_timeout"})
            except Exception as e:
                self._reply(500, {"error": str(e) or repr(e), "code": "internal"})
            else:
                events.emit("migrate_imported", migrate_id=migrate_id,
                            request_id=rid)
                self._reply(200, {"request_id": rid, "migrate_id": migrate_id})

        def _migrate_export(self) -> None:
            """Move one in-flight request to ``dest``. A typed failure
            (contiguous pool, transfer death, a full destination) answers
            non-200 and the request decodes on here."""
            try:
                req = self._read_json()
                result = client.runner.migrate_out(
                    int(req["request_id"]), str(req["dest"]).rstrip("/"),
                    str(req.get("migrate_id") or ""),
                    budget_s=float(req.get("budget_s", 10.0)))
            except MigrateExportError as e:
                self._reply(409, {"error": str(e), "code": e.code})
            except (ValueError, TypeError, KeyError,
                    json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e), "code": "bad_request"})
            except ShuttingDownError as e:
                self._reply(503, {"error": str(e), "code": "shutting_down"})
            except TimeoutError as e:
                self._reply(503, {"error": str(e), "code": "migrate_timeout"})
            except Exception as e:
                self._reply(500, {"error": str(e) or repr(e), "code": "internal"})
            else:
                events.emit("migrate_exported", outcome=result.get("outcome"),
                            dest=result.get("dest"))
                self._reply(200, result)

        def _run_generate(self, req: dict, ctx) -> RequestOutput:
            """Parse a /generate body and run it under trace context
            ``ctx``; raises the typed errors do_POST maps to HTTP."""
            if not isinstance(req, dict):
                raise ValueError("the request body must be a JSON object")
            for key in req:
                if key not in GENERATE_KEYS:
                    raise ValueError(f"unknown field {key!r}")
            prompt_ids = req.get("prompt_ids")
            if prompt_ids is None and "prompt" in req:
                if tokenizer is None:
                    raise ValueError(
                        "text prompts need the server started with a "
                        "tokenizer dir; send prompt_ids instead"
                    )
                if not isinstance(req["prompt"], str):
                    raise TypeError("prompt must be a string")
                prompt_ids = tokenizer.encode(req["prompt"]).ids
            if not prompt_ids:
                raise ValueError("prompt_ids (or prompt) required")
            top_k = req.get("top_k")
            eos = req.get("eos_token_id")
            stop = req.get("stop")
            draft_len = req.get("draft_len")
            # json_schema arrives as a JSON value (object) or as its
            # text; SamplingParams takes the text
            schema = req.get("json_schema")
            if schema is not None and not isinstance(schema, str):
                schema = json.dumps(schema)
            params = SamplingParams(
                max_new_tokens=int(req.get("max_new_tokens", 16)),
                temperature=float(req.get("temperature", 1.0)),
                top_k=None if top_k is None else int(top_k),
                seed=int(req.get("seed", 0)),
                eos_token_id=None if eos is None else int(eos),
                stop=(None if stop is None
                      else tuple(tuple(int(t) for t in seq) for seq in stop)),
                json_schema=schema,
                regex=req.get("regex"),
                choices=req.get("choices"),
                repetition_penalty=float(req.get("repetition_penalty", 1.0)),
                presence_penalty=float(req.get("presence_penalty", 0.0)),
                frequency_penalty=float(req.get("frequency_penalty", 0.0)),
                logprobs=int(req.get("logprobs", 0)),
                priority=str(req.get("priority", "normal")),
                draft_len=None if draft_len is None else int(draft_len),
                # a replay: the key position of prompt + emitted tokens
                key_offset=int(req.get("key_offset", 0)),
            )
            deadline_s = req.get("deadline_s")
            # arrival at the handler, not admission: the engine's
            # trace-stamped `admit` instant marks that
            events.emit("request_received", trace_id=ctx.trace_id,
                        prompt_len=len(prompt_ids))
            jid = req.get("journal_id")
            return client.generate(
                [int(t) for t in prompt_ids], params,
                timeout=float(req.get("timeout", 600.0)),
                deadline_s=None if deadline_s is None else float(deadline_s),
                trace=ctx, journal_id=None if jid is None else str(jid),
            )

        def do_POST(self):
            if self.path == "/migrate/probe":
                return self._migrate_probe()
            if self.path == "/migrate/import":
                return self._migrate_import()
            if self.path == "/migrate/export":
                return self._migrate_export()
            # /migrate/await shares /generate's error ladder and reply:
            # it is a /generate whose work arrived by migration
            if self.path not in ("/generate", "/migrate/await"):
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            ctx = None  # TraceContext once the body parses

            def _fail(code: int, payload: dict, headers=None) -> None:
                # every error reply carries the trace id (once the body
                # parsed) and lands one structured event
                payload["trace_id"] = ctx.trace_id if ctx is not None else None
                events.emit("request_failed", status=code,
                            code=payload.get("code"),
                            trace_id=payload["trace_id"])
                self._reply(code, payload, headers=headers)

            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("the request body must be a JSON object")
                # the traceparent field is the trace contract; a request
                # without one gets a fresh context
                ctx = trace_from_payload(req)
                if self.path == "/migrate/await":
                    # an imported request's waiter, answered in
                    # /generate's shape (the whole token list: the slot
                    # restored the source's emitted tokens)
                    migrate_id = str(req.get("migrate_id") or "")
                    pending = client.runner.migrated_pending(migrate_id)
                    if pending is None:
                        _fail(404, {
                            "error": f"unknown migrate_id {migrate_id!r}",
                            "code": "unknown_migrate_id"})
                        return
                    if not pending.done.wait(float(req.get("timeout", 600.0))):
                        client.runner.cancel(pending)
                        raise TimeoutError("generation timed out")
                    if pending.error is not None:
                        raise pending.error
                    out = pending.result
                else:
                    out = self._run_generate(req, ctx)
            except ConstraintCompileError as e:
                # before the ValueError branch (it is one): "fix your
                # spec", told apart from a malformed body
                _fail(400, {"error": str(e),
                            "code": "constraint_compile_failed"})
                return
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                _fail(400, {"error": str(e), "code": "bad_request"})
                return
            except ConstraintDeadEndError as e:
                _fail(400, {"error": str(e), "code": "constraint_dead_end",
                            "partial_tokens": (e.output.tokens
                                               if e.output is not None
                                               else [])})
                return
            except QueueFullError as e:
                _fail(503, {"error": f"server overloaded: {e}",
                            "code": "queue_full"},
                      headers=self._retry_after())
                return
            except ShuttingDownError as e:
                _fail(503, {"error": str(e), "code": "shutting_down"},
                      headers=self._retry_after())
                return
            except PagePoolExhaustedError as e:
                # retriable: the pool drains as requests retire; a
                # request that can never fit carries retriable=False
                # and no Retry-After
                headers = None
                if getattr(e, "retriable", True):
                    ra = getattr(e, "retry_after", None)
                    headers = ({"Retry-After": str(max(1, int(ra + 0.999)))}
                               if ra is not None else self._retry_after())
                _fail(503, {"error": str(e), "code": "page_pool_exhausted"},
                      headers=headers)
                return
            except EngineCrashError as e:
                if getattr(e, "retriable", True):
                    _fail(503, {"error": f"engine crashed: {e}",
                                "code": "engine_crash"},
                          headers=self._retry_after())
                else:
                    _fail(503, {"error": str(e), "code": "engine_failed"})
                return
            except DeadlineExceededError as e:
                _fail(504, {
                    "error": str(e), "code": "deadline",
                    "partial_tokens": e.output.tokens if e.output else [],
                })
                return
            except TimeoutError:
                _fail(503, {"error": "generation timed out", "code": "timeout"})
                return
            except MigratedError as e:
                # not a failure: the live state moved to a peer; the
                # caller picks the continuation up at dest/migrate/await
                payload = {"code": "migrated", "dest": e.dest,
                           "migrate_id": e.migrate_id}
                if ctx is not None:
                    payload["trace_id"] = ctx.trace_id
                events.emit("request_migrated", dest=e.dest,
                            trace_id=payload.get("trace_id"))
                self._reply(200, payload)
                return
            except Exception as e:  # unexpected failure, still typed
                _fail(500, {"error": str(e) or repr(e), "code": "internal"})
                return
            payload = {
                "request_id": out.request_id,
                "prompt_ids": out.prompt,
                "tokens": out.tokens,
                "finish_reason": out.finish_reason,
                "ttft_ms": round(out.ttft * 1e3, 3),
                "trace_id": out.trace_id or ctx.trace_id,
            }
            if out.token_logprobs is not None:
                payload["token_logprobs"] = out.token_logprobs
                payload["top_logprobs"] = [[[tid, lp] for tid, lp in row]
                                           for row in out.top_logprobs]
            if out.quality is not None:
                payload["quality"] = out.quality
            if tokenizer is not None:
                payload["text"] = tokenizer.decode(out.tokens)
            events.emit("request_finished", trace_id=payload["trace_id"],
                        reason=out.finish_reason, tokens=len(out.tokens),
                        ttft_ms=payload["ttft_ms"])
            self._reply(200, payload)

        def log_message(self, *a):  # quiet by default
            pass

    return Handler


def serve(client: ServingClient, host: str = "127.0.0.1", port: int = 8000,
          tokenizer=None, events=None, slo=None) -> ThreadingHTTPServer:
    """Build the HTTP server (not yet serving; call serve_forever()).
    ``tokenizer`` (data/tokenizer.py) enables text prompts; ``events`` is
    an obs/events.py EventLog (None = off); ``slo`` an obs/slo.py
    SLOMonitor evaluated on every /metrics scrape."""
    return ThreadingHTTPServer(
        (host, port), _make_handler(client, tokenizer, events, slo))


def build_parser():
    """The server's command line: the JAX server's flags and defaults,
    less :data:`LATER_FLAGS`."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", default=None,
                   help="training checkpoint dir (meta.json + "
                        "state.msgpack); omit for a random-init demo model")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer dir enabling text prompts "
                        "(vocab.json + merges.txt)")
    p.add_argument("--no-verify-checkpoint", action="store_true",
                   help="skip integrity-manifest verification of "
                        "--checkpoint (needed for pre-manifest checkpoints)")
    p.add_argument("--model", default="control",
                   help="model family of the random-init demo model")
    p.add_argument("--recipe", action="store_true",
                   help="build the demo model at the reference recipe's "
                        "widths (8 layers, width 768, T 512, vocab 12000, "
                        "bf16 compute) instead of the small demo")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when no GPU is present")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--num-slots", type=int, default=8)
    p.add_argument("--prefill-chunk", type=int, default=128)
    p.add_argument("--prefill-budget", type=int, default=256)
    p.add_argument("--max-seq-len", type=int, default=0)
    p.add_argument("--decode-attention-impl", default="",
                   choices=("", "xla", "pallas"),
                   help="NO EFFECT in the port: accepted so that the JAX "
                        "server's command lines run, and kept in the model "
                        "config ('' keeps the model config's). 'xla' does "
                        "not select a plain route: the device picks the "
                        "decode attention (the Hopper kernel on the card, "
                        "its plain version on the CPU)")
    p.add_argument("--max-queue-len", type=int, default=0,
                   help="reject (HTTP 503) submissions past this many "
                        "waiting requests; 0 = unbounded")
    p.add_argument("--default-deadline", type=float, default=0.0)
    p.add_argument("--drain-timeout", type=float, default=30.0)
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--restart-backoff", type=float, default=0.5)
    p.add_argument("--restart-backoff-max", type=float, default=30.0)
    p.add_argument("--step-time-budget", type=float, default=0.0,
                   help="watchdog: mark the engine degraded on /health "
                        "when one decode iteration exceeds this many "
                        "seconds (0 = off)")
    p.add_argument("--host-tier-bytes", type=int, default=0,
                   help="host-RAM KV page tier (serving/host_tier.py), "
                        "in bytes (needs --kv-page-size): evicted "
                        "radix-cached prefixes DEMOTE here instead of "
                        "vanishing and promote back with a copy, never "
                        "a recompute; preempted requests stash their "
                        "live KV here and resume bit-exact. 0 = off")
    p.add_argument("--priority-aging", type=float, default=10.0,
                   help="anti-starvation aging (seconds): every this "
                        "many seconds waited improves a queued "
                        "request's effective priority by one class, so "
                        "batch traffic cannot starve under sustained "
                        "high-priority load (0 = strict classes)")
    p.add_argument("--priority-max-slots", default="",
                   help="per-class slot bounds as 'class:N,...' (e.g. "
                        "'batch:6') capping how many slots one class "
                        "may hold; '' = no bounds")
    p.add_argument("--kv-cache-dtype", default="",
                   choices=("", "auto", "bf16", "int8"),
                   help="KV-cache storage dtype; int8 stores per-vector "
                        "scaled int8 K/V (about half the bf16 bytes); '' "
                        "keeps the model config")
    p.add_argument("--kv-page-size", type=int, default=0,
                   help="paged KV cache: tokens per page (must divide "
                        "block_size); admission then keys on free pages. "
                        "0 = contiguous per-slot rings")
    p.add_argument("--kv-pool-pages", type=int, default=0,
                   help="physical pages in the paged pool; 0 = num_slots "
                        "* block_size / page_size")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="disable the radix-tree shared-prefix cache (on "
                        "by default with --kv-page-size)")
    p.add_argument("--prefix-cache-pages", type=int, default=0,
                   help="extra pool pages kept as cached-prefix headroom")
    p.add_argument("--spec-mode", default="", choices=("", "ngram", "model"),
                   help="speculative decoding: 'ngram' = prompt lookup over "
                        "each request's own tokens; 'model' = a small "
                        "drafter checkpoint (--spec-drafter-ckpt) proposing "
                        "greedily on its own KV pool")
    p.add_argument("--spec-draft-len", type=int, default=4,
                   help="draft tokens verified per slot per iteration")
    p.add_argument("--spec-drafter-ckpt", default="",
                   help="drafter checkpoint dir for --spec-mode model "
                        "(loaded like --checkpoint: manifest verification "
                        "and --quantize-weights apply); must share the "
                        "target's tokenizer and vocab")
    p.add_argument("--quantize-weights", default=None, choices=("int8",),
                   help="per-channel int8 quantize + dequantize of every "
                        "matmul weight at load (the target, the demo "
                        "model and the drafter); embeddings and norms "
                        "stay exact")
    p.add_argument("--spec-verify", default="exact",
                   choices=("exact", "batched"),
                   help="'exact' (k+1 unrolled L=1 steps: greedy output "
                        "bit-identical to no spec) or 'batched' (one pass "
                        "through the multi-row decode-attention kernel)")
    p.add_argument("--trace-path", default=None,
                   help="write a Chrome-trace-event JSON of engine "
                        "iterations (schedule/prefill/decode/sample/emit "
                        "spans + per-request trace-stamped lifecycle; "
                        "open in Perfetto or merge fleet-wide with "
                        "tools/trace_stitch.py) to this path")
    p.add_argument("--event-log", default=None,
                   help="append structured JSONL events (request "
                        "received/finished/failed with trace ids; "
                        "obs/events.py) to this path")
    p.add_argument("--event-log-max-bytes", type=int, default=0,
                   help="rotate --event-log when it reaches this many "
                        "bytes (atomic rename cascade, whole lines "
                        "only; 0 = never rotate)")
    p.add_argument("--event-log-keep", type=int, default=3,
                   help="rotated --event-log generations to keep "
                        "(events.jsonl.1 ... .N; 0 = truncate)")
    p.add_argument("--quality-telemetry", action="store_true",
                   help="compute per-token model-quality signals "
                        "(sampled-distribution entropy, top-1 logit "
                        "margin, repetition runs) on the device beside "
                        "the sampler (obs/quality.py): per-request "
                        "quality stats on responses, "
                        "serving_token_entropy / serving_logit_margin "
                        "histograms and serving_lambda_mean{layer=} / "
                        "serving_quality_drift gauges on /metrics")
    p.add_argument("--quality-fingerprint", default=None,
                   help="reference quality fingerprint JSON to compare "
                        "live traffic against (PSI drift score as "
                        "serving_quality_drift; recorded earlier with "
                        "--quality-record); implies --quality-telemetry")
    p.add_argument("--quality-record", default=None,
                   help="write this replica's quality fingerprint "
                        "(quantile sketches of the live entropy/margin "
                        "distributions) to this path at drain/shutdown; "
                        "implies --quality-telemetry")
    p.add_argument("--slo-ttft", type=float, default=1.0,
                   help="TTFT latency objective bound in seconds "
                        "(obs/slo.py; burn rates exposed as slo_* "
                        "gauges on /metrics)")
    p.add_argument("--slo-itl", type=float, default=0.25,
                   help="inter-token latency objective bound in seconds")
    p.add_argument("--slo-target", type=float, default=0.99,
                   help="latency objectives' target fraction of "
                        "requests under the bound")
    p.add_argument("--slo-availability-target", type=float,
                   default=0.999,
                   help="availability objective target (completed vs "
                        "rejected/deadline-expired)")
    return p


def refused_flags(argv) -> list:
    return [a.split("=")[0] for a in argv if a.split("=")[0] in LATER_FLAGS]


def serving_config_from_args(args):
    """The ``ServingConfig`` the parsed flags ask for."""
    from differential_transformer_replication_tpu_torch.config import (
        ServingConfig,
    )

    return ServingConfig(
        num_slots=args.num_slots, prefill_chunk=args.prefill_chunk,
        prefill_budget=args.prefill_budget, max_seq_len=args.max_seq_len,
        max_queue_len=args.max_queue_len,
        default_deadline_s=args.default_deadline,
        drain_timeout_s=args.drain_timeout, max_restarts=args.max_restarts,
        restart_backoff_s=args.restart_backoff,
        restart_backoff_max_s=args.restart_backoff_max,
        step_time_budget_s=args.step_time_budget,
        priority_aging_s=args.priority_aging,
        priority_max_slots=args.priority_max_slots,
        kv_cache_dtype=args.kv_cache_dtype, kv_page_size=args.kv_page_size,
        kv_pool_pages=args.kv_pool_pages,
        prefix_cache=not args.no_prefix_cache,
        prefix_cache_pages=args.prefix_cache_pages, spec_mode=args.spec_mode,
        spec_draft_len=args.spec_draft_len, spec_verify=args.spec_verify,
        spec_drafter_ckpt=args.spec_drafter_ckpt,
        host_tier_bytes=args.host_tier_bytes,
        # recording or comparing a fingerprint both need the telemetry
        # tail, so either flag arms it
        quality_telemetry=(args.quality_telemetry
                           or bool(args.quality_fingerprint)
                           or bool(args.quality_record)),
        quality_fingerprint=args.quality_fingerprint or "",
    )


def engine_from_args(args, tracer=None):
    """The engine the parsed flags ask for: ``(engine, model_cfg, meta,
    tokenizer)``. ``--checkpoint`` loads through
    ``load_params_for_inference`` (manifest verified unless
    ``--no-verify-checkpoint``, ``--quantize-weights`` applied), else the
    random-init demo model (weights from seed 0, quantized the same
    way); ``--spec-mode model`` loads ``--spec-drafter-ckpt`` through the
    same verified and quantized path. The engine gets the tokenizer's id
    -> text table for constraints (``--tokenizer``), else the demo table
    that maps printable-ASCII ids to their characters, as the JAX
    server's does."""
    import torch

    from differential_transformer_replication_tpu_torch.config import (
        ModelConfig,
    )
    from differential_transformer_replication_tpu_torch.models import init_model
    from differential_transformer_replication_tpu_torch.train.checkpoint import (
        apply_weight_quantization,
        load_params_for_inference,
    )

    if args.checkpoint:
        params, model_cfg, meta = load_params_for_inference(
            args.checkpoint, verify=not args.no_verify_checkpoint,
            quantize=args.quantize_weights)
    else:
        meta = None
        if args.recipe:
            model_cfg = ModelConfig(model=args.model)
        else:
            model_cfg = ModelConfig(
                model=args.model, vocab_size=512, n_embd=64, n_head=2,
                n_layer=2, block_size=128, compute_dtype="float32",
            )
        gen = torch.Generator(device="cpu")
        gen.manual_seed(0)
        params = apply_weight_quantization(init_model(gen, model_cfg),
                                           args.quantize_weights)
    if args.decode_attention_impl:
        model_cfg = model_cfg.replace(
            decode_attention_impl=args.decode_attention_impl)
    tokenizer = None
    vocab = [chr(i) if 32 <= i < 127 else ""
             for i in range(model_cfg.vocab_size)]
    if args.tokenizer:
        from differential_transformer_replication_tpu_torch.data.tokenizer import (
            check_tokenizer_matches,
            load_tokenizer,
            vocab_strings,
        )

        tokenizer = load_tokenizer(args.tokenizer)
        vocab = vocab_strings(tokenizer, model_cfg.vocab_size)
        if meta is not None:
            # a tokenizer that cannot belong to the checkpoint would
            # silently serve garbage text
            check_tokenizer_matches(
                tokenizer, model_cfg.vocab_size,
                meta.get("tokenizer_fingerprint"), context=args.checkpoint)
    spec_drafter = None
    if args.spec_mode == "model" and args.spec_drafter_ckpt:
        d_params, d_cfg, _ = load_params_for_inference(
            args.spec_drafter_ckpt, verify=not args.no_verify_checkpoint,
            quantize=args.quantize_weights)
        spec_drafter = (d_params, d_cfg)
    engine = ServingEngine(params, model_cfg, serving_config_from_args(args),
                           device=args.device, tracer=tracer,
                           spec_drafter=spec_drafter, vocab=vocab)
    return engine, model_cfg, meta, tokenizer


def main(argv=None) -> None:
    """CLI: serve a training checkpoint (``--checkpoint DIR``, either
    package's format) or a random-init demo model (weights from seed 0)
    over HTTP on ``--device``; ``--tokenizer DIR`` enables text
    prompts."""
    import dataclasses
    import hashlib
    import signal

    import torch

    from differential_transformer_replication_tpu_torch.obs.registry import (
        set_build_info,
    )
    from differential_transformer_replication_tpu_torch.obs.slo import (
        SLOMonitor,
        default_serving_objectives,
    )

    argv = sys.argv[1:] if argv is None else list(argv)
    p = build_parser()
    bad = refused_flags(argv)
    if bad:
        p.error("; ".join(f"{f} is not run by the port yet: {LATER_FLAGS[f]}"
                          for f in bad))
    args = p.parse_args(argv)
    tracer = None
    if args.trace_path:
        from differential_transformer_replication_tpu_torch.obs.spans import (
            SpanTracer,
        )

        tracer = SpanTracer(args.trace_path, process_name="serving-engine")
    events = None
    if args.event_log:
        from differential_transformer_replication_tpu_torch.obs.events import (
            EventLog,
        )

        events = EventLog(args.event_log, process="replica",
                          max_bytes=args.event_log_max_bytes,
                          keep=args.event_log_keep)
    engine, model_cfg, _meta, tokenizer = engine_from_args(args, tracer)
    serving = engine.serving
    client = ServingClient(engine)
    # process identity on /metrics: a fleet scrape tells replicas apart
    # and spots config drift
    cfg_hash = hashlib.sha1(json.dumps(
        dataclasses.asdict(model_cfg), sort_keys=True, default=str,
    ).encode()).hexdigest()[:12]
    set_build_info(engine.registry, role="replica", config_hash=cfg_hash,
                   version=torch.__version__)
    slo_latency, slo_availability = default_serving_objectives(
        ttft_threshold_s=args.slo_ttft, itl_threshold_s=args.slo_itl,
        latency_target=args.slo_target,
        availability_target=args.slo_availability_target,
    )
    slo = SLOMonitor(engine.registry, latency=slo_latency,
                     availability=slo_availability)
    httpd = serve(client, args.host, args.port, tokenizer, events=events,
                  slo=slo)
    drained = {"done": False}
    fingerprint_saved = {"done": False}

    def _save_quality_fingerprint():
        """Snapshot the live quality sketches to --quality-record; once
        (the drain path and the final cleanup both call it)."""
        if not args.quality_record or fingerprint_saved["done"]:
            return
        fingerprint_saved["done"] = True
        try:
            from differential_transformer_replication_tpu_torch.obs.quality import (
                save_fingerprint,
            )

            save_fingerprint(args.quality_record, engine.quality_fingerprint(
                meta={"model": model_cfg.model, "config_hash": cfg_hash}))
            print(f"[serve] quality fingerprint written to "
                  f"{args.quality_record}", file=sys.stderr)
        except Exception as e:  # forensics must not block shutdown
            print(f"[serve] quality fingerprint save failed: {e!r}",
                  file=sys.stderr)

    def _graceful(signum, frame):
        del frame
        print(f"[serve] signal {signum}: draining", file=sys.stderr)

        def _drain_then_stop():
            try:
                ok = client.drain()
                print(f"[serve] drain {'complete' if ok else 'TIMED OUT'}",
                      file=sys.stderr)
            except Exception as e:
                print(f"[serve] drain failed: {e!r}", file=sys.stderr)
            finally:
                # buffered telemetry lands before the process goes away
                _save_quality_fingerprint()
                if tracer is not None:
                    tracer.close()
                if events is not None:
                    events.emit("drained")
                    events.close()
                drained["done"] = True
                httpd.shutdown()

        threading.Thread(target=_drain_then_stop, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    print(f"[serve] {model_cfg.model} model "
          f"({args.checkpoint or 'random init'}) on {engine.device}, "
          f"{serving.num_slots} slots, {engine.cfg.kv_cache_dtype} KV, "
          f"{'paged' if serving.paged() else 'contiguous'} pool, spec "
          f"{serving.spec_mode or 'off'} — POST "
          f"http://{args.host}:{args.port}/generate, metrics at GET "
          f"http://{args.host}:{args.port}/metrics")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        if not drained["done"]:
            client.close()
        _save_quality_fingerprint()
        if tracer is not None:
            tracer.close()
            print(f"[serve] span trace written to {args.trace_path}")
        if events is not None:
            events.close()


if __name__ == "__main__":
    main()
