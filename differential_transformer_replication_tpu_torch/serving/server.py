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
  the JAX server), and ``GET /health`` for engine state and stats, with
  ``kv_pages`` (the paged pool and its prefix cache) and ``spec``
  (speculative decoding) when those are on. A request the page pool
  cannot take answers HTTP 503 ``page_pool_exhausted``.

A request that carries a field of a later slice of the port (structured
decoding, penalties, logprobs, replay fields) is refused with HTTP 400
``bad_request`` naming the field.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence

from differential_transformer_replication_tpu_torch.serving.engine import (
    EngineCrashError,
    ServingEngine,
)
from differential_transformer_replication_tpu_torch.serving.pages import (
    PagePoolExhaustedError,
)
from differential_transformer_replication_tpu_torch.serving.request import (
    RequestOutput,
    SamplingParams,
)
from differential_transformer_replication_tpu_torch.serving.scheduler import (
    DeadlineExceededError,
    QueueFullError,
)

# /generate body keys this slice serves; LATER_SLICE_KEYS are refused
GENERATE_KEYS = (
    "prompt_ids", "max_new_tokens", "temperature", "top_k", "seed",
    "eos_token_id", "stop", "priority", "deadline_s", "timeout",
    "traceparent", "draft_len", "prompt",
)
LATER_SLICE_KEYS = (
    "json_schema", "regex", "choices", "repetition_penalty",
    "presence_penalty", "frequency_penalty", "logprobs", "spec",
    "key_offset", "journal_id",
)


class ShuttingDownError(RuntimeError):
    """Admission refused: the server is draining (or already stopped)."""

    retriable = True


class _Pending:
    """One submitted request's handle across the thread boundary."""

    __slots__ = ("prompt", "params", "deadline", "done", "result", "error",
                 "rid", "cancelled", "settled")

    def __init__(self, prompt, params, deadline=None):
        self.prompt = prompt
        self.params = params
        self.deadline = deadline  # absolute perf_counter ts, or None
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

    def stats_snapshot(self) -> dict:
        with self._cond:
            return self.engine.stats.snapshot()

    def submit(self, prompt: Sequence[int],
               params: Optional[SamplingParams] = None,
               deadline_s: Optional[float] = None, **kw) -> _Pending:
        """Thread-safe enqueue. Raises :class:`QueueFullError` at the
        admission bound and :class:`ShuttingDownError` while draining."""
        params = params or SamplingParams(**kw)
        deadline = (time.perf_counter() + deadline_s
                    if deadline_s is not None else None)
        pending = _Pending(list(prompt), params, deadline)
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
                 deadline_s: Optional[float] = None, **kw) -> RequestOutput:
        pending = self.submit(prompt, params, deadline_s=deadline_s, **kw)
        if not pending.done.wait(timeout):
            self.cancel(pending)
            raise TimeoutError("generation timed out")
        if pending.error is not None:
            raise pending.error
        return pending.result

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
                       and not self.engine.has_work() and not self._abort):
                    if self._stop:
                        return
                    self._cond.wait()
                incoming = list(self._incoming)
                self._incoming.clear()
                cancels = list(self._cancels)
                self._cancels.clear()
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
                        deadline=pending.deadline,
                    )
                    waiters[pending.rid] = pending
                except Exception as e:  # invalid request: fail the caller
                    self._settle(pending, error=e)
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
            if stopping and not self.engine.has_work():
                return


class ServingClient:
    """In-process client: one engine, blocking calls from any thread."""

    def __init__(self, engine: ServingEngine):
        self.runner = EngineRunner(engine)

    def generate(self, prompt: Sequence[int],
                 params: Optional[SamplingParams] = None,
                 timeout: Optional[float] = None,
                 deadline_s: Optional[float] = None, **kw) -> RequestOutput:
        return self.runner.generate(prompt, params, timeout=timeout,
                                    deadline_s=deadline_s, **kw)

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

    def status(self) -> str:
        return self.runner.status()

    def drain(self, timeout: Optional[float] = None) -> bool:
        return self.runner.drain(timeout)

    def close(self) -> None:
        self.runner.close()


def trace_id_of(req: dict) -> str:
    """The request's trace id: taken from a W3C ``traceparent`` field
    (``00-<32 hex>-<16 hex>-<flags>``) when one parses, else minted."""
    tp = req.get("traceparent")
    if isinstance(tp, str):
        parts = tp.strip().lower().split("-")
        if (len(parts) == 4 and len(parts[1]) == 32
                and all(c in "0123456789abcdef" for c in parts[1])
                and parts[1] != "0" * 32):
            return parts[1]
    return os.urandom(16).hex()


def _make_handler(client: ServingClient, tokenizer=None):

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
            if self.path == "/health":
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
                        ("spec", client.runner.engine.spec_stats()))
                       if val is not None},
                })
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def _run_generate(self, req: dict) -> RequestOutput:
            """Parse a /generate body and run it; raises the typed errors
            do_POST maps to HTTP."""
            if not isinstance(req, dict):
                raise ValueError("the request body must be a JSON object")
            for key in req:
                if key in LATER_SLICE_KEYS:
                    raise ValueError(
                        f"field {key!r} is not supported by this server yet"
                    )
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
            params = SamplingParams(
                max_new_tokens=int(req.get("max_new_tokens", 16)),
                temperature=float(req.get("temperature", 1.0)),
                top_k=None if top_k is None else int(top_k),
                seed=int(req.get("seed", 0)),
                eos_token_id=None if eos is None else int(eos),
                stop=(None if stop is None
                      else tuple(tuple(int(t) for t in seq) for seq in stop)),
                priority=str(req.get("priority", "normal")),
                draft_len=None if draft_len is None else int(draft_len),
            )
            deadline_s = req.get("deadline_s")
            return client.generate(
                [int(t) for t in prompt_ids], params,
                timeout=float(req.get("timeout", 600.0)),
                deadline_s=None if deadline_s is None else float(deadline_s),
            )

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            trace_id = None
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                trace_id = trace_id_of(req) if isinstance(req, dict) else None
                out = self._run_generate(req)
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e), "code": "bad_request",
                                  "trace_id": trace_id})
                return
            except QueueFullError as e:
                self._reply(503, {"error": f"server overloaded: {e}",
                                  "code": "queue_full", "trace_id": trace_id},
                            headers=self._retry_after())
                return
            except ShuttingDownError as e:
                self._reply(503, {"error": str(e), "code": "shutting_down",
                                  "trace_id": trace_id},
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
                self._reply(503, {"error": str(e), "code": "page_pool_exhausted",
                                  "trace_id": trace_id}, headers=headers)
                return
            except EngineCrashError as e:
                if getattr(e, "retriable", True):
                    self._reply(503, {"error": f"engine crashed: {e}",
                                      "code": "engine_crash",
                                      "trace_id": trace_id},
                                headers=self._retry_after())
                else:
                    self._reply(503, {"error": str(e), "code": "engine_failed",
                                      "trace_id": trace_id})
                return
            except DeadlineExceededError as e:
                self._reply(504, {
                    "error": str(e), "code": "deadline", "trace_id": trace_id,
                    "partial_tokens": e.output.tokens if e.output else [],
                })
                return
            except TimeoutError:
                self._reply(503, {"error": "generation timed out",
                                  "code": "timeout", "trace_id": trace_id})
                return
            except Exception as e:  # unexpected failure, still typed
                self._reply(500, {"error": str(e) or repr(e),
                                  "code": "internal", "trace_id": trace_id})
                return
            payload = {
                "request_id": out.request_id,
                "prompt_ids": out.prompt,
                "tokens": out.tokens,
                "finish_reason": out.finish_reason,
                "ttft_ms": round(out.ttft * 1e3, 3),
                "trace_id": trace_id,
            }
            if tokenizer is not None:
                payload["text"] = tokenizer.decode(out.tokens)
            self._reply(200, payload)

        def log_message(self, *a):  # quiet by default
            pass

    return Handler


def serve(client: ServingClient, host: str = "127.0.0.1", port: int = 8000,
          tokenizer=None) -> ThreadingHTTPServer:
    """Build the HTTP server (not yet serving; call serve_forever()).
    ``tokenizer`` (data/tokenizer.py) enables text prompts."""
    return ThreadingHTTPServer((host, port), _make_handler(client, tokenizer))


def main() -> None:
    """CLI: serve a training checkpoint (``--checkpoint DIR``, either
    package's format) or a random-init demo model (weights from seed 0)
    over HTTP on ``--device``; ``--tokenizer DIR`` enables text
    prompts."""
    import argparse
    import signal

    import torch

    from differential_transformer_replication_tpu_torch.config import (
        ModelConfig,
        ServingConfig,
    )
    from differential_transformer_replication_tpu_torch.models import init_model

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
    p.add_argument("--max-queue-len", type=int, default=0)
    p.add_argument("--default-deadline", type=float, default=0.0)
    p.add_argument("--drain-timeout", type=float, default=30.0)
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--restart-backoff", type=float, default=0.5)
    p.add_argument("--restart-backoff-max", type=float, default=30.0)
    p.add_argument("--step-time-budget", type=float, default=0.0)
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
                        "each request's own tokens; 'model' (ModelDrafter) "
                        "is refused until it is ported")
    p.add_argument("--spec-draft-len", type=int, default=4,
                   help="draft tokens verified per slot per iteration")
    p.add_argument("--spec-verify", default="exact",
                   choices=("exact", "batched"),
                   help="'exact' (k+1 unrolled L=1 steps: greedy output "
                        "bit-identical to no spec) or 'batched' (one pass "
                        "through the multi-row decode-attention kernel)")
    args = p.parse_args()

    if args.checkpoint:
        from differential_transformer_replication_tpu_torch.train.checkpoint import (
            load_params_for_inference,
        )

        params, model_cfg, meta = load_params_for_inference(
            args.checkpoint, verify=not args.no_verify_checkpoint)
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
        params = init_model(gen, model_cfg)
    tokenizer = None
    if args.tokenizer:
        from differential_transformer_replication_tpu_torch.data.tokenizer import (
            check_tokenizer_matches,
            load_tokenizer,
        )

        tokenizer = load_tokenizer(args.tokenizer)
        if meta is not None:
            # a tokenizer that cannot belong to the checkpoint would
            # silently serve garbage text
            check_tokenizer_matches(
                tokenizer, model_cfg.vocab_size,
                meta.get("tokenizer_fingerprint"), context=args.checkpoint)
    serving = ServingConfig(
        num_slots=args.num_slots, prefill_chunk=args.prefill_chunk,
        prefill_budget=args.prefill_budget, max_seq_len=args.max_seq_len,
        max_queue_len=args.max_queue_len,
        default_deadline_s=args.default_deadline,
        drain_timeout_s=args.drain_timeout, max_restarts=args.max_restarts,
        restart_backoff_s=args.restart_backoff,
        restart_backoff_max_s=args.restart_backoff_max,
        step_time_budget_s=args.step_time_budget,
        kv_cache_dtype=args.kv_cache_dtype, kv_page_size=args.kv_page_size,
        kv_pool_pages=args.kv_pool_pages,
        prefix_cache=not args.no_prefix_cache,
        prefix_cache_pages=args.prefix_cache_pages, spec_mode=args.spec_mode,
        spec_draft_len=args.spec_draft_len, spec_verify=args.spec_verify,
    )
    engine = ServingEngine(params, model_cfg, serving, device=args.device)
    client = ServingClient(engine)
    httpd = serve(client, args.host, args.port, tokenizer)
    drained = {"done": False}

    def _graceful(signum, frame):
        del frame
        print(f"[serve] signal {signum}: draining", file=sys.stderr)

        def _drain_then_stop():
            try:
                ok = client.drain()
                print(f"[serve] drain {'complete' if ok else 'TIMED OUT'}",
                      file=sys.stderr)
            finally:
                drained["done"] = True
                httpd.shutdown()

        threading.Thread(target=_drain_then_stop, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    print(f"[serve] {model_cfg.model} model "
          f"({args.checkpoint or 'random init'}) on {engine.device}, "
          f"{serving.num_slots} slots, {engine.cfg.kv_cache_dtype} KV, "
          f"{'paged' if serving.paged() else 'contiguous'} pool, spec "
          f"{serving.spec_mode or 'off'} — POST "
          f"http://{args.host}:{args.port}/generate")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        if not drained["done"]:
            client.close()


if __name__ == "__main__":
    main()
