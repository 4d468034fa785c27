"""Step-deadline watchdog: no training iteration may hang silently.

On a real pod the dominant training failure is not a crash the
supervisor (tools/train_supervisor.py) can see — it is a *wedge*: one
host dies or stalls and every other host blocks forever inside a
``psum``, burning the whole slice with zero signal. This is the
trainer analogue of the serving engine's ``step_time_budget_s``
watchdog (serving/server.py), with one crucial difference: a serving
iteration that blows its budget is merely flagged degraded, but a
training iteration that blows its deadline is **unrecoverable from
inside the process** (the device call cannot be interrupted), so the
watchdog converts the silent hang into a *supervised restart*:

1. dump a ``hang_report.json`` — every thread's stack, the current
   iteration, the compile counter, the last ``device_profile`` row,
   whatever context callables the trainer wired in — so the wedge is
   debuggable post-mortem,
2. emit one ``{"record": "hang"}`` metrics row and bump
   ``train_watchdog_fires_total``,
3. ``os._exit`` with :data:`HANG_EXIT_CODE`, a code
   ``tools/train_supervisor.py:classify_exit`` maps to the ``hang``
   outcome (restartable, budgeted separately from ``crash``).

``os._exit`` (not ``sys.exit``) is deliberate: the main thread is
wedged inside a device call, so no Python-level unwinding can run —
the rescue-save machinery would itself hang. The step-checkpoint tree
plus ``--resume-from auto`` is the recovery path, exactly like a
SIGKILL.

The watchdog is also the **coordinated-abort** sink for the multi-host
liveness mesh (parallel/heartbeat.py): a peer silent past its
heartbeat timeout calls :meth:`StepWatchdog.trip`, which fires
immediately — armed or not — converting "wait out the collective
forever" into "restart within seconds".

A copy of the JAX package's ``train/watchdog.py`` (same exit code,
report keys and arming contract), so ``tools/train_supervisor.py``
restarts either package's trainer on a ``hang``.

Module scope imports only the stdlib (the ckpt_writer.py convention):
everything device-flavored reaches the report through injected context
callables, and the clock / exit function are injectable so tier-1
tests exercise every path without killing the test process.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

# Exit status of a watchdog fire. Distinct from every code the trainer
# can exit with organically (0, 1, tracebacks) and outside the shell's
# 128+signal band, so the supervisor can classify it unambiguously as
# ``hang``. Mirrored in tools/train_supervisor.py (which must not
# import this package — keep the two in sync).
HANG_EXIT_CODE = 113


def thread_stacks() -> Dict[str, str]:
    """Formatted stack of every live thread, keyed by thread name —
    the first thing a hang post-mortem needs (WHERE is the main thread
    blocked: a psum, a device_get, a disk write?)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, str] = {}
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, f"thread-{ident}")
        out[name] = "".join(traceback.format_stack(frame))
    return out


def dump_hang_report(
    path: str,
    iter_num: Optional[int],
    reason: str,
    budget_s: float,
    context: Optional[Dict[str, Callable[[], object]]] = None,
) -> dict:
    """Write the hang post-mortem JSON (best-effort atomic: temp +
    rename; a watchdog firing must never die half-way through its own
    diagnostics). Context callables are evaluated here, each guarded —
    a broken introspection hook must not eat the report."""
    report: dict = {
        "record": "hang",
        "ts": round(time.time(), 3),
        "iter": iter_num,
        "reason": reason,
        "budget_s": budget_s,
        "pid": os.getpid(),
        "threads": thread_stacks(),
    }
    for key, fn in (context or {}).items():
        try:
            report[key] = fn()
        except Exception as e:  # noqa: BLE001 — diagnostics stay best-effort
            report[key] = f"<context error: {e!r}>"
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError as e:
        print(f"[watchdog] could not write hang report to {path!r}: {e!r}",
              file=sys.stderr)
    return report


class StepWatchdog:
    """Deadline monitor for the train loop's armed sections.

    Contract: the trainer calls :meth:`arm` with the current iteration
    before each section that must make progress (the jitted-step
    dispatch plus the host syncs that follow it, the log-boundary
    fetch) and :meth:`disarm` after — legitimately long sections
    (eval, checkpoint writes) run disarmed. A monitor thread fires
    when an armed deadline expires; :meth:`trip` fires immediately
    from any thread regardless of arming (the heartbeat mesh's
    coordinated abort).

    ``budget_s <= 0`` disables the deadline monitor (no thread) but
    keeps :meth:`trip` live, so a heartbeat-only configuration still
    has an abort path. All fire paths converge on ``_fire``, which
    runs at most once per process.

    Injectables — ``clock`` (monotonic seconds), ``exit_fn`` (defaults
    to ``os._exit``), ``sink`` (metrics-row callable), ``fires_counter``
    (``.inc()``-able) — exist so tests can drive expiry with a fake
    clock and observe the fire instead of dying from it.
    """

    def __init__(
        self,
        budget_s: float,
        report_path: Optional[str] = None,
        sink: Optional[Callable[[dict], None]] = None,
        fires_counter=None,
        context: Optional[Dict[str, Callable[[], object]]] = None,
        clock: Callable[[], float] = time.monotonic,
        exit_fn: Callable[[int], None] = os._exit,
        poll_s: Optional[float] = None,
        report_timeout_s: float = 10.0,
    ) -> None:
        self.budget_s = float(budget_s)
        self.report_path = report_path
        self._sink = sink
        self._fires_counter = fires_counter
        self._context = dict(context or {})
        self._clock = clock
        self._exit_fn = exit_fn
        self._report_timeout_s = float(report_timeout_s)
        self._lock = threading.Lock()
        self._armed = False
        self._deadline = 0.0
        self._iter: Optional[int] = None
        self._fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._exit_hooks: List[Callable[[], None]] = []
        if self.budget_s > 0:
            self._poll_s = (
                float(poll_s) if poll_s is not None
                else min(max(self.budget_s / 4.0, 0.01), 0.25)
            )
            self._thread = threading.Thread(
                target=self._monitor, name="train-watchdog", daemon=True
            )
            self._thread.start()

    @property
    def fired(self) -> bool:
        with self._lock:
            return self._fired

    def add_context(self, **fns: Callable[[], object]) -> None:
        """Register more report-time context callables (the trainer
        wires these up as the subsystems they introspect come to
        exist: compile counter, device-profile sampler, heartbeat
        ages)."""
        self._context.update(fns)

    def add_exit_hook(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` on the fire path just before the exit, after the
        report: the heartbeat's publisher is stopped and joined there, so
        no half-written ``hb-<i>.json.tmp.<pid>`` outlives the process."""
        self._exit_hooks.append(fn)

    def arm(self, iter_num: int, budget_s: Optional[float] = None) -> None:
        """Start (or refresh) the deadline for one armed section."""
        budget = self.budget_s if budget_s is None else float(budget_s)
        with self._lock:
            self._armed = True
            self._iter = int(iter_num)
            self._deadline = self._clock() + budget

    def disarm(self) -> None:
        with self._lock:
            self._armed = False

    def check(self) -> None:
        """Synchronous expiry check (tests; monitor-less budgets)."""
        with self._lock:
            expired = (
                self._armed and not self._fired
                and self._clock() > self._deadline
            )
            iter_num = self._iter
        if expired:
            self._fire(
                f"train step exceeded its {self.budget_s:.1f}s deadline "
                f"at iter {iter_num}", iter_num,
            )

    def trip(self, reason: str) -> None:
        """Immediate fire from any thread, armed or not — the
        heartbeat mesh's coordinated abort: a dead peer means the next
        collective wedges, so waiting for the local deadline only
        burns budget."""
        with self._lock:
            iter_num = self._iter
        self._fire(reason, iter_num)

    def close(self) -> None:
        """Stop the monitor thread (normal trainer shutdown)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # -- internals ------------------------------------------------------

    def _monitor(self) -> None:
        while not self._stop.wait(self._poll_s):
            self.check()

    def _fire(self, reason: str, iter_num: Optional[int]) -> None:
        with self._lock:
            if self._fired:
                return
            self._fired = True
            self._armed = False
        print(f"[watchdog] {reason} — dumping hang report and exiting "
              f"{HANG_EXIT_CODE} for a supervised restart",
              file=sys.stderr, flush=True)
        if self._fires_counter is not None:
            try:
                self._fires_counter.inc()
            except Exception:  # noqa: BLE001
                pass

        def _diagnose() -> None:
            report = (
                dump_hang_report(self.report_path, iter_num, reason,
                                 self.budget_s, self._context)
                if self.report_path else
                {"record": "hang", "ts": round(time.time(), 3),
                 "iter": iter_num, "reason": reason,
                 "budget_s": self.budget_s}
            )
            if self._sink is not None:
                try:
                    # the metrics row carries the summary, not the
                    # stacks (those belong in the report file)
                    self._sink({
                        k: v for k, v in report.items() if k != "threads"
                    })
                except Exception:  # noqa: BLE001
                    pass
            done.set()

        # The diagnostics do blocking I/O — and the likeliest hang on a
        # pod IS stuck shared storage, which is also where the report
        # path usually lives (the checkpoint mount). Writing from the
        # fire thread would wedge the watchdog itself (open/fsync on a
        # hung mount never raises, it blocks), so the report runs on a
        # bounded helper thread: give it report_timeout_s, then exit
        # regardless. Exiting with the hang code is the contract; the
        # post-mortem is best-effort.
        done = threading.Event()
        threading.Thread(target=_diagnose, name="watchdog-report",
                         daemon=True).start()
        if not done.wait(self._report_timeout_s):
            print(f"[watchdog] hang report did not complete within "
                  f"{self._report_timeout_s:.0f}s (diagnostics storage "
                  "is itself stuck?); exiting without it",
                  file=sys.stderr, flush=True)
        for hook in self._exit_hooks:
            try:
                hook()
            except Exception:  # noqa: BLE001 — exiting is the contract
                pass
        self._exit_fn(HANG_EXIT_CODE)
