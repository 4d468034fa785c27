"""Local serving fleet: launch, supervise, and rolling-restart N
replicas of the port's server behind the health-aware router.

The port's twin of the repo's ``tools/fleet.py`` (which launches the
JAX package's server): the same ``Fleet`` surface, restart policy,
event records and ``main`` flags, launching
``python -m differential_transformer_replication_tpu_torch.serving.server``
replicas instead, with the port's router (serving/router.py) riding
in the same process. Each replica is one server process on its own
port, on ``cuda`` unless the server arguments pass ``--device cpu``,
and the fleet keeps them alive —

  - a CRASHED replica (segfault, OOM kill, SIGKILL preemption) is
    relaunched after ``backoff_base * 2^restarts`` seconds (capped),
    up to ``--max-restarts`` per replica; the router ejects it while
    it is down and slowly re-admits it once ``/ready`` answers again;
  - a replica that exits CLEANLY (rc 0 — e.g. an operator's SIGTERM
    drain outside a rolling restart) is NOT relaunched: someone asked
    it to stop;
  - ``rolling_restart()`` upgrades the fleet with zero dropped
    requests: one replica at a time, SIGTERM (the server drains —
    admission stops with 503 + Retry-After, in-flight requests
    finish), wait for exit, relaunch, wait for ``/ready``, then move
    to the next. The router sees ``draining`` and routes around the
    replica the whole time — connection-free removal.

CLI (replicas + router in one process tree)::

    python -m differential_transformer_replication_tpu_torch.serving.fleet \
        --replicas 2 --router-port 8000 -- --device cpu --num-slots 4

Everything after ``--`` is passed through to every replica's
``serving.server`` CLI verbatim. SIGHUP triggers a rolling restart;
SIGTERM/SIGINT drain and stop the whole fleet. Every launch/exit
appends one JSON line to ``--fleet-log`` for forensics.

No torch import — the fleet must stay alive when the runtime it
babysits is the thing crashing. (serving/router.py, serving/retry.py
and serving/admission.py are stdlib-only and safe to import here; the
package's serving/__init__ resolves its torch-heavy exports lazily.)
The supervisor's restart arithmetic, :func:`backoff_s` and
:func:`classify_exit`, are copies of the repo's
``tools/train_supervisor.py`` functions, so this module imports nothing
from ``tools/``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence

from differential_transformer_replication_tpu_torch.obs.events import (
    open_event_log,
)

SERVER_MODULE = "differential_transformer_replication_tpu_torch.serving.server"

# Exit status of a step-deadline watchdog fire — kept in sync with
# train/watchdog.py:HANG_EXIT_CODE (not imported: the train package
# loads torch, which this supervisor must outlive; the value is part of
# the trainer<->supervisor contract like a signal number).
HANG_EXIT_CODE = 113


def classify_exit(rc: int) -> str:
    """clean / hang / sigterm / sigkill / crash from a subprocess
    returncode (negative rc = death by that signal; 128+N covers
    shells that re-report signal deaths as exit codes). ``hang`` is
    the step-deadline watchdog's distinct exit (train/watchdog.py): a
    wedged step, restartable like a crash but budgeted separately —
    a flaky host that hangs repeatedly must not eat the crash budget
    a genuinely flaky run needs (and vice versa)."""
    if rc == 0:
        return "clean"
    if rc == HANG_EXIT_CODE:
        return "hang"
    sig = -rc if rc < 0 else (rc - 128 if 128 < rc < 160 else None)
    if sig == signal.SIGTERM:
        return "sigterm"
    if sig == signal.SIGKILL:
        return "sigkill"
    return "crash"


def backoff_s(restart: int, base: float, cap: float) -> float:
    return min(base * (2 ** restart), cap)


def pick_free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (best-effort: released before the
    replica binds it, so a collision is possible but vanishingly rare
    on a loopback test host)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def wait_http_ready(url: str, timeout_s: float = 120.0,
                    interval_s: float = 0.1) -> bool:
    """Poll ``GET <url>/ready`` until it answers 200. A reachable 503
    (draining/restarting) keeps polling — the process is up but not
    admitting; transport errors mean it is still booting."""
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        try:
            with urllib.request.urlopen(url + "/ready", timeout=2.0) as r:
                if r.status == 200:
                    return True
        except urllib.error.HTTPError:
            pass  # alive, not ready yet
        except OSError:
            pass  # not listening yet
        time.sleep(interval_s)
    return False


class ReplicaProc:
    """One replica's process slot: argv, port, restart accounting."""

    def __init__(self, index: int, host: str, port: int,
                 argv: List[str], env: Optional[dict]):
        self.index = index
        self.host = host
        self.port = port
        self.argv = argv
        self.env = env
        self.proc: Optional[subprocess.Popen] = None
        self.restarts = 0
        self.expected_exit = False  # rolling restart / fleet stop
        self.gave_up = False        # restart budget exhausted

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class Fleet:
    """Launch + supervise N local replicas; see module docstring.

    Programmatic surface (what tests/test_torch_fleet.py's chaos test
    and chip_smoke.py's serve-fleet phase drive): ``start()``, ``urls``, ``rolling_restart()``, ``kill()``
    (chaos: SIGKILL one replica and let supervision relaunch it),
    ``stop()``.
    """

    def __init__(self, num_replicas: int,
                 server_args: Optional[Sequence[str]] = None,
                 host: str = "127.0.0.1",
                 ports: Optional[Sequence[int]] = None,
                 python: str = sys.executable,
                 env: Optional[dict] = None,
                 max_restarts: int = 3,
                 backoff_base: float = 0.5,
                 backoff_max: float = 10.0,
                 ready_timeout_s: float = 120.0,
                 drain_exit_timeout_s: float = 60.0,
                 fleet_log: Optional[str] = None,
                 replica_env: Optional[Dict[int, dict]] = None):
        if num_replicas < 1:
            raise ValueError(f"need >= 1 replica, got {num_replicas}")
        self.host = host
        self.max_restarts = max_restarts
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.ready_timeout_s = ready_timeout_s
        self.drain_exit_timeout_s = drain_exit_timeout_s
        self.fleet_log = fleet_log
        # structured JSONL (obs/events.py): same shape as the router's
        # and replicas' event logs, so fleet forensics join on ts
        self._events = open_event_log(fleet_log, process="fleet")
        ports = list(ports) if ports else [
            pick_free_port(host) for _ in range(num_replicas)
        ]
        if len(ports) != num_replicas:
            raise ValueError(
                f"{num_replicas} replicas but {len(ports)} ports"
            )
        # kept as templates so scale_up()/relaunch_replica() can mint
        # NEW replica slots long after __init__
        self._python = python
        self._server_args = list(server_args or [])
        self._base_env = dict(env) if env is not None else None
        self._replica_env = dict(replica_env or {})
        self._next_index = num_replicas
        self.replicas = [
            self._make_replica(i, port) for i, port in enumerate(ports)
        ]
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._supervisor: Optional[threading.Thread] = None
        # restart relaunch deadlines (monotonic ts), per replica index
        self._relaunch_at: Dict[int, float] = {}

    def _make_replica(self, index: int, port: int,
                      server_args: Optional[Sequence[str]] = None,
                      extra_env: Optional[dict] = None) -> ReplicaProc:
        """Build one replica slot from the fleet's templates.
        ``server_args`` replaces the shared extra args for this slot
        (canary: new checkpoint/config); ``extra_env`` layers on top of
        the per-index env overrides (canary: arm a fault on one
        replica)."""
        extra = (self._server_args if server_args is None
                 else list(server_args))

        def _render(arg: str) -> str:
            # per-replica templating: shared server_args naming a file
            # path ("--trace-path", "--event-log") must not make N
            # replicas clobber one file — "{replica}"/"{port}" expand
            # per process
            return (arg.replace("{replica}", str(index))
                       .replace("{port}", str(port)))

        # per-replica env overrides (chaos tests arm DTX_FAULTS on
        # ONE replica; the others must stay healthy)
        base = dict(self._base_env) if self._base_env is not None else None
        override = dict(self._replica_env.get(index) or {})
        if extra_env:
            override.update(extra_env)
        if override:
            base = dict(os.environ) if base is None else base
            base.update(override)
        return ReplicaProc(
            index, self.host, port,
            [self._python, "-m", SERVER_MODULE,
             "--host", self.host, "--port", str(port)]
            + [_render(a) for a in extra],
            env=base,
        )

    # -- observability -------------------------------------------------

    @property
    def urls(self) -> List[str]:
        return [r.url for r in self.replicas]

    def _log(self, record: dict) -> None:
        printable = {"time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
                     **record}
        print(f"[fleet] {json.dumps(printable)}", file=sys.stderr)
        record = dict(record)
        self._events.emit(record.pop("event", "fleet_event"), **record)
        self._events.flush()  # fleet events are rare; land them now

    # -- lifecycle -----------------------------------------------------

    def _launch(self, r: ReplicaProc) -> None:
        r.proc = subprocess.Popen(r.argv, env=r.env)
        self._log({"event": "launch", "replica": r.index,
                   "port": r.port, "pid": r.proc.pid,
                   "restarts": r.restarts})

    def start(self, wait_ready: bool = True) -> "Fleet":
        for r in self.replicas:
            self._launch(r)
        if wait_ready:
            for r in self.replicas:
                if not wait_http_ready(r.url, self.ready_timeout_s):
                    self.stop()
                    raise RuntimeError(
                        f"replica {r.index} ({r.url}) not ready within "
                        f"{self.ready_timeout_s}s"
                    )
        self._supervisor = threading.Thread(
            target=self._supervise_loop, name="fleet-supervisor",
            daemon=True,
        )
        self._supervisor.start()
        return self

    def _supervise_loop(self) -> None:
        """Relaunch crashed replicas with backoff + restart budget
        (train_supervisor semantics, one budget per replica)."""
        while not self._stop.wait(0.05):
            now = time.monotonic()
            for r in self.replicas:
                with self._lock:
                    if (r.expected_exit or r.gave_up or r.proc is None
                            or r.proc.poll() is None):
                        continue
                    due = self._relaunch_at.get(r.index)
                    if due is None:
                        rc = r.proc.returncode
                        outcome = classify_exit(rc)
                        self._log({"event": "exit", "replica": r.index,
                                   "rc": rc, "outcome": outcome})
                        if outcome == "clean":
                            # someone asked it to stop; honor that
                            r.gave_up = True
                            continue
                        if r.restarts >= self.max_restarts:
                            self._log({
                                "event": "give_up", "replica": r.index,
                                "restarts": r.restarts,
                            })
                            r.gave_up = True
                            continue
                        delay = backoff_s(r.restarts, self.backoff_base,
                                          self.backoff_max)
                        r.restarts += 1
                        self._relaunch_at[r.index] = now + delay
                        self._log({"event": "backoff", "replica": r.index,
                                   "delay_s": round(delay, 3),
                                   "restart": r.restarts})
                    elif due <= now:
                        del self._relaunch_at[r.index]
                        self._launch(r)

    def kill(self, index: int) -> None:
        """Chaos helper: SIGKILL one replica (uncatchable, no drain).
        Supervision relaunches it on the backoff schedule."""
        r = self.replicas[index]
        if r.alive():
            r.proc.send_signal(signal.SIGKILL)

    def wait_ready(self, index: int,
                   timeout_s: Optional[float] = None) -> bool:
        return wait_http_ready(
            self.replicas[index].url,
            self.ready_timeout_s if timeout_s is None else timeout_s,
        )

    # -- rolling restart / scaling ------------------------------------

    def _migrate_drain(self, r: ReplicaProc, pre_drain) -> None:
        """Best-effort live migration before the SIGTERM drain: hand
        ``pre_drain`` (the router's ``migrate_out``, or a closure
        POSTing the router's ``/drain``) the victim's URL so ACTIVE
        decodes move to peers FIRST — drain time becomes page-transfer
        time instead of ``max_new_tokens``' worth of decoding. A
        failure here only means the classic finish-in-place drain does
        the work; the requests are never harmed."""
        if pre_drain is None or not r.alive():
            return
        try:
            result = pre_drain(r.url)
        except Exception as e:
            self._log({"event": "drain_migrate_failed",
                       "replica": r.index, "error": repr(e)})
            return
        self._log({"event": "drain_migrate", "replica": r.index,
                   **(result if isinstance(result, dict) else {})})

    def _drain_exit(self, r: ReplicaProc) -> None:
        """SIGTERM (the server drains: admission stops, in-flight
        requests finish), wait for exit, escalate to SIGKILL on a
        wedged straggler."""
        if r.alive():
            r.proc.send_signal(signal.SIGTERM)
            try:
                r.proc.wait(self.drain_exit_timeout_s)
            except subprocess.TimeoutExpired:
                self._log({"event": "drain_timeout_kill",
                           "replica": r.index})
                r.proc.kill()
                r.proc.wait(10)

    def _restart_one(self, r: ReplicaProc, ready_check=None,
                     pre_drain=None) -> None:
        """Drain one replica, relaunch it (on whatever argv/env the
        slot now carries), wait for /ready and the optional
        ``ready_check`` gate, then grant a fresh supervision lease.
        ``pre_drain(url)`` (optional — the router's ``migrate_out``)
        live-migrates ACTIVE decodes to peers before the SIGTERM."""
        with self._lock:
            r.expected_exit = True  # supervisor: hands off
            self._relaunch_at.pop(r.index, None)
        try:
            self._log({"event": "rolling_drain", "replica": r.index})
            self._migrate_drain(r, pre_drain)
            self._drain_exit(r)
            self._launch(r)
            if not wait_http_ready(r.url, self.ready_timeout_s):
                raise RuntimeError(
                    f"replica {r.index} ({r.url}) did not come back "
                    f"within {self.ready_timeout_s}s after rolling "
                    "restart"
                )
            if ready_check is not None:
                end = time.monotonic() + self.ready_timeout_s
                while not ready_check(r):
                    if time.monotonic() >= end:
                        raise RuntimeError(
                            f"replica {r.index} ({r.url}) ready but "
                            "not re-admitted (ready_check) within "
                            f"{self.ready_timeout_s}s"
                        )
                    time.sleep(0.05)
            with self._lock:
                # a deliberate operator restart grants a fresh
                # supervision lease — without this, a replica that
                # had exhausted its budget (or exited cleanly once)
                # would be revived yet silently unsupervised
                r.gave_up = False
                r.restarts = 0
            self._log({"event": "rolling_done", "replica": r.index})
        finally:
            with self._lock:
                r.expected_exit = False

    def rolling_restart(self, ready_check=None, pre_drain=None) -> None:
        """Drain-aware, one replica at a time; see module docstring.
        Raises when a replica fails to come back — continuing would
        take the NEXT replica down too and shrink the fleet to zero.

        ``ready_check(replica)`` (optional) gates the move to the next
        replica beyond the replica's own ``/ready``: pass a probe of
        the ROUTER's view (replica re-admitted, i.e. state ``up``) so
        the restart never drains replica k+1 while the router is still
        slow-re-admitting replica k — the zero-eligible window that
        would shed requests.

        ``pre_drain(url)`` (optional) live-migrates each replica's
        ACTIVE decodes to peers before its SIGTERM (pass the router's
        ``migrate_out``) — the restart's wall-clock stops depending on
        the longest in-flight ``max_new_tokens``."""
        for r in list(self.replicas):
            self._restart_one(r, ready_check=ready_check,
                              pre_drain=pre_drain)

    def relaunch_replica(self, index: int,
                         server_args: Optional[Sequence[str]] = None,
                         extra_env: Optional[dict] = None,
                         argv: Optional[List[str]] = None,
                         env: Optional[dict] = None,
                         ready_check=None, pre_drain=None):
        """Drain ONE replica and relaunch it on a different command
        line — the canary-rollout primitive. ``server_args`` replaces
        the fleet's shared extra args for this slot (new checkpoint /
        config) and ``extra_env`` layers env on top; ``argv``/``env``
        override verbatim instead (rollback passes back exactly what
        this method returned). Returns the PREVIOUS ``(argv, env)``.
        """
        r = next((x for x in self.replicas if x.index == index), None)
        if r is None:
            raise ValueError(f"no replica with index {index}")
        old = (list(r.argv),
               dict(r.env) if r.env is not None else None)
        if argv is not None:
            r.argv = list(argv)
            r.env = dict(env) if env is not None else None
        elif server_args is not None or extra_env:
            fresh = self._make_replica(
                index, r.port, server_args=server_args,
                extra_env=extra_env,
            )
            r.argv, r.env = fresh.argv, fresh.env
        if pre_drain is None:
            self._restart_one(r, ready_check=ready_check)
        else:
            self._restart_one(r, ready_check=ready_check,
                              pre_drain=pre_drain)
        return old

    def scale_up(self, n: int = 1, wait_ready: bool = True) -> List[str]:
        """Launch ``n`` NEW replica slots (fresh indices, fresh restart
        budgets, OS-assigned ports) and hand them to supervision.
        Returns their URLs (register them with the router next)."""
        if n < 1:
            raise ValueError(f"scale_up needs n >= 1, got {n}")
        with self._lock:
            added = []
            for _ in range(n):
                idx = self._next_index
                self._next_index += 1
                added.append(
                    self._make_replica(idx, pick_free_port(self.host))
                )
            # publish before launching: the supervisor skips slots with
            # no process, so a half-launched batch is never relaunched
            self.replicas = self.replicas + added
        for r in added:
            self._launch(r)
        self._log({"event": "scale_up", "n": n,
                   "replicas": [r.index for r in added],
                   "fleet_size": len(self.replicas)})
        if wait_ready:
            for r in added:
                if not wait_http_ready(r.url, self.ready_timeout_s):
                    raise RuntimeError(
                        f"scaled-up replica {r.index} ({r.url}) not "
                        f"ready within {self.ready_timeout_s}s"
                    )
        return [r.url for r in added]

    def scale_down(self, index: Optional[int] = None,
                   score_of=None, pre_drain=None) -> str:
        """Drain ONE replica out of the fleet, zero-loss, and RELEASE
        its supervision lease (slot removed, pending relaunch
        cancelled) — a later scale_up mints a fresh slot with a fresh
        restart budget instead of inheriting this one's scars.

        Victim selection: explicit ``index`` wins; else the
        LEAST-LOADED replica by ``score_of(url)`` (pass the router's
        load score — draining the busiest replica would orphan the
        most in-flight work onto its siblings); else the highest
        index. ``pre_drain(url)`` (optional — the router's
        ``migrate_out``) live-migrates the victim's ACTIVE decodes to
        the surviving peers before its SIGTERM. Returns the removed
        replica's URL."""
        with self._lock:
            candidates = [r for r in self.replicas if not r.expected_exit]
            if len(self.replicas) <= 1 or not candidates:
                raise ValueError("cannot scale below one replica")
            if index is not None:
                victim = next(
                    (r for r in candidates if r.index == index), None
                )
                if victim is None:
                    raise ValueError(f"no replica with index {index}")
            else:
                victim = None
                if score_of is not None:
                    scored = []
                    for r in candidates:
                        s = score_of(r.url)
                        if s is not None:
                            scored.append((s, r.index, r))
                    if scored:
                        victim = min(scored)[2]
                if victim is None:
                    victim = max(candidates, key=lambda r: r.index)
            victim.expected_exit = True  # supervisor hands off
            self._relaunch_at.pop(victim.index, None)
        self._log({"event": "scale_down_drain", "replica": victim.index,
                   "fleet_size": len(self.replicas)})
        self._migrate_drain(victim, pre_drain)
        self._drain_exit(victim)
        with self._lock:
            self.replicas = [r for r in self.replicas if r is not victim]
            self._relaunch_at.pop(victim.index, None)
        self._log({
            "event": "scale_down_done", "replica": victim.index,
            "rc": victim.proc.returncode if victim.proc else None,
            "fleet_size": len(self.replicas),
        })
        return victim.url

    # -- shutdown ------------------------------------------------------

    def stop(self, drain: bool = True) -> None:
        """SIGTERM everything (graceful drain), escalate to SIGKILL on
        stragglers, stop supervision."""
        self._stop.set()
        with self._lock:
            for r in self.replicas:
                r.expected_exit = True
        if self._supervisor is not None:
            self._supervisor.join(5.0)
            self._supervisor = None
        for r in self.replicas:
            if r.alive():
                r.proc.send_signal(
                    signal.SIGTERM if drain else signal.SIGKILL
                )
        deadline = time.monotonic() + (
            self.drain_exit_timeout_s if drain else 10.0
        )
        for r in self.replicas:
            if r.proc is None:
                continue
            left = max(0.1, deadline - time.monotonic())
            try:
                r.proc.wait(left)
            except subprocess.TimeoutExpired:
                self._log({"event": "stop_kill", "replica": r.index})
                r.proc.kill()
                r.proc.wait(10)
            self._log({"event": "stopped", "replica": r.index,
                       "rc": r.proc.returncode})
        # SIGTERM path: the buffered event tail must land (the atexit
        # net in obs/events.py is the last resort, not the plan)
        self._events.close()


def main() -> None:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--base-port", type=int, default=0,
                   help="first replica port (consecutive from here); "
                        "0 = OS-assigned free ports")
    p.add_argument("--router-port", type=int, default=8000)
    p.add_argument("--max-restarts", type=int, default=3,
                   help="per-replica crash-relaunch budget")
    p.add_argument("--backoff-base", type=float, default=0.5)
    p.add_argument("--backoff-max", type=float, default=10.0)
    p.add_argument("--ready-timeout", type=float, default=120.0)
    p.add_argument("--fleet-log", default=None,
                   help="append one JSON line per fleet event "
                        "(obs/events.py shape)")
    p.add_argument("--router-trace-path", default=None,
                   help="write the IN-PROCESS router's span trace "
                        "(pick/forward/retry/hedge; the clock "
                        "reference tools/trace_stitch.py wants first) "
                        "to this path")
    p.add_argument("--router-event-log", default=None,
                   help="append the router's structured JSONL events "
                        "(request finished/failed/retried, replica "
                        "ejection/re-admission) to this path")
    p.add_argument("--hedge-factor", type=float, default=0.0,
                   help="router hedging knob (0 = off); see "
                        "RouterConfig.hedge_factor")
    p.add_argument("server_args", nargs=argparse.REMAINDER,
                   help="-- then extra serving.server CLI args passed "
                        "to every replica")
    args = p.parse_args()

    server_args = list(args.server_args)
    if server_args and server_args[0] == "--":
        server_args = server_args[1:]
    ports = None
    if args.base_port:
        ports = [args.base_port + i for i in range(args.replicas)]

    fleet = Fleet(
        args.replicas, server_args=server_args, host=args.host,
        ports=ports, max_restarts=args.max_restarts,
        backoff_base=args.backoff_base, backoff_max=args.backoff_max,
        ready_timeout_s=args.ready_timeout, fleet_log=args.fleet_log,
    )
    print(f"[fleet] launching {args.replicas} replicas: "
          f"{fleet.urls}", file=sys.stderr)
    fleet.start()

    # the router rides in this process: stdlib-only import chain
    from differential_transformer_replication_tpu_torch.config import (
        RouterConfig,
    )
    from differential_transformer_replication_tpu_torch.serving.router import (
        Router,
        serve_router,
    )

    router_tracer = None
    if args.router_trace_path:
        from differential_transformer_replication_tpu_torch.obs.spans import (
            SpanTracer,
        )

        router_tracer = SpanTracer(args.router_trace_path,
                                   process_name="router")
    router = Router(
        fleet.urls,
        RouterConfig(hedge_factor=args.hedge_factor),
        tracer=router_tracer,
        events=open_event_log(args.router_event_log, process="router"),
    ).start()
    httpd = serve_router(router, args.host, args.router_port)

    stopping = threading.Event()

    def _stop_all(signum, frame):
        del frame
        print(f"[fleet] signal {signum}: stopping fleet", file=sys.stderr)
        stopping.set()
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    by_url = {rep.url: rep for rep in router.replicas}

    def _router_readmitted(r) -> bool:
        # gate the rolling restart on the ROUTER's view, not just the
        # replica's own /ready — see Fleet.rolling_restart
        rep = by_url.get(r.url)
        return rep is None or rep.eligible()

    def _rolling(signum, frame):
        del frame
        print("[fleet] SIGHUP: rolling restart", file=sys.stderr)

        def run():
            try:
                fleet.rolling_restart(ready_check=_router_readmitted,
                                      pre_drain=router.migrate_out)
            except Exception as e:
                print(f"[fleet] rolling restart FAILED: {e!r}",
                      file=sys.stderr)

        threading.Thread(target=run, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop_all)
    signal.signal(signal.SIGINT, _stop_all)
    if hasattr(signal, "SIGHUP"):
        signal.signal(signal.SIGHUP, _rolling)

    print(f"[fleet] router on http://{args.host}:{args.router_port} "
          f"over {fleet.urls} — SIGHUP = rolling restart",
          file=sys.stderr)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        router.close()
        if router_tracer is not None:
            router_tracer.close()
        router.events.close()
        fleet.stop()


if __name__ == "__main__":
    main()
