"""Multi-host liveness mesh: convert a dead peer into a fast restart.

When one host of a pod dies (SIGKILL preemption, kernel panic, network
partition), the surviving hosts do not crash — they block **forever**
inside the next collective, because the coordination layer only tears
the job down on the *coordinator's* timeout, which defaults to
minutes-to-never depending on the failure. This module is the
out-of-band liveness channel that the collectives lack:

- every process runs a **publisher** thread that writes a small
  ``(process_index, iter, seq, ts)`` heartbeat record every
  ``interval_s`` seconds, *off the train loop* (a wedged loop keeps
  beating; only a dead process goes silent — the local wedge case is
  the step-deadline watchdog's job, train/watchdog.py),
- every process runs a **monitor** thread that reads the peers'
  records and tracks, per peer, the local receipt time of the last
  *change* (``seq`` moved). Staleness is judged against the local
  monotonic clock — never against the peer's embedded wall-clock
  timestamp — so cross-host clock skew cannot fake a death,
- a peer silent past ``timeout_s`` triggers ``on_dead`` exactly once
  per peer — the trainer wires this to
  ``StepWatchdog.trip`` (coordinated abort): every surviving host
  dumps its hang report and exits with the ``hang`` code, the
  supervisor relaunches, and ``--resume-from auto`` (plus
  ``--elastic``) picks the run back up. An infinite wedge becomes a
  supervised restart within seconds.

Transport is pluggable and stdlib-only. :class:`FileHeartbeatTransport`
is the production default — one ``hb-<index>.json`` per process in a
shared-filesystem directory (pods already share checkpoint storage;
writes are atomic-rename so readers never see torn JSON).
:class:`MemoryTransport` backs the tier-1 tests: fake peers, fake
clock, no filesystem, no sleeping.

Observability: per-peer ``train_heartbeat_age_seconds{peer=...}``
gauges (pass the registry gauge in) and the watchdog's ``hang``
records carry the peer ages at abort time.

Fault points (utils/faults.py, resolved lazily so this module stays
importable without the package): ``heartbeat_silence@P`` mutes process
P's publisher — the alive-but-partitioned host.

A copy of the JAX package's ``parallel/heartbeat.py`` (the same files
and record keys, so each package reads the other's), its fault lookup
pointed at the port's ``utils.faults``. On the port's sequence ring the
process index is the rank (train/trainer.py).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Callable, Dict, Optional


def _faults():
    """utils/faults.py, resolved lazily (ckpt_writer.py convention):
    None when unavailable -> injection inert."""
    mod = sys.modules.get(
        "differential_transformer_replication_tpu_torch.utils.faults"
    )
    if mod is not None:
        return mod
    try:
        from differential_transformer_replication_tpu_torch.utils import faults
        return faults
    except Exception:  # standalone import without the package
        return None


class MemoryTransport:
    """In-process transport for tests: a dict guarded by a lock.
    ``publish`` upserts by process index; ``read`` snapshots. Tests
    plant fake-peer records directly via :meth:`publish`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._records: Dict[int, dict] = {}

    def publish(self, record: dict) -> None:
        with self._lock:
            self._records[int(record["process_index"])] = dict(record)

    def read(self) -> Dict[int, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._records.items()}


class FileHeartbeatTransport:
    """One ``hb-<index>.json`` per process in a shared directory.

    Writes go temp-file-then-rename so a reader never parses a torn
    record; a record that still fails to parse (foreign file, torn
    rename on an exotic filesystem) is skipped — a garbage file must
    degrade to "no data for that peer", never crash the monitor. No
    fsync: heartbeats are ephemeral liveness signals, not durable
    state, and an fsync per beat would hammer shared storage."""

    def __init__(self, directory: str) -> None:
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, index: int) -> str:
        return os.path.join(self.directory, f"hb-{int(index)}.json")

    def publish(self, record: dict) -> None:
        path = self._path(record["process_index"])
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(record, f)
            os.replace(tmp, path)
        except OSError:
            # a full/unreachable shared mount: this beat is lost; the
            # publisher retries next interval. Peers see a growing age
            # — which is the correct signal for "this host cannot
            # reach shared storage" anyway.
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def read(self) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            if not name.startswith("hb-") or not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.directory, name)) as f:
                    rec = json.load(f)
                out[int(rec["process_index"])] = rec
            except (OSError, ValueError, KeyError, TypeError):
                continue
        return out


class Heartbeat:
    """Publisher + monitor pair over a transport.

    ``iter_supplier`` returns the host-side iteration counter (read
    without locking — a torn read of an int is harmless telemetry
    noise). ``on_dead(peer_index, age_s)`` fires at most once per peer
    from the monitor thread. ``age_gauge`` is a labeled registry gauge
    (``labelnames=("peer",)``) or None.

    The two threads pace on ``Event.wait(timeout)`` — never a sleep
    under a lock — and both stop on :meth:`close`. With
    ``num_processes == 1`` the monitor has no peers and only the
    publisher runs (its record is still useful: an operator can watch
    a single-host run's liveness file).
    """

    def __init__(
        self,
        transport,
        process_index: int,
        num_processes: int,
        interval_s: float,
        timeout_s: float,
        iter_supplier: Callable[[], int],
        on_dead: Optional[Callable[[int, float], None]] = None,
        age_gauge=None,
        clock: Callable[[], float] = time.monotonic,
        start: bool = True,
    ) -> None:
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if timeout_s <= interval_s:
            raise ValueError(
                f"timeout_s ({timeout_s}) must exceed interval_s "
                f"({interval_s}) — a timeout under one publish period "
                "declares every healthy peer dead"
            )
        self.transport = transport
        self.process_index = int(process_index)
        self.num_processes = int(num_processes)
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self._iter_supplier = iter_supplier
        self._on_dead = on_dead
        self._age_gauge = age_gauge
        self._clock = clock
        self._seq = 0
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # peer -> (last seq seen, local clock at last change); peers
        # get a full timeout of grace from monitor start, so a slow
        # peer bring-up (compiling) is not an instant death sentence
        now = clock()
        self._last_change: Dict[int, tuple] = {
            p: (None, now)
            for p in range(self.num_processes) if p != self.process_index
        }
        self._dead: set = set()
        self._threads = []
        if start:
            self.start()

    def start(self) -> None:
        self.publish_once()  # announce immediately (peers' grace clock)
        self._threads = [
            threading.Thread(target=self._publish_loop,
                             name="heartbeat-publish", daemon=True),
        ]
        if self._last_change:
            self._threads.append(threading.Thread(
                target=self._monitor_loop, name="heartbeat-monitor",
                daemon=True,
            ))
        for t in self._threads:
            t.start()

    def close(self) -> None:
        """Stop both threads and join them (each within 5 s). Safe from
        the monitor thread itself, which the watchdog's exit path runs
        on when a dead peer trips it: a publisher joined here has
        finished its rename, so the exit leaves no temp file behind."""
        self._stop.set()
        me = threading.current_thread()
        for t in self._threads:
            if t is not me:
                t.join(timeout=5.0)

    # -- publisher ------------------------------------------------------

    def publish_once(self) -> None:
        f = _faults()
        if f is not None and hasattr(f, "heartbeat_silenced") \
                and f.heartbeat_silenced(self.process_index):
            return  # chaos: this host is alive but unreachable
        self._seq += 1
        self.transport.publish({
            "process_index": self.process_index,
            "iter": int(self._iter_supplier()),
            "seq": self._seq,
            "ts": round(time.time(), 3),
        })

    def _publish_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.publish_once()

    # -- monitor --------------------------------------------------------

    def peer_ages(self) -> Dict[int, float]:
        """Seconds since each peer's record last changed, judged by the
        LOCAL clock (clock-skew immune)."""
        now = self._clock()
        with self._lock:
            return {
                p: now - seen for p, (_, seen) in self._last_change.items()
            }

    def check_peers(self) -> Dict[int, float]:
        """One monitor pass: refresh change times from the transport,
        export ages, fire ``on_dead`` for newly silent peers. Returns
        the age map (tests drive this synchronously with a fake
        clock)."""
        records = self.transport.read()
        now = self._clock()
        newly_dead = []
        with self._lock:
            for p in list(self._last_change):
                rec = records.get(p)
                last_seq, seen = self._last_change[p]
                if rec is not None and rec.get("seq") != last_seq:
                    self._last_change[p] = (rec.get("seq"), now)
                    continue
                if now - seen > self.timeout_s and p not in self._dead:
                    self._dead.add(p)
                    newly_dead.append((p, now - seen))
            ages = {
                p: now - seen for p, (_, seen) in self._last_change.items()
            }
        # gauge + callback OUTSIDE the lock: on_dead trips the
        # watchdog, which dumps reports and exits — never under a lock
        if self._age_gauge is not None:
            for p, age in ages.items():
                try:
                    self._age_gauge.set(age, peer=str(p))
                except Exception:  # noqa: BLE001
                    pass
        if self._on_dead is not None:
            for p, age in newly_dead:
                self._on_dead(p, age)
        return ages

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.check_peers()
