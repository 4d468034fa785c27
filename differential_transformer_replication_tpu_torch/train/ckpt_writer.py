"""Durable-checkpoint machinery: integrity manifests, atomic+fsynced
writes, `step-NNNNNNNN` rotation with retention GC, and the background
writer thread that keeps checkpoint I/O off the train loop.

Durability model (CheckFreq/Gemini-style, PAPERS.md):

- **Atomicity**: every file lands via :func:`atomic_write` — temp file,
  fsync, rename over the destination, fsync of the parent directory
  (without the last step the *rename itself* can be lost on power
  failure even though both file contents survived).
- **Certification**: a checkpoint directory is trustworthy iff its
  ``manifest.json`` verifies — per-file SHA-256 + byte sizes, plus the
  step and config hash. The manifest is written LAST, so a crash at any
  earlier point leaves a directory that :func:`verify_checkpoint`
  rejects and ``latest``-resolution skips. Loaders re-hash before
  deserializing, so a corrupted or partially-written checkpoint is
  never silently loaded.
- **Rotation**: periodic snapshots live in ``<root>/step-NNNNNNNN``
  directories. :func:`gc_step_checkpoints` keeps the newest
  ``keep_last`` verified checkpoints (plus every ``keep_every``-th
  step forever) and deletes the rest manifest-FIRST — the inverse of
  the write order, so a crash mid-delete leaves an unverified (hence
  skipped) directory, never a verified-but-truncated one.
- **Async**: :class:`AsyncCheckpointWriter` runs serialization + file
  I/O on a daemon thread; the train loop blocks only for the
  device->host snapshot. One save may be in flight at a time — a
  submit while one is running blocks (back-pressure) and reports the
  blocked wall time for the ``ckpt_blocked`` telemetry.

A copy of the JAX package's ``train/ckpt_writer.py`` (which imports no
jax): the same files, names and order of writes, so a checkpoint tree
either package writes verifies in the other. It imports only the stdlib
at module scope. Fault points (``ckpt_write``, ``ckpt_fsync``,
``ckpt_manifest``, ``ckpt_gc``, ``ckpt_hang``) fire from the port's own
``utils.faults`` plan, looked up at the first point.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import re
import shutil
import threading
import time
from typing import Callable, List, Optional, Tuple

MANIFEST_NAME = "manifest.json"
MANIFEST_FORMAT = 1
_STEP_DIR_RE = re.compile(r"^step-(\d+)$")


class CheckpointError(RuntimeError):
    """A checkpoint on disk cannot be trusted or read: truncated/corrupt
    file, failed digest verification, or a layout from an incompatible
    run. Always names the offending path — the actionable signal (delete,
    repair, or re-point) a deep msgpack/KeyError traceback buries."""


def _faults():
    """The process-wide fault-injection plan (the port's utils/faults.py,
    stdlib only), resolved at the first fault point so this module
    imports only the stdlib at module scope; inert until armed."""
    from differential_transformer_replication_tpu_torch.utils import faults

    return faults


def _fault_check(point: str) -> None:
    _faults().check(point)


def _fault_stall(point: str) -> None:
    _faults().stall(point)


# -- atomic + durable file I/O --------------------------------------------


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY: makes renames/unlinks inside it durable. A
    rename is only crash-safe once the directory entry itself is on
    disk — fsyncing the file is not enough. Best-effort on platforms
    without directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(dest: str, data: bytes) -> None:
    """Durable atomic replace: write ``dest + ".tmp"``, fsync the file,
    rename over ``dest``, fsync the parent directory. A crash at ANY
    point leaves either the old content or the new content at ``dest``,
    never a mixture — and once this returns, the new content survives
    power loss.

    Fault points: ``ckpt_write`` fires between the temp fsync and the
    rename (temp fully written, destination untouched); ``ckpt_fsync``
    fires between the rename and the directory fsync (the window where
    a power cut can roll the rename back)."""
    tmp = dest + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        _fault_check("ckpt_write")
        os.replace(tmp, dest)
        _fault_check("ckpt_fsync")
        fsync_dir(os.path.dirname(dest) or ".")
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def file_sha256(path: str, chunk_size: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk_size), b""):
            h.update(block)
    return h.hexdigest()


# -- integrity manifest ---------------------------------------------------


def write_manifest(
    path: str, step: int, config_hash: Optional[str] = None
) -> dict:
    """Hash every regular file in the checkpoint dir and write
    ``manifest.json`` LAST (atomic + fsynced), certifying the
    checkpoint: its presence + passing digests are what
    :func:`verify_checkpoint` trusts. Fault point ``ckpt_manifest``
    fires just before the write — a crash there leaves a complete but
    UNcertified directory, exactly what latest-resolution must skip."""
    files = {}
    for name in sorted(os.listdir(path)):
        fp = os.path.join(path, name)
        if name == MANIFEST_NAME or name.endswith(".tmp"):
            continue
        if not os.path.isfile(fp):
            continue
        files[name] = {
            "sha256": file_sha256(fp),
            "bytes": os.path.getsize(fp),
        }
    manifest = {
        "format": MANIFEST_FORMAT,
        "step": int(step),
        "files": files,
        "written_at": round(time.time(), 3),
    }
    if config_hash:
        manifest["config_hash"] = config_hash
    _fault_check("ckpt_manifest")
    atomic_write(
        os.path.join(path, MANIFEST_NAME),
        json.dumps(manifest, indent=1, sort_keys=True).encode(),
    )
    return manifest


def read_manifest(path: str) -> dict:
    """The dir's manifest, or a :class:`CheckpointError` naming the path
    when it is missing (uncertified: the save was interrupted before
    certification, or predates integrity manifests) or unparseable."""
    mp = os.path.join(path, MANIFEST_NAME)
    try:
        with open(mp, "rb") as f:
            manifest = json.loads(f.read().decode())
    except FileNotFoundError:
        raise CheckpointError(
            f"no integrity manifest at {mp!r} — the checkpoint is "
            "uncertified (the save was interrupted before the manifest "
            "write, or it predates integrity manifests; "
            "tools/ckpt_doctor.py --adopt-legacy can stamp one)"
        ) from None
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointError(
            f"cannot parse integrity manifest at {mp!r}: {e}. The file "
            "is truncated or corrupt — the checkpoint cannot be trusted"
        ) from e
    if not isinstance(manifest, dict) or not isinstance(
        manifest.get("files"), dict
    ):
        raise CheckpointError(
            f"integrity manifest at {mp!r} has no 'files' table — the "
            "file is corrupt or not a checkpoint manifest"
        )
    return manifest


def verify_checkpoint(path: str) -> dict:
    """Re-hash every manifest-listed file and compare sizes + SHA-256
    digests. Returns the manifest on success; raises
    :class:`CheckpointError` naming the first offending file and the
    expected/actual digest on any mismatch."""
    if not os.path.isdir(path):
        raise CheckpointError(f"no checkpoint directory at {path!r}")
    manifest = read_manifest(path)
    for name, rec in sorted(manifest["files"].items()):
        fp = os.path.join(path, name)
        if not os.path.isfile(fp):
            raise CheckpointError(
                f"checkpoint file {fp!r} is listed in the manifest but "
                "missing on disk — the checkpoint is incomplete"
            )
        size = os.path.getsize(fp)
        want_size = rec.get("bytes")
        if want_size is not None and size != want_size:
            raise CheckpointError(
                f"checkpoint file {fp!r} is {size} bytes, manifest "
                f"expects {want_size} — the file is truncated or was "
                "rewritten outside a certified save"
            )
        digest = file_sha256(fp)
        if digest != rec.get("sha256"):
            raise CheckpointError(
                f"checkpoint file {fp!r} fails integrity verification: "
                f"expected sha256 {rec.get('sha256')}, got {digest} — "
                "the file is corrupt; resume from a different checkpoint "
                "or repair with tools/ckpt_doctor.py"
            )
    return manifest


def is_verified(path: str) -> bool:
    """Whether the directory holds a certified, digest-clean checkpoint
    (the no-raise form of :func:`verify_checkpoint`)."""
    try:
        verify_checkpoint(path)
        return True
    except CheckpointError:
        return False


def is_certified(path: str) -> bool:
    """Whether the directory carries a parseable manifest — the save
    COMPLETED — without re-hashing its contents. Retention decisions
    key on this (cheap: one small json read per dir, not a full-tree
    digest pass on every periodic save); digest-level trust is checked
    where it matters, at resume/load/doctor time."""
    try:
        read_manifest(path)
        return True
    except CheckpointError:
        return False


# -- step rotation + latest resolution ------------------------------------


def step_dir_name(step: int) -> str:
    return f"step-{int(step):08d}"


def parse_step_dir(name: str) -> Optional[int]:
    m = _STEP_DIR_RE.match(name)
    return int(m.group(1)) if m else None


def list_step_checkpoints(root: str) -> List[Tuple[int, str]]:
    """(step, path) for every ``step-*`` directory under root,
    ascending by step — verified or not."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        step = parse_step_dir(name)
        path = os.path.join(root, name)
        if step is not None and os.path.isdir(path):
            out.append((step, path))
    return sorted(out)


def latest_verified_checkpoint(
    root: str,
) -> Tuple[Optional[str], List[Tuple[str, str]]]:
    """The newest ``step-*`` checkpoint under ``root`` that passes
    manifest verification, falling back to older ones — so a crash
    mid-save (which leaves the newest dir uncertified) can never wedge
    a restart. Returns ``(path_or_None, skipped)`` where ``skipped``
    lists ``(path, reason)`` for every newer dir that failed."""
    skipped: List[Tuple[str, str]] = []
    for step, path in reversed(list_step_checkpoints(root)):
        try:
            verify_checkpoint(path)
            return path, skipped
        except CheckpointError as e:
            skipped.append((path, str(e)))
    return None, skipped


# -- retention GC ---------------------------------------------------------


def delete_checkpoint_dir(path: str) -> None:
    """Crash-safe checkpoint deletion: the manifest goes FIRST (and the
    removal is made durable with a directory fsync), atomically turning
    the dir into an uncertified one that every reader already skips;
    only then are the data files and the directory removed. The inverse
    of the write order — no crash point leaves a certified directory
    with missing or partial data. Fault point ``ckpt_gc`` fires in the
    window between de-certification and data deletion."""
    manifest = os.path.join(path, MANIFEST_NAME)
    try:
        os.unlink(manifest)
    except FileNotFoundError:
        pass
    fsync_dir(path)
    _fault_check("ckpt_gc")
    shutil.rmtree(path, ignore_errors=True)
    parent = os.path.dirname(path)
    if parent:
        fsync_dir(parent)


def gc_step_checkpoints(
    root: str, keep_last: int, keep_every: int = 0
) -> Tuple[List[str], List[str]]:
    """Retention policy over the ``step-*`` tree: keep the newest
    ``keep_last`` CERTIFIED checkpoints (manifest present — see
    :func:`is_certified`; GC is retention, not a digest audit), plus
    every checkpoint whose step is a multiple of ``keep_every`` (0 =
    none); delete the rest — including uncertified leftovers from
    crashed saves. Single-writer: the caller (the async writer thread,
    or an operator running ckpt_doctor on an idle tree) must be the
    only process mutating ``root``. Returns ``(kept, deleted)``
    paths."""
    entries = list_step_checkpoints(root)
    certified = [(s, p) for s, p in entries if is_certified(p)]
    keep = {p for _, p in certified[-keep_last:]} if keep_last > 0 else set()
    if keep_every > 0:
        keep |= {p for s, p in certified if s % keep_every == 0}
    kept, deleted = [], []
    for _, path in entries:
        if path in keep:
            kept.append(path)
        else:
            delete_checkpoint_dir(path)
            deleted.append(path)
    return kept, deleted


# -- the async writer -----------------------------------------------------


class AsyncCheckpointWriter:
    """One daemon thread that runs checkpoint save jobs (serialize +
    write + certify + GC) off the train loop.

    Contract: at most ONE save is in flight. :meth:`submit` hands the
    job over immediately when the writer is idle; while a save is still
    running it BLOCKS (back-pressure — checkpoints must not silently
    pile up host-RAM snapshots faster than the disk drains them) and
    returns the blocked wall-clock seconds so the caller can feed its
    ``ckpt_blocked`` histogram. A job that raises does not kill the
    thread: the first error is stored and re-raised from the next
    :meth:`submit` or :meth:`close` on the caller's thread, where the
    trainer can decide whether a failed periodic save is fatal.

    The caller must hand jobs that close over HOST data only (the
    device->host snapshot happens on the submitting thread) — each
    pending job pins one host-RAM copy of the state until written.
    """

    def __init__(self, save_hist=None, blocked_hist=None) -> None:
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        self._idle = threading.Event()
        self._idle.set()
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self._save_hist = save_hist
        self._blocked_hist = blocked_hist
        self.last_save_s: Optional[float] = None
        self.saves_completed = 0
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name="ckpt-writer", daemon=True
        )
        self._thread.start()

    @property
    def drained(self) -> bool:
        """Whether the writer is closed AND its thread has exited —
        i.e. no save can still be touching the checkpoint tree. The
        trainer's rescue save asserts this before writing (a rescue
        interleaving with an in-flight periodic save would race its
        retention GC)."""
        return self._closed and not self._thread.is_alive()

    def _raise_pending(self) -> None:
        with self._error_lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def submit(self, job: Callable[[], None]) -> float:
        """Enqueue one save job; returns seconds spent blocked waiting
        for a still-in-flight previous save (0.0 when idle). A PRIOR
        job's stored error is re-raised — but only after THIS job is
        enqueued, so one transient disk failure loses exactly the save
        that failed, never also the healthy snapshot that follows it."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointWriter is closed")
        t0 = time.perf_counter()
        self._idle.wait()
        blocked = time.perf_counter() - t0
        if self._blocked_hist is not None:
            self._blocked_hist.observe(blocked)
        self._idle.clear()
        self._q.put(job)
        self._raise_pending()
        return blocked

    def _loop(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            t0 = time.perf_counter()
            try:
                job()
            except BaseException as e:  # noqa: BLE001 — surfaced on submit/close
                with self._error_lock:
                    if self._error is None:
                        self._error = e
            else:
                # success-only bookkeeping: a failed job must not show
                # up as a healthy save duration in the telemetry
                dt = time.perf_counter() - t0
                self.last_save_s = dt
                self.saves_completed += 1
                if self._save_hist is not None:
                    self._save_hist.observe(dt)
            finally:
                # drop the closure BEFORE blocking on the next get():
                # it pins the multi-GB host snapshot it closed over,
                # which must be freed when the save lands, not held for
                # the whole next ckpt_interval window
                job = None
                self._idle.set()

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain: finish any in-flight/queued save, stop the thread,
        re-raise the first stored job error. Called from the trainer's
        exit path so a graceful stop never abandons a half-queued
        snapshot."""
        if not self._closed:
            self._closed = True
            self._q.put(None)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError(
                "checkpoint writer thread did not drain within "
                f"{timeout}s (a save is stuck in file I/O)"
            )
        self._raise_pending()
