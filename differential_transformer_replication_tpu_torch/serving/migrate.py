"""Live decode-state migration: wire format + the router's replay journal.

A copy of the JAX package's serving/migrate.py (which imports no JAX):
the same wire format (magic ``DTXM``, version 1, the same framing, meta
keys and per-page CRC32), so either package imports an image the other
exported. Page leaves are host torch tensors here. A bf16 leaf keeps
numpy's dtype name ``"bfloat16"`` in the page layout and travels as its
raw two-byte values (numpy has no bfloat16 of its own, and the JAX
package reads the name through ``ml_dtypes``); it comes back as a
``torch.bfloat16`` tensor.

Zero-loss in-flight failover rides two complementary mechanisms, both
grounded in the same determinism argument (a token's draw is a pure
function of ``(seed, t)`` — serving/engine.py:``draw_seed`` — so a
continuation that restores, or replays, the first ``t`` tokens continues
the sampling stream bit-exactly):

- **Migration** (drain path): one slot's full decode state — page-table
  row worth of live KV pages (int8 values + fp32 scale planes, captured
  with the same ``extract_cache_page`` reads the host tier uses),
  emitted tokens, constraint-FSM cursor, spec counters, priority class
  and remaining deadline — serialized by :func:`encode_slot_state` into
  a versioned, length-prefixed, per-page-CRC32 wire image and shipped to
  a peer replica, which re-admits it through the SAME
  swap-in machinery as host-tier resume (serving/engine.py:
  ``_try_resume``). Pages whose prompt-prefix the destination's radix
  tree already holds are NOT shipped (radix dedup — the destination
  copies them device-locally instead).
- **Replay** (crash path): when the source is already dead there is
  nothing to export; the router resubmits prompt+emitted-so-far as a
  prefill on a peer with ``SamplingParams.key_offset`` carrying the
  key-chain position, so the continuation's tokens are bit-identical
  without any page transfer. The emitted prefix comes from
  :class:`ReplayJournal`, the router's bounded per-inflight-request
  journal.

The fallback ladder is migrate -> replay -> plain retry (driven by the
router, serving/router.py); every rung is typed. A torn or
corrupted transfer is convicted by checksum HERE, at decode — garbage
KV can never be attended.

Checksums reuse serving/host_tier.py's canonical (layer, sorted-key)
CRC32 so a page image that round-trips through the tier and the wire
carries one consistent fingerprint.

The router imports :class:`ReplayJournal` from here, and the router
must not load torch (it keeps routing while the runtimes it fronts
crash), so this module imports torch, and the host tier that needs it,
only inside the functions that move pages.
"""

from __future__ import annotations

import base64
import json
import math
import struct
import threading
from collections import OrderedDict
from dataclasses import asdict
from typing import List, Optional, Tuple

from differential_transformer_replication_tpu_torch.serving.request import (
    SamplingParams,
)

# Wire header: magic + version. Bump the version on ANY layout change —
# a mixed-version fleet mid-rolling-restart must fail typed (and fall
# back to replay), never misparse pages.
MIGRATE_MAGIC = b"DTXM"
MIGRATE_VERSION = 1

_HDR = struct.Struct(">4sHI")       # magic, version, meta length
_PAGE_HDR = struct.Struct(">BII")   # present flag, crc32, section length


def _torch_dtypes() -> dict:
    """page-layout dtype names (numpy's) -> the torch dtypes of the leaves"""
    import torch

    return {
        "float32": torch.float32, "float16": torch.float16,
        "bfloat16": torch.bfloat16, "int8": torch.int8, "uint8": torch.uint8,
        "int16": torch.int16, "int32": torch.int32,
    }


class MigratePayloadError(ValueError):
    """A migration payload that cannot be trusted: torn framing, bad
    magic/version, or a page section whose CRC32 does not match. Typed
    so every caller (import endpoint, drain orchestration) can convict
    the transfer and fall back to replay — never inject garbage KV."""


class MigrateExportError(RuntimeError):
    """A migration that cannot proceed right now: contiguous KV layout
    (nothing page-shaped to ship), the request holds no ACTIVE slot
    (queued / prefilling / already finished), geometry mismatch between
    source and destination engines, or the dedup chain was evicted
    between probe and import. Typed with a machine-readable ``code`` so
    the drain orchestration picks the right fallback rung (replay ->
    plain retry) and counts it — never a wedge."""

    def __init__(self, msg: str, code: str = "migrate_unsupported"):
        super().__init__(msg)
        self.code = code


def params_to_dict(params: SamplingParams) -> dict:
    """SamplingParams -> JSON-safe dict (wire meta). Tuples become
    lists in transit; ``params_from_dict`` round-trips them through
    SamplingParams' own list->tuple normalization."""
    return asdict(params)


def params_from_dict(d: dict) -> SamplingParams:
    return SamplingParams(**d)


def _dtype_name(leaf) -> str:
    """numpy's name of a leaf's dtype (a torch tensor's under its numpy
    name, ``torch.bfloat16`` as ``"bfloat16"``)."""
    import torch

    if isinstance(leaf, torch.Tensor):
        return {dt: name for name, dt in _torch_dtypes().items()}[leaf.dtype]
    return str(leaf.dtype)


def _page_layout(payload) -> list:
    """Serializable (key, dtype, shape) descriptor per layer — the
    slicing recipe :func:`_unpack_page` rebuilds arrays with. Keys are
    sorted so the byte order matches ``payload_checksum``'s canonical
    walk exactly (one fingerprint across tier and wire)."""
    return [
        [
            [key, _dtype_name(layer[key]), list(layer[key].shape)]
            for key in sorted(layer)
        ]
        for layer in payload
    ]


def _pack_page(payload) -> bytes:
    from differential_transformer_replication_tpu_torch.serving.host_tier import (
        leaf_bytes,
    )

    return b"".join(
        leaf_bytes(layer[key])
        for layer in payload
        for key in sorted(layer)
    )


def _leaf_from_bytes(chunk: bytes, dtype, shape):
    """An owned, writable host tensor over a copy of ``chunk``."""
    import torch

    if not chunk:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(chunk), dtype=dtype).reshape(shape)


def _unpack_page(data: bytes, layout: list) -> list:
    dtypes = _torch_dtypes()
    payload = []
    off = 0
    for layer_desc in layout:
        layer = {}
        for key, dtype, shape in layer_desc:
            tdtype = dtypes.get(dtype)
            if tdtype is None:
                raise MigratePayloadError(
                    f"leaf {key!r} has an unknown dtype {dtype!r}"
                )
            n = int(tdtype.itemsize * math.prod(shape))
            chunk = data[off:off + n]
            if len(chunk) != n:
                raise MigratePayloadError(
                    f"torn page section: leaf {key!r} needs {n} bytes, "
                    f"got {len(chunk)}"
                )
            # owned + writable, like the engine's extracted pages
            layer[key] = _leaf_from_bytes(chunk, tdtype, shape)
            off += n
        payload.append(layer)
    if off != len(data):
        raise MigratePayloadError(
            f"page section has {len(data) - off} trailing bytes"
        )
    return payload


def encode_slot_state(meta: dict,
                      payloads: List[Optional[list]]) -> bytes:
    """Serialize one slot's decode state. ``meta`` is a JSON-safe dict
    (prompt, params, generated tokens, FSM cursor, remaining deadline,
    geometry); ``payloads`` is the per-logical-page list of host page
    images (``_extract_page`` output) with ``None`` holes for pages the
    destination's radix tree already holds (dedup — not shipped)."""
    from differential_transformer_replication_tpu_torch.serving.host_tier import (
        payload_checksum,
    )

    first = next((p for p in payloads if p is not None), None)
    meta = dict(meta)
    meta["page_layout"] = _page_layout(first) if first is not None else []
    meta_b = json.dumps(meta).encode("utf-8")
    parts = [_HDR.pack(MIGRATE_MAGIC, MIGRATE_VERSION, len(meta_b)), meta_b]
    parts.append(struct.pack(">I", len(payloads)))
    for payload in payloads:
        if payload is None:
            parts.append(_PAGE_HDR.pack(0, 0, 0))
            continue
        data = _pack_page(payload)
        parts.append(
            _PAGE_HDR.pack(1, payload_checksum(payload), len(data))
        )
        parts.append(data)
    return b"".join(parts)


def decode_slot_state(blob: bytes) -> Tuple[dict, List[Optional[list]]]:
    """Parse + VERIFY a wire image. Every page section's CRC32 is
    recomputed over the rebuilt arrays (the same canonical walk that
    stamped it) before anything reaches the device — a flipped byte
    anywhere in a shipped page raises :class:`MigratePayloadError`."""
    from differential_transformer_replication_tpu_torch.serving.host_tier import (
        payload_checksum,
    )

    if len(blob) < _HDR.size:
        raise MigratePayloadError("torn header")
    magic, version, meta_len = _HDR.unpack_from(blob, 0)
    if magic != MIGRATE_MAGIC:
        raise MigratePayloadError(f"bad magic {magic!r}")
    if version != MIGRATE_VERSION:
        raise MigratePayloadError(
            f"wire version {version} != {MIGRATE_VERSION} (mixed-version "
            "fleet mid-rollout — fall back to replay)"
        )
    off = _HDR.size
    if off + meta_len + 4 > len(blob):
        raise MigratePayloadError("torn meta section")
    try:
        meta = json.loads(blob[off:off + meta_len].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise MigratePayloadError(f"unparseable meta: {e}") from e
    off += meta_len
    (n_pages,) = struct.unpack_from(">I", blob, off)
    off += 4
    layout = meta.get("page_layout") or []
    payloads: List[Optional[list]] = []
    for i in range(n_pages):
        if off + _PAGE_HDR.size > len(blob):
            raise MigratePayloadError(f"torn page {i} header")
        present, crc, n = _PAGE_HDR.unpack_from(blob, off)
        off += _PAGE_HDR.size
        if not present:
            payloads.append(None)
            continue
        if not layout:
            raise MigratePayloadError("shipped page but empty page_layout")
        data = blob[off:off + n]
        if len(data) != n:
            raise MigratePayloadError(
                f"torn page {i}: wanted {n} bytes, got {len(data)}"
            )
        off += n
        payload = _unpack_page(data, layout)
        if payload_checksum(payload) != crc:
            raise MigratePayloadError(
                f"page {i} checksum mismatch — corrupt transfer convicted"
            )
        payloads.append(payload)
    if off != len(blob):
        raise MigratePayloadError(
            f"{len(blob) - off} trailing bytes after page {n_pages - 1}"
        )
    return meta, payloads


def to_wire(blob: bytes) -> str:
    """Binary image -> JSON-safe transport string (base64)."""
    return base64.b64encode(blob).decode("ascii")


def from_wire(text: str) -> bytes:
    try:
        return base64.b64decode(text.encode("ascii"), validate=True)
    except Exception as e:
        raise MigratePayloadError(f"undecodable transport body: {e}") from e


class ReplayJournal:
    """Bounded per-inflight-request journal of emitted tokens.

    The router harvests each replica's ``GET /inflight`` snapshot into
    this journal; on a retriable replica death it replays prompt +
    journaled tokens on a peer (``key_offset`` = journal length).
    Correctness needs only a PREFIX of the truly-emitted tokens —
    harvest lag just means a few tokens are re-generated bit-exactly —
    so updates may lag and entries may be truncated by the per-request
    cap without ever producing a wrong continuation.

    Bounded two ways: ``max_tokens`` caps each entry (a runaway
    generation cannot balloon the journal — the entry stops growing and
    replay degrades gracefully to a longer re-decode), and finished
    entries ride an LRU of ``max_finished`` so post-finish stragglers
    (late duplicate replies) still resolve without unbounded growth.
    ``router_replay_journal_bytes`` mirrors :meth:`stats`.
    """

    _TOKEN_BYTES = 4  # int32-equivalent accounting per journaled token

    def __init__(self, max_tokens: int = 4096,
                 max_finished: int = 1024) -> None:
        self.max_tokens = int(max_tokens)
        self.max_finished = int(max_finished)
        self._lock = threading.Lock()
        self._live: "OrderedDict[str, list]" = OrderedDict()
        self._finished: "OrderedDict[str, int]" = OrderedDict()
        self._bytes = 0
        self._evicted = 0

    def begin(self, journal_id: str) -> None:
        """Register an in-flight request (idempotent)."""
        with self._lock:
            if journal_id not in self._live:
                self._live[journal_id] = []

    def update(self, journal_id: str, tokens: List[int]) -> None:
        """Extend a live entry to the harvested emitted-token prefix.
        Only ever GROWS an entry (a stale probe body cannot shrink the
        journal below what a fresher one recorded) and never past the
        per-request cap."""
        with self._lock:
            cur = self._live.get(journal_id)
            if cur is None or len(tokens) <= len(cur):
                return
            grown = [int(t) for t in tokens[:self.max_tokens]]
            if len(grown) > len(cur):
                self._bytes += (len(grown) - len(cur)) * self._TOKEN_BYTES
                self._live[journal_id] = grown

    def tokens(self, journal_id: str) -> Optional[List[int]]:
        """The journaled emitted-token prefix (a copy), or None when the
        request was never registered (plain retry is the only rung)."""
        with self._lock:
            cur = self._live.get(journal_id)
            return list(cur) if cur is not None else None

    def finish(self, journal_id: str) -> None:
        """Retire an entry: its token bytes are released and the id
        moves to the finished LRU (late duplicate replies resolve as
        finished instead of re-registering)."""
        with self._lock:
            cur = self._live.pop(journal_id, None)
            if cur is not None:
                self._bytes -= len(cur) * self._TOKEN_BYTES
            self._finished[journal_id] = 1
            self._finished.move_to_end(journal_id)
            while len(self._finished) > self.max_finished:
                self._finished.popitem(last=False)
                self._evicted += 1

    def finished(self, journal_id: str) -> bool:
        with self._lock:
            return journal_id in self._finished

    def stats(self) -> dict:
        with self._lock:
            return {
                "bytes": self._bytes,
                "entries": len(self._live),
                "finished": len(self._finished),
                "evicted_total": self._evicted,
            }
