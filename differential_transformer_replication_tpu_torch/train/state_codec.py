"""The checkpoint codec: flax's msgpack state format in pure Python.

The JAX package writes ``state.msgpack`` with ``flax.serialization.
to_bytes``: the state tree becomes a *state dict* (lists and tuples are
maps with keys ``"0"``, ``"1"``, ...; optax's named tuples are maps of
their fields), and that is packed by ``msgpack.packb(..., strict_types=
True)`` with arrays as msgpack ext type 1, whose data is itself
``packb((shape, dtype name, C-order bytes), use_bin_type=True)``, and
numpy scalars as ext type 3 in the same form. Arrays over
``MAX_CHUNK_SIZE`` bytes are split into a map ``{"__msgpack_chunked_
array__": True, "shape": ..., "chunks": ...}`` of flat pieces.

Neither ``msgpack`` nor ``flax`` is imported here: :func:`packb` writes
nil, bool, int, float, str, bin, array, map and ext with the same
smallest encodings as ``msgpack.packb``, so :func:`to_bytes` of a tree
equals ``flax.serialization.to_bytes`` of the same tree byte for byte,
and :func:`from_bytes` reads what flax writes, chunked arrays included.

Leaves: numpy arrays and scalars, and torch tensors (written from the
host copy; ``torch.bfloat16`` under numpy's name ``"bfloat16"``).
Reading gives numpy arrays, except ``bfloat16`` arrays, which numpy has
no type for: their bytes become ``torch.bfloat16`` tensors directly.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: msgpack caps an object at 2**31 - 1
# bytes, flax splits arrays past 2**30
MAX_CHUNK_SIZE = 2**30
CHUNKED_KEY = "__msgpack_chunked_array__"
EXT_NDARRAY = 1
EXT_NPSCALAR = 3

_TORCH_DTYPE_NAMES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.bool: "bool",
}


# -- state dicts ------------------------------------------------------------


def to_state_dict(tree):
    """flax's ``to_state_dict`` for plain trees: dict keys as ``str``
    (insertion order kept), lists and tuples as maps ``{"0": ...}``,
    leaves as they are."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def lists_from_index_maps(tree):
    """The inverse for the trees checkpoints hold: a non-empty map whose
    keys are exactly ``"0"`` .. ``"n-1"`` becomes a list."""
    if isinstance(tree, dict):
        out = {k: lists_from_index_maps(v) for k, v in tree.items()}
        if out and set(out) == {str(i) for i in range(len(out))}:
            return [out[str(i)] for i in range(len(out))]
        return out
    return tree


# -- leaves -----------------------------------------------------------------


def _leaf_parts(x):
    """(shape, dtype name, the C-order bytes as a flat uint8 view) of an
    array-like leaf; no copy of a C-contiguous host array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        name = _TORCH_DTYPE_NAMES.get(t.dtype)
        if name is None:
            raise TypeError(f"cannot serialize a tensor of dtype {t.dtype}")
        arr = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        shape = tuple(t.shape)
    else:
        arr = np.asarray(x)
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be serialized")
        shape, name = arr.shape, arr.dtype.name
    return shape, name, np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def _pack_leaf(code: int, x, out: list) -> None:
    """Ext ``code`` around ``packb((shape, name, data))``, the data
    appended as a view of the array (joined once, by the caller)."""
    shape, name, data = _leaf_parts(x)
    head = [b"\x93"]
    _pack([int(s) for s in shape], head)
    _pack(name, head)
    _pack_len(data.size, None, -1, (0xC4, 0xC5, 0xC6), head)
    head = b"".join(head)
    _pack_ext_header(code, len(head) + data.size, out)
    out.append(head)
    out.append(data)


def _leaf_nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _array_from(shape, name: str, buf):
    """An array from its shape, dtype name and bytes (a writable buffer
    gives a writable array without a copy)."""
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        if not len(buf):
            return torch.empty(shape, dtype=torch.bfloat16)
        if memoryview(buf).readonly:  # torch wants a writable buffer
            buf = bytearray(buf)
        return torch.frombuffer(buf, dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext_leaf(code: int, data: memoryview):
    shape, name, buf = _Reader(data).read()
    if isinstance(name, (bytes, memoryview)):
        name = bytes(name).decode()
    arr = _array_from(shape, name, buf)
    if code == EXT_NPSCALAR:
        return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
    return arr


# -- msgpack ----------------------------------------------------------------


def _pack_int(v: int, out: list) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -0x20 <= v < 0:
        out.append(struct.pack("b", v))
    elif 0x80 <= v <= 0xFF:
        out.append(struct.pack("BB", 0xCC, v))
    elif -0x80 <= v < 0:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif 0xFF < v <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, v))
    elif -0x8000 <= v < -0x80:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, v))
    elif -0x80000000 <= v < -0x8000:
        out.append(struct.pack(">Bi", 0xD2, v))
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, v))
    elif -0x8000000000000000 <= v < -0x80000000:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")


def _pack_len(n: int, small_tag: int, small_max: int, tags, out: list) -> None:
    """The header of a str, bin, array or map of length ``n``: the fix
    form up to ``small_max`` (if any), then 8-, 16- or 32-bit lengths."""
    if small_tag is not None and n <= small_max:
        out.append(struct.pack("B", small_tag | n))
        return
    t8, t16, t32 = tags
    if t8 is not None and n <= 0xFF:
        out.append(struct.pack("BB", t8, n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", t16, n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", t32, n))
    else:
        raise ValueError(f"object of length {n} exceeds msgpack's 32-bit lengths")


def _pack_ext_header(code: int, n: int, out: list) -> None:
    """The header of an ext object of ``n`` data bytes."""
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fix:
        out.append(struct.pack("B", fix[n]))
    elif n <= 0xFF:
        out.append(struct.pack(">BB", 0xC7, n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xC8, n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xC9, n))
    else:
        raise ValueError(f"ext payload of {n} bytes exceeds msgpack's limit")
    out.append(struct.pack("b", code))


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif type(obj) in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _pack_len(len(data), None, -1, (0xC4, 0xC5, 0xC6), out)
        out.append(data)
    elif type(obj) is list:
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif type(obj) is dict:
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_leaf(EXT_NDARRAY, obj, out)
    elif isinstance(obj, np.generic):
        _pack_leaf(EXT_NPSCALAR, np.asarray(obj), out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True, strict_types=True)`` with
    flax's ext hook: exact types only (a tuple is refused, as msgpack's
    strict mode refuses it), arrays and tensors as ext 1, numpy scalars
    as ext 3."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    """msgpack decoder over a buffer: maps become dicts, arrays lists,
    bin a memoryview slice of the buffer (no copy), ext 1 and 3 arrays."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early (truncated)")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _str(self, n: int) -> str:
        return bytes(self._take(n)).decode("utf-8")

    def _seq(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = self._unpack("b")
        data = self._take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        return _ext_leaf(code, data)

    def read(self):
        b = self._unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._seq(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self._unpack(ints[b])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lens:
            n = self._unpack(lens[b])
            if b in (0xC4, 0xC5, 0xC6):
                return self._take(n)
            if b in (0xD9, 0xDA, 0xDB):
                return self._str(n)
            if b in (0xDC, 0xDD):
                return self._seq(n)
            if b in (0xDE, 0xDF):
                return self._map(n)
            return self._ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        raise ValueError(f"invalid msgpack byte 0x{b:02x} at {self.pos - 1}")


def unpackb(data):
    """Decode one msgpack object that fills ``data`` (bytes, bytearray
    or memoryview; a writable buffer gives writable arrays)."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of extra data after "
                         "the msgpack object")
    return obj


# -- flax's chunking and the state bytes ------------------------------------


def _chunk(x) -> dict:
    """flax's ``_chunk``: a flat split of an oversized array."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(x, torch.Tensor) else flat.size
    return {CHUNKED_KEY: True,
            "shape": {str(i): int(s) for i, s in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _chunk_leaves(d):
    # like flax, only array leaves reached through maps are chunked
    if isinstance(d, dict):
        return {k: _chunk_leaves(v) for k, v in d.items()}
    if isinstance(d, (np.ndarray, torch.Tensor)) and _leaf_nbytes(d) > MAX_CHUNK_SIZE:
        return _chunk(d)
    return d


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    parts = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts).reshape(shape)
    return np.concatenate(parts).reshape(shape)


def _unchunk_leaves(d):
    if isinstance(d, dict):
        if CHUNKED_KEY in d:
            return _unchunk(d)
        return {k: _unchunk_leaves(v) for k, v in d.items()}
    return d


def to_bytes(tree) -> bytes:
    """``flax.serialization.to_bytes(tree)`` for a tree of dicts, lists,
    tuples and array leaves."""
    return packb(_chunk_leaves(to_state_dict(tree)))


def from_bytes(data):
    """The state dict of ``flax.serialization.msgpack_restore``: maps
    as dicts (lists stay maps ``{"0": ...}``, see
    :func:`lists_from_index_maps`), chunked arrays joined."""
    return _unchunk_leaves(unpackb(data))
