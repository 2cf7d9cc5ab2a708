"""The msgpack codec of the JAX package's checkpoints, in pure Python.

The subset of ``flax.serialization`` that ``train/checkpoint.py`` uses:
``to_bytes`` and ``msgpack_restore`` over nested dicts whose leaves are
numpy arrays, Python scalars (int, float, bool, str, bytes), ``None``
or empty dicts. The bytes are flax's, byte for byte:

- msgpack as ``msgpack.packb(tree, use_bin_type=True, strict_types=True)``
  writes it (the smallest int, str, bin, array, map and ext headers;
  floats as float64; dict order kept);
- an ndarray is ext type 1 holding the msgpack of ``(shape, dtype name,
  C-order buffer)``; a numpy scalar is ext type 3, the same body;
- an array of more than ``MAX_CHUNK_SIZE`` bytes under a dict key is
  written in flax's chunked form, ``{"__msgpack_chunked_array__": True,
  "shape": {"0": ..}, "chunks": {"0": flat chunk, ..}}``, and read back
  as one array.

No ``msgpack`` package is needed. Dtypes that numpy lacks (bfloat16)
are refused with an error naming the leaf's dtype.
"""

from __future__ import annotations

import struct
from typing import Any, Iterator, List, Tuple

import numpy as np

# flax's: msgpack's limit is 2**31 - 1 bytes an object; arrays above
# this many bytes are split into flat chunks of at most this size.
MAX_CHUNK_SIZE = 2 ** 30

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"

_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


# ----------------------------------------------------------------- writing

def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0x80 <= n <= 0xFF:
        return struct.pack("BB", 0xCC, n)
    if -0x80 <= n < 0:
        return struct.pack(">Bb", 0xD0, n)
    if 0xFF < n <= 0xFFFF:
        return struct.pack(">BH", 0xCD, n)
    if -0x8000 <= n < -0x80:
        return struct.pack(">Bh", 0xD1, n)
    if 0xFFFF < n <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, n)
    if -0x80000000 <= n < -0x8000:
        return struct.pack(">Bi", 0xD2, n)
    if 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, n)
    if -0x8000000000000000 <= n < -0x80000000:
        return struct.pack(">Bq", 0xD3, n)
    raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")


def _sized(n: int, small: int, codes: Tuple) -> bytes:
    """The header of a str/bin/array/map of ``n`` units: the fix form
    below ``small`` (0 = none), then 8-, 16- and 32-bit lengths (an
    array or a map has no 8-bit form: ``codes[0]`` is then None)."""
    if n < small:
        return struct.pack("B", codes[0] | n)
    if codes[1] is not None and n <= 0xFF:
        return struct.pack("BB", codes[1], n)
    if n <= 0xFFFF:
        return struct.pack(">BH", codes[2], n)
    if n <= 0xFFFFFFFF:
        return struct.pack(">BI", codes[3], n)
    raise ValueError(f"msgpack object of {n} units is too large")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 32, (0xA0, 0xD9, 0xDA, 0xDB)) + b


def _bin_header(n: int) -> bytes:
    return _sized(n, 0, (0, 0xC4, 0xC5, 0xC6))


def _ext_header(code: int, n: int) -> bytes:
    if n in _FIXEXT:
        return struct.pack("Bb", _FIXEXT[n], code)
    if n <= 0xFF:
        return struct.pack(">BBb", 0xC7, n, code)
    if n <= 0xFFFF:
        return struct.pack(">BHb", 0xC8, n, code)
    return struct.pack(">BIb", 0xC9, n, code)


def _ndarray(code: int, arr: np.ndarray) -> List[Any]:
    """flax's ndarray ext: the msgpack of (shape, dtype name, buffer) as
    the ext body. Returns [header bytes, buffer] so the buffer is never
    copied here."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    buf = memoryview(arr.reshape(-1)).cast("B") if arr.size else b""
    body = (_sized(3, 16, (0x90, None, 0xDC, 0xDD))
            + _sized(arr.ndim, 16, (0x90, None, 0xDC, 0xDD))
            + b"".join(_int(int(d)) for d in arr.shape)
            + _str(arr.dtype.name) + _bin_header(len(buf)))
    return [_ext_header(code, len(body) + len(buf)) + body, buf]


def _chunk(arr: np.ndarray) -> dict:
    """flax's ``_chunk``: a canonical dict of flat chunks."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = np.ascontiguousarray(arr).reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[lo:lo + size] for i, lo in
                       enumerate(range(0, flat.size, size))}}


def _oversized(x: Any) -> bool:
    return isinstance(x, np.ndarray) and x.size * x.dtype.itemsize \
        > MAX_CHUNK_SIZE


def _pack(obj: Any, out: List[Any]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) in (bytes, bytearray):
        out.append(_bin_header(len(obj)))
        out.append(bytes(obj))
    elif type(obj) is str:
        out.append(_str(obj))
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is list:
        out.append(_sized(len(obj), 16, (0x90, None, 0xDC, 0xDD)))
        for item in obj:
            _pack(item, out)
    elif type(obj) is dict:
        out.append(_sized(len(obj), 16, (0x80, None, 0xDE, 0xDF)))
        for key, value in obj.items():
            _pack(key, out)
            _pack(_chunk(value) if _oversized(value) else value, out)
    elif isinstance(obj, np.ndarray):
        out.extend(_ndarray(EXT_NDARRAY, obj))
    elif isinstance(obj, np.generic):
        out.extend(_ndarray(EXT_NPSCALAR, np.asarray(obj)))
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def encode_chunks(tree: Any) -> Iterator[Any]:
    """The pieces of ``to_bytes(tree)`` in order (bytes, or memoryviews
    of the arrays' own buffers), for a caller that hashes and writes
    them without joining them into one object."""
    out: List[Any] = []
    _pack(_chunk(tree) if _oversized(tree) else tree, out)
    return iter(out)


def to_bytes(tree: Any) -> bytes:
    """``flax.serialization.to_bytes`` of a state dict: the same bytes."""
    return b"".join(encode_chunks(tree))


# ----------------------------------------------------------------- reading

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self, raw: bool) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.read(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            data = self.take(self.unpack({0xC4: "B", 0xC5: ">H",
                                          0xC6: ">I"}[b]))
            return data if raw else bytes(data)
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: "B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack({0xD9: "B", 0xDA: ">H", 0xDB: ">I"}[b])
            return self.str(n, raw)
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.read(raw) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), raw)
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def str(self, n: int, raw: bool):
        data = self.take(n)
        return bytes(data) if raw else str(data, "utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            key = self.read(raw)
            out[key] = self.read(raw)
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack("b")
        body = _Reader(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack ext type {code}")
        shape, name, buf = body.read(raw=True)
        name = name.decode()
        try:
            if name == "bfloat16":  # only an add-on (ml_dtypes) gives numpy one
                raise TypeError(name)
            dtype = np.dtype(name)
        except TypeError:
            raise ValueError(
                f"array leaf of dtype {name!r}: numpy has no such dtype, "
                f"so the PyTorch port cannot read it (its checkpoints "
                f"hold float32 params, moments and EMA)") from None
        arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
        return arr[()] if code == EXT_NPSCALAR else arr


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for key, value in d.items():
            if isinstance(value, dict):
                d[key] = (_unchunk(value) if CHUNKED in value
                          else _unchunk_leaves(value))
    return d


def msgpack_restore(data) -> Any:
    """``flax.serialization.msgpack_restore``: the tree ``data`` holds,
    maps as dicts, arrays as numpy arrays over ``data``'s own buffer
    (read-only when ``data`` is ``bytes``). Raises ValueError on
    truncated or trailing bytes."""
    reader = _Reader(data)
    tree = reader.read(raw=False)
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes of extra "
                         f"data after the msgpack object")
    return _unchunk_leaves(tree)
