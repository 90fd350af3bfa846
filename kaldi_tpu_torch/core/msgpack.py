"""The subset of MessagePack that flax's ``serialization.to_bytes`` /
``from_bytes`` use for a tree of arrays, without the ``msgpack`` or
``flax`` packages.

A tree is a ``dict`` of ``str`` keys whose leaves are numpy arrays.  A
leaf goes out as msgpack ext type 1 whose payload is itself msgpack: the
array ``(shape, dtype name, C-order bytes)``, as flax's
``_ndarray_to_bytes`` packs it.  ``packb`` writes the bytes the
``msgpack`` package writes for such a tree (``use_bin_type=True``, the
shortest form of every length and int); ``unpackb`` reads them back, and
also reads nil, bools, floats and arrays of them.  Arrays of more than
flax's chunk size (2**30 bytes), which flax would split, are refused.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

from kaldi_tpu_torch.core.logging import KaldiError

EXT_NDARRAY = 1
# flax.serialization.MAX_CHUNK_SIZE: a larger leaf would be chunked
MAX_LEAF_BYTES = 2 ** 30


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, low in ((0xd0, ">b", -(1 << 7)),
                               (0xd1, ">h", -(1 << 15)),
                               (0xd2, ">i", -(1 << 31)),
                               (0xd3, ">q", -(1 << 63))):
            if v >= low:
                return bytes([code]) + struct.pack(fmt, v)
    raise KaldiError(f"msgpack: int {v} out of range")


def _sized(n: int, fix: Optional[Tuple[int, int]], codes) -> bytes:
    """The header of a str/bin/map/array/ext body of length ``n``:
    ``fix`` = (marker base, exclusive limit) of the fixed form or None,
    ``codes`` the (marker, struct format, limit) of the sized forms."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, top in codes:
        if n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise KaldiError(f"msgpack: length {n} out of range")


_STR = ((0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16), (0xdb, ">I", 1 << 32))
_BIN = ((0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16), (0xc6, ">I", 1 << 32))
_MAP = ((0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32))
_ARR = ((0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32))
_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
_EXT = ((0xc7, ">B", 1 << 8), (0xc8, ">H", 1 << 16), (0xc9, ">I", 1 << 32))


def _pack(x: Any, out: list) -> None:
    if isinstance(x, bool) or x is None:
        out.append(b"\xc0" if x is None else (b"\xc3" if x else b"\xc2"))
    elif isinstance(x, int):
        out.append(_int(x))
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        out.append(_sized(len(raw), (0xa0, 32), _STR) + raw)
    elif isinstance(x, (bytes, bytearray)):
        out.append(_sized(len(x), None, _BIN) + bytes(x))
    elif isinstance(x, (list, tuple)):
        out.append(_sized(len(x), (0x90, 16), _ARR))
        for v in x:
            _pack(v, out)
    elif isinstance(x, dict):
        out.append(_sized(len(x), (0x80, 16), _MAP))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        data = pack_ndarray(x)
        n = len(data)
        head = (bytes([_FIXEXT[n]]) if n in _FIXEXT
                else _sized(n, None, _EXT))
        out.append(head + bytes([EXT_NDARRAY]) + data)
    else:
        raise KaldiError(f"msgpack: cannot pack {type(x).__name__}")


def pack_ndarray(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name, bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise KaldiError("msgpack: object and structured arrays are not "
                         "supported")
    if arr.nbytes > MAX_LEAF_BYTES:
        raise KaldiError(f"msgpack: a leaf of {arr.nbytes} bytes would be "
                         f"chunked")
    return packb((tuple(int(d) for d in arr.shape), arr.dtype.name,
                  arr.tobytes("C")))


def packb(x: Any) -> bytes:
    """msgpack bytes of ``x`` (dicts, lists/tuples, str, bytes, ints,
    bools, None, numpy arrays as ext type 1)."""
    out: list = []
    _pack(x, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise KaldiError("msgpack: truncated data")
        b = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return b

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, raw: bool) -> Any:
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f, raw)
        if 0x90 <= c <= 0x9f:
            return [self.value(raw) for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return self.string(c & 0x1f, raw)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if c in simple:
            return simple[c]
        sized = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
        if c in sized:
            return self.take(self.num(sized[c]))
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
                0xca: ">f", 0xcb: ">d"}
        if c in ints:
            return self.num(ints[c])
        strs = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
        if c in strs:
            return self.string(self.num(strs[c]), raw)
        if c in (0xdc, 0xdd):
            n = self.num(">H" if c == 0xdc else ">I")
            return [self.value(raw) for _ in range(n)]
        if c in (0xde, 0xdf):
            return self.map(self.num(">H" if c == 0xde else ">I"), raw)
        fixext = {v: k for k, v in _FIXEXT.items()}
        if c in fixext:
            return self.ext(fixext[c])
        exts = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
        if c in exts:
            return self.ext(self.num(exts[c]))
        raise KaldiError(f"msgpack: unsupported type byte 0x{c:02x}")

    def string(self, n: int, raw: bool):
        b = self.take(n)
        return b if raw else b.decode("utf-8")

    def map(self, n: int, raw: bool) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value(raw)
            out[k] = self.value(raw)
        return out

    def ext(self, n: int):
        code = self.take(1)[0]
        data = self.take(n)
        if code != EXT_NDARRAY:
            raise KaldiError(f"msgpack: unsupported ext type {code}")
        return unpack_ndarray(data)


def unpack_ndarray(data: bytes) -> np.ndarray:
    """flax's ``_ndarray_from_bytes`` (a writable copy)."""
    shape, name, buf = unpackb(data, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        raise KaldiError("msgpack: bfloat16 leaves are not supported")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(
        tuple(shape)).copy()


def unpackb(data: bytes, raw: bool = False) -> Any:
    """The value msgpack ``data`` holds; arrays (ext type 1) come back as
    numpy arrays, strings as str (bytes with ``raw``)."""
    r = _Reader(data)
    v = r.value(raw)
    if r.pos != len(r.data):
        raise KaldiError(f"msgpack: {len(r.data) - r.pos} trailing bytes")
    return v
