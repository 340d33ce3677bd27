"""The port's own MessagePack codec: the subset that flax's serialization
writes and reads, in pure Python, so that actor files and train states need
neither ``msgpack`` nor ``flax``.

``packb(obj)`` writes what ``flax.serialization.to_bytes`` writes for a
tree of dicts (string keys, insertion order), lists, ``None``, ``bool``,
``int`` (every width msgpack has), ``float`` (always float64), ``str``,
``bytes`` and numpy arrays: an array is ext type 1 whose payload is the
msgpack of ``(shape, dtype name, C-order bytes)`` (flax's
``_ndarray_to_bytes``).  A tuple packs as an array, as msgpack's non-strict
mode does (the payload's shape).  ``unpackb(data)`` reads every msgpack
format back, ext 1 to a read-only numpy array; flax's other ext types
(numpy scalars, complex numbers) raise.  flax splits arrays past
``MAX_CHUNK_SIZE`` bytes into chunks; no array of this package comes near
that, so such an array raises here.
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
MAX_CHUNK_SIZE = 2 ** 30        # flax.serialization.MAX_CHUNK_SIZE


def _int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return struct.pack("B", x)
    if -0x20 <= x < 0:
        return struct.pack("b", x)
    if 0x80 <= x <= 0xFF:
        return struct.pack("BB", 0xCC, x)
    if -0x80 <= x < 0:
        return struct.pack(">Bb", 0xD0, x)
    if 0xFF < x <= 0xFFFF:
        return struct.pack(">BH", 0xCD, x)
    if -0x8000 <= x < -0x80:
        return struct.pack(">Bh", 0xD1, x)
    if 0xFFFF < x <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, x)
    if -0x80000000 <= x < -0x8000:
        return struct.pack(">Bi", 0xD2, x)
    if 0xFFFFFFFF < x <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, x)
    if -0x8000000000000000 <= x < -0x80000000:
        return struct.pack(">Bq", 0xD3, x)
    raise OverflowError(f"integer {x} does not fit msgpack's 64 bits")


def _header(n: int, fix: int, fix_max: int, codes) -> bytes:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` ((code, struct format, limit), ...) whose limit holds."""
    if fix is not None and n < fix_max:
        return struct.pack("B", fix | n)
    for code, fmt, limit in codes:
        if n <= limit:
            return struct.pack(">B" + fmt, code, n)
    raise ValueError(f"length {n} does not fit msgpack's 32 bits")


_STR = ((0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF), (0xDB, "I", 0xFFFFFFFF))
_BIN = ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF), (0xC6, "I", 0xFFFFFFFF))
_ARRAY = ((0xDC, "H", 0xFFFF), (0xDD, "I", 0xFFFFFFFF))
_MAP = ((0xDE, "H", 0xFFFF), (0xDF, "I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _ext(code: int, data: bytes) -> list:
    n = len(data)
    if n in _FIXEXT:
        head = struct.pack("B", _FIXEXT[n])
    else:
        head = _header(n, None, 0, ((0xC7, "B", 0xFF), (0xC8, "H", 0xFFFF),
                                    (0xC9, "I", 0xFFFFFFFF)))
    return [head, struct.pack("b", code), data]


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: the msgpack of ``(shape, dtype name,
    C-order bytes)``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    return packb((tuple(int(d) for d in arr.shape), arr.dtype.name,
                  arr.tobytes("C")))


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        out += [_header(len(raw), 0xA0, 32, _STR), raw]
    elif type(obj) in (bytes, bytearray):
        out += [_header(len(obj), None, 0, _BIN), bytes(obj)]
    elif type(obj) in (list, tuple):
        out.append(_header(len(obj), 0x90, 16, _ARRAY))
        for x in obj:
            _pack(x, out)
    elif type(obj) is dict:
        out.append(_header(len(obj), 0x80, 16, _MAP))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        if obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE:
            raise ValueError(
                f"array of {obj.size * obj.dtype.itemsize} bytes is past "
                f"flax's chunk size ({MAX_CHUNK_SIZE}); chunked arrays are "
                "not supported")
        out += _ext(EXT_NDARRAY, _ndarray_bytes(obj))
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}: {obj!r}")


def packb(obj: Any) -> bytes:
    """``obj`` in msgpack, as ``flax.serialization.to_bytes`` writes a tree
    (``msgpack.packb(..., use_bin_type=True)`` for a plain one)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        b = self.buf[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        c = self.unpack("B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        if c in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack("BHI"[c - 0xC4]))
        if c in (0xC7, 0xC8, 0xC9):
            return self._ext(self.unpack("BHI"[c - 0xC7]))
        if c == 0xCA:
            return self.unpack("f")
        if c == 0xCB:
            return self.unpack("d")
        if 0xCC <= c <= 0xCF:
            return self.unpack("BHIQ"[c - 0xCC])
        if 0xD0 <= c <= 0xD3:
            return self.unpack("bhiq"[c - 0xD0])
        if 0xD4 <= c <= 0xD8:
            return self._ext(1 << (c - 0xD4))
        if 0xD9 <= c <= 0xDB:
            return self.take(self.unpack("BHI"[c - 0xD9])).decode("utf-8")
        if c in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack("HI"[c - 0xDC]))]
        if c in (0xDE, 0xDF):
            return self._map(self.unpack("HI"[c - 0xDE]))
        raise ValueError(f"unknown msgpack format byte 0x{c:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack ext type {code} is not supported "
                             "(only ndarrays, type 1)")
        shape, name, raw = unpackb(data)
        return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def unpackb(data: bytes) -> Any:
    """The object ``data`` holds (``flax.serialization.msgpack_restore``'s
    reading); trailing bytes raise.  A chunked flax array raises."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         "object")
    _refuse_chunks(obj)
    return obj


def _refuse_chunks(obj) -> None:
    if isinstance(obj, dict):
        if "__msgpack_chunked_array__" in obj:
            raise ValueError("flax chunked arrays (past MAX_CHUNK_SIZE) are "
                             "not supported")
        for v in obj.values():
            _refuse_chunks(v)
