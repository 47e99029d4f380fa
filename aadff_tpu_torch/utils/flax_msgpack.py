"""Reader and writer of Flax msgpack checkpoints, with nothing but the
stdlib and numpy.

`flax.serialization.msgpack_restore` decodes a msgpack document whose arrays
are msgpack extension type 1: the payload is itself a msgpack array
`(shape, dtype name, raw C-order bytes)`.  Extension type 3 is a numpy scalar
packed the same way.  This module decodes that subset of msgpack (nil, bool,
ints, floats, str, bin, arrays, maps and those two extension types) into
nested dicts, lists and numpy arrays, and encodes such trees as
`flax.serialization.msgpack_serialize` does (`dumps`, `save`), byte for
byte, so that the JAX package's `PSFNet.load_net` reads what it writes.
"""
from __future__ import annotations

import os
import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _BIN:
            return bytes(self.take(self.unpack(_BIN[b])))
        if b in _STR:
            return str(self.take(self.unpack(_STR[b])), "utf-8")
        if b in _NUM:
            return self.unpack(_NUM[b])
        if b in _ARRAY:
            return self.array(self.unpack(_ARRAY[b]))
        if b in _MAP:
            return self.map(self.unpack(_MAP[b]))
        if b in _FIXEXT:
            return self.ext(self.unpack(">b"), _FIXEXT[b])
        if b in _EXT:
            n = self.unpack(_EXT[b])
            return self.ext(self.unpack(">b"), n)
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype_name, raw = loads(bytes(payload))
        arr = np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_NUM = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
        0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def loads(data: bytes):
    """Decode one msgpack document (the counterpart of `msgpack_restore`)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after msgpack document")
    return out


def load(path: str):
    """Read a Flax msgpack checkpoint file into nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return loads(f.read())


def _pack_len(n: int, codes) -> bytes:
    """A length or count `n` under the first (type byte, struct format) of
    `codes` whose format holds it."""
    for code, fmt in codes:
        if n < (1 << (8 * struct.calcsize(fmt))):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} out of range")


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
            if n < (1 << (8 * struct.calcsize(fmt))):
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")):
            if n >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} out of msgpack's range")


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _pack_len(n, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
    return head + struct.pack(">b", code) + payload


def _pack(obj) -> bytes:
    if obj is None:
        return b"\xc0"
    if obj is True:
        return b"\xc3"
    if obj is False:
        return b"\xc2"
    if isinstance(obj, np.ndarray):
        return _pack_ext(_EXT_NDARRAY, _pack_array_payload(obj))
    if isinstance(obj, np.generic):
        return _pack_ext(_EXT_NPSCALAR, _pack_array_payload(np.asarray(obj)))
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        if len(raw) < 32:
            return bytes([0xA0 | len(raw)]) + raw
        return _pack_len(len(raw), ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I"))) + raw
    if isinstance(obj, (bytes, bytearray)):
        return _pack_len(len(obj), ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I"))) + bytes(obj)
    if isinstance(obj, (list, tuple)):
        n = len(obj)
        head = (bytes([0x90 | n]) if n < 16
                else _pack_len(n, ((0xDC, ">H"), (0xDD, ">I"))))
        return head + b"".join(_pack(x) for x in obj)
    if isinstance(obj, dict):
        n = len(obj)
        head = (bytes([0x80 | n]) if n < 16
                else _pack_len(n, ((0xDE, ">H"), (0xDF, ">I"))))
        return head + b"".join(_pack(k) + _pack(obj[k]) for k in sorted(obj))
    raise TypeError(f"cannot msgpack {type(obj).__name__}")


def _pack_array_payload(arr: np.ndarray) -> bytes:
    """(shape, dtype name, raw C-order bytes), as flax's `_ndarray_to_bytes`."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialised")
    return _pack((tuple(int(n) for n in arr.shape), arr.dtype.name,
                  arr.tobytes("C")))


def dumps(tree) -> bytes:
    """Encode nested dicts/lists of numpy arrays and Python scalars as
    `flax.serialization.msgpack_serialize` does (map keys sorted, as its
    tree_map leaves them)."""
    return _pack(tree)


def save(path: str, tree):
    """Write `tree` to `path` atomically (a temporary file, then a rename),
    so a kill mid-write leaves the previous file intact."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(dumps(tree))
    os.replace(tmp, path)
