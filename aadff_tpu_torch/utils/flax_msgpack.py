"""Reader for Flax msgpack checkpoints, with nothing but the stdlib and numpy.

`flax.serialization.msgpack_restore` decodes a msgpack document whose arrays
are msgpack extension type 1: the payload is itself a msgpack array
`(shape, dtype name, raw C-order bytes)`.  Extension type 3 is a numpy scalar
packed the same way.  This module decodes that subset of msgpack (nil, bool,
ints, floats, str, bin, arrays, maps and those two extension types) into
nested dicts, lists and numpy arrays.
"""
from __future__ import annotations

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
