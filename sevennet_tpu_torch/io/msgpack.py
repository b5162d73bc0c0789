"""A small msgpack decoder for the files ``flax.serialization.to_bytes``
writes (the JAX package's ``params.msgpack`` and ``opt_state.msgpack``),
so that the port reads them without flax or the ``msgpack`` package.

Covers the msgpack types such a file holds (https://github.com/msgpack/
msgpack/blob/master/spec.md): nil, bool, int, float, str, bin, array and
map; flax's extension types 1 (an ndarray: a packed ``(shape, dtype name,
C-order bytes)`` triple) and 3 (a numpy scalar, packed as a 0-d ndarray);
and the ``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``
dicts flax writes for arrays over 2**30 bytes, joined back into arrays.
Arrays come back as numpy arrays (copies, writable); maps as dicts.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

__all__ = ["unpackb", "msgpack_restore"]

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width types: first byte -> (struct format, payload bytes)
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# length-prefixed types: first byte -> (kind, length format, length bytes)
_SIZED = {
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xC7: ("ext", ">B", 1), 0xC8: ("ext", ">H", 2), 0xC9: ("ext", ">I", 4),
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def sized(self, kind: str, n: int) -> Any:
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return bytes(self.take(n)).decode("utf-8")
        if kind == "array":
            return [self.obj() for _ in range(n)]
        if kind == "map":
            out = {}
            for _ in range(n):
                k = self.obj()
                out[k] = self.obj()
            return out
        code = self.unpack(">b", 1)  # ext: signed type code, then the payload
        return _ext(code, bytes(self.take(n)))

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.sized("map", b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.sized("array", b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.sized("str", b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if b in _SIZED:
            kind, fmt, n = _SIZED[b]
            return self.sized(kind, self.unpack(fmt, n))
        if b in _FIXEXT:
            return self.sized("ext", _FIXEXT[b])
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at offset {self.pos - 1}")


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray encoding: a msgpack ``(shape, dtype name, bytes)``."""
    shape, name, buf = unpackb(data)
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays need ml_dtypes, which the port does not use")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack: unknown extension type {code}")


def unpackb(data: bytes) -> Any:
    """Decodes one msgpack object from ``data`` (all of it)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes after the object")
    return out


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """The state dict ``flax.serialization.msgpack_restore`` returns: maps
    as dicts (lists and tuples as dicts of ``"0"``, ``"1"``, ... keys),
    arrays as numpy arrays, chunked arrays joined."""
    return _unchunk(unpackb(data))
