"""Read the JAX package's ``.msgpack`` checkpoints without ``msgpack`` or
``flax``.

flax's ``msgpack_serialize`` writes a parameter tree as a msgpack map of
maps whose leaves are ext types:
  * 1, an ndarray: the payload is itself msgpack of (shape, dtype name,
    C-order bytes);
  * 3, a numpy scalar: the same payload, of a 0-d array.
Arrays over 2**30 bytes are written as ``__msgpack_chunked_array__`` maps;
no checkpoint of this model comes near that, so they are refused.

``restore`` returns the tree as nested dicts of numpy arrays (a bfloat16
leaf, which numpy cannot hold, becomes a ``torch.bfloat16`` tensor through
a uint16 view), the input ``models/bridge.params_from_jax`` takes.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    """A msgpack decoder for what flax writes: maps, arrays, str, bin,
    ints, floats, nil, bool and ext."""

    def __init__(self, data: bytes, path: str):
        self.data = memoryview(data)
        self.pos = 0
        self.path = path

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.path}: truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        if 0xD4 <= b <= 0xD8:                              # fixext 1..16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"{self.path}: unknown msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if "__msgpack_chunked_array__" in out:
            raise ValueError(
                f"{self.path}: holds an array over flax's 2**30-byte chunk "
                "size (written chunked); reading those is not supported")
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"{self.path}: unknown msgpack ext type {code}")
        inner = _Reader(payload, self.path)
        shape, dtype, buf = inner.value()
        if dtype == "bfloat16":
            arr = np.frombuffer(buf, np.uint16).reshape(shape)
            return torch.from_numpy(arr.copy()).view(torch.bfloat16)
        arr = np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy()
        return arr[()] if code == _EXT_NPSCALAR else arr


def restore_bytes(data: bytes, path: str = "<bytes>") -> Any:
    """flax.serialization.msgpack_restore, for what flax writes."""
    reader = _Reader(data, path)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{path}: trailing bytes after the msgpack value")
    return out


def restore(path: str) -> Any:
    """Read one ``.msgpack`` checkpoint file into nested dicts."""
    with open(path, "rb") as f:
        return restore_bytes(f.read(), path)
