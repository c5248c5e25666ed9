"""Image conversion and a dependency-free PNG writer and reader.

Frames are written as 8-bit RGB PNGs through the standard library's zlib,
so rendering needs no image library.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def to_uint8(img, assume_01: bool = False) -> np.ndarray:
    """(H,W,C) float image -> uint8 RGB. Default range [-1,1]; masks and
    other [0,1] data pass assume_01=True. Single channel is tiled to RGB."""
    arr = np.asarray(img, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    if assume_01:
        arr = arr * 2.0 - 1.0
    arr = (np.clip(arr, -1, 1) + 1.0) * 127.5
    return arr.round().astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(rgb: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, no filtering)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    H, W, C = rgb.shape
    if C != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {rgb.shape}")
    rows = np.empty((H, 1 + W * 3), np.uint8)
    rows[:, 0] = 0                          # filter type None per row
    rows[:, 1:] = rgb.reshape(H, W * 3)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read back an 8-bit RGB PNG written by encode_png -> (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, W, H = 8, [], 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            W, H, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise ValueError(f"{path}: only 8-bit RGB PNGs are read")
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(H, 1 + W * 3)
    if np.any(rows[:, 0]):
        raise ValueError(f"{path}: filtered scanlines are not read")
    return rows[:, 1:].reshape(H, W, 3).copy()


def save_image(path: str, img) -> None:
    """Write an RGB float image in [-1, 1] as a PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(img)))
