"""Image conversion, a dependency-free PNG writer and reader, and image
decoding for the data loader.

Frames are written as 8-bit RGB PNGs through the standard library's zlib,
so rendering needs no image library. Files are read (``read_image``):
  * through OpenCV where ``cv2`` imports, as the JAX package reads them;
  * else a PNG through this module's reader (8-bit gray, gray + alpha, RGB
    and RGBA, all five scanline filters, not interlaced);
  * else a JPEG through ``torchvision.io`` or, where it does not import,
    the system libjpeg (``native/jpeg_decode.cpp``, built with g++ into
    ``build/native/`` at first use);
  * otherwise the file is refused, with a message that names the fix.
``decoder_name`` says which of these runs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_JPEG_SIG = b"\xff\xd8"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # colour type -> channels
_REPO = Path(__file__).resolve().parents[2]
_JPEG_SRC = _REPO / "neural_human_video_rendering_tpu_torch" / "native" \
    / "jpeg_decode.cpp"


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


def _unfilter_row(ftype: int, line: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    """One scanline's bytes with its PNG filter undone (prev: the row
    above, already undone)."""
    if ftype == 0:
        return line
    if ftype == 1:                                  # Sub: running sum
        return (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.int64)
                % 256).astype(np.uint8).reshape(-1)
    if ftype == 2:                                  # Up
        return line + prev
    cur, up = bytearray(line.tobytes()), prev.tobytes()
    if ftype == 3:                                  # Average
        for i in range(len(cur)):
            left = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 255
    elif ftype == 4:                                # Paeth
        for i in range(len(cur)):
            a = cur[i - bpp] if i >= bpp else 0
            b, c = up[i], (up[i - bpp] if i >= bpp else 0)
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 255
    else:
        raise ValueError(f"unknown PNG filter type {ftype}")
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png(data: bytes, path: str = "<png>") -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 as stored: C is 1 (gray), 2 (gray +
    alpha), 3 (RGB) or 4 (RGBA). 8-bit, non-interlaced images only."""
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = hdr
    C = _PNG_CHANNELS.get(ctype)
    if depth != 8 or C is None or interlace:
        raise ValueError(
            f"{path}: only 8-bit, non-interlaced gray, gray + alpha, RGB and "
            f"RGBA PNGs are read (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}); convert it or install OpenCV")
    stride = W * C
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(H, 1 + stride)
    if not rows[:, 0].any():
        return rows[:, 1:].reshape(H, W, C).copy()
    out = np.empty((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, C)
    return out.reshape(H, W, C)


def read_png(path: str) -> np.ndarray:
    """Read a PNG -> (H, W, C) uint8 as stored (see decode_png)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def save_image(path: str, img) -> None:
    """Write an RGB float image in [-1, 1] as a PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(img)))


# ----------------------------------------------------------------------
# decoding for the data loader
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


@functools.lru_cache(maxsize=None)
def _torchvision_io():
    try:
        from torchvision import io
    except ImportError:
        return None
    return io


@functools.lru_cache(maxsize=None)
def _jpeg_lib() -> Tuple[Optional[ctypes.CDLL], str]:
    """(the libjpeg decoder, '') or (None, why it is missing): built with
    g++ into build/native/ on first use."""
    src = _JPEG_SRC.read_bytes()
    out = _REPO / "build" / "native" / \
        f"jpeg_decode_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if not out.is_file():
        gxx = shutil.which("g++")
        if gxx is None:
            return None, "no g++ to build native/jpeg_decode.cpp"
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-o", str(tmp),
                               str(_JPEG_SRC), "-ljpeg"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            return None, ("native/jpeg_decode.cpp did not build (libjpeg's "
                          f"jpeglib.h missing?): {proc.stderr.strip()[-300:]}")
        os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:                  # libjpeg missing at run time
        return None, f"native/jpeg_decode.cpp built but does not load: {e}"
    lib.nhvr_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.nhvr_jpeg_decode.restype = ctypes.c_int
    return lib, ""


def _jpeg_native(path: str, gray: bool) -> np.ndarray:
    lib, why = _jpeg_lib()
    if lib is None:
        raise RuntimeError(
            f"{path}: no JPEG decoder on this host (OpenCV and torchvision do "
            f"not import; {why}); convert the file to PNG")
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    if lib.nhvr_jpeg_decode(path.encode(), None, ctypes.byref(w),
                            ctypes.byref(h), int(gray)) != 0:
        raise ValueError(f"{path}: not a readable JPEG")
    out = np.empty((h.value, w.value, 1 if gray else 3), np.uint8)
    if lib.nhvr_jpeg_decode(path.encode(), out.ctypes.data, ctypes.byref(w),
                            ctypes.byref(h), int(gray)) != 0:
        raise ValueError(f"{path}: JPEG decode failed")
    return out


def decoder_name() -> str:
    """Which decoder read_image uses on this host."""
    if _cv2() is not None:
        return "cv2"
    if _torchvision_io() is not None:
        return "png reader; jpeg torchvision.io"
    lib, why = _jpeg_lib()
    return ("png reader; jpeg libjpeg (native/jpeg_decode.cpp)" if lib
            else f"png reader; no jpeg decoder ({why})")


def _gray(rgb: np.ndarray) -> np.ndarray:
    """RGB uint8 -> gray with OpenCV's fixed-point BT.601 weights."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    return ((r * 4899 + g * 9617 + b * 1868 + 8192) >> 14).astype(np.uint8)


def read_image(path: str, mode: str = "rgb") -> np.ndarray:
    """Decode an image file -> uint8: mode 'rgb' (H, W, 3), 'gray' (H, W),
    or 'unchanged' (as stored, colour channels in RGB(A) order). Raises
    FileNotFoundError for a missing or unreadable file and RuntimeError
    where no decoder reads it."""
    cv2 = _cv2()
    if cv2 is not None:
        flag = {"rgb": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
                "unchanged": cv2.IMREAD_UNCHANGED}[mode]
        img = cv2.imread(path, flag)
        if img is None:
            raise FileNotFoundError(path)
        if img.ndim == 3 and img.shape[-1] in (3, 4):      # BGR(A) -> RGB(A)
            return img[..., [2, 1, 0, 3][:img.shape[-1]]].copy()
        return img
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIG:
        img = decode_png(data, path)
    elif data[:2] == _JPEG_SIG:
        tvio = _torchvision_io()
        if tvio is not None:
            import torch
            t = tvio.decode_jpeg(torch.frombuffer(bytearray(data), dtype=torch.uint8),
                                 mode=tvio.ImageReadMode.GRAY if mode == "gray"
                                 else tvio.ImageReadMode.RGB)
            img = t.permute(1, 2, 0).numpy()
        else:
            img = _jpeg_native(path, mode == "gray")
        if mode == "gray":
            return img[..., 0]
        return img
    else:
        raise RuntimeError(
            f"{path}: neither PNG nor JPEG, and OpenCV does not import; "
            "convert it to PNG")
    if mode == "unchanged":
        return img[..., 0] if img.shape[-1] == 1 else img
    C = img.shape[-1]
    if mode == "gray":
        return img[..., 0] if C <= 2 else _gray(img[..., :3])
    return np.repeat(img[..., :1], 3, -1) if C <= 2 else img[..., :3].copy()


_CV2_INTERP = {"area": "INTER_AREA", "nearest": "INTER_NEAREST",
               "linear": "INTER_LINEAR"}


def resize(arr: np.ndarray, size: Tuple[int, int], interp: str) -> np.ndarray:
    """Resize (H, W[, C]) to size = (width, height) with interp 'area',
    'nearest' or 'linear': cv2.resize where OpenCV imports; else torch's
    interpolate (area / nearest / bilinear, half-pixel centres), whose
    rounding differs from OpenCV's."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(arr, size, interpolation=getattr(cv2, _CV2_INTERP[interp]))
    import torch
    import torch.nn.functional as F
    w, h = size
    x = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    x = (x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None])
    if interp == "nearest":
        y = F.interpolate(x, size=(h, w), mode="nearest")
    elif interp == "area" and h <= x.shape[2] and w <= x.shape[3]:
        y = F.interpolate(x, size=(h, w), mode="area")
    else:
        y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    y = y[0, 0] if arr.ndim == 2 else y[0].permute(1, 2, 0)
    out = y.numpy()
    if arr.dtype == np.uint8:
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out.astype(arr.dtype)
