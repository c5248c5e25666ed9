"""ctypes binding for the native C++ decode/prefetch runtime
(``native/loader.cpp``, the port's copy of the JAX package's), and its
plain numpy version.

The library is built with g++ on first use into ``build/native/`` at the
repository root (git-ignored), named by a hash of the source and flags:
it compiles to a temporary file that is then renamed into place, so
processes building at once never load a half-written library. It links
the system libjpeg and libpng; where g++ or their headers are missing,
``available()`` is False and ``unavailable_reason()`` says why, and the
callers (``data/dataset.py``) decode with OpenCV, as the JAX package does
on such a host.

API (the JAX package's ``data/native_loader.py``):
  decode_image(path, size, mode) -> np.ndarray       one-shot decode
  NativeBatcher(paths, size, mode, threads)          worker-pool prefetcher
      .submit(indices) / .wait() -> (N, ...) array
  decode_image_plain(img, size, mode)                loader.cpp's resize and
                                                     scaling in numpy, on an
                                                     already-decoded uint8 image
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "native" / "loader.cpp"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "native"
_GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
_LIBS = ("-ljpeg", "-lpng", "-lpthread")

MODE_RGB = 0     # float32 (S,S,3) in [-1,1]
MODE_GRAY = 1    # float32 (S,S) in [0,1]
MODE_LABEL = 2   # uint8 (S,S,3), nearest resize (IUV)

_build_lock = threading.Lock()


def library_path() -> Path:
    src = _SRC.read_bytes()
    digest = hashlib.sha256(src + " ".join(_GXX_FLAGS + _LIBS).encode())
    return _BUILD / f"libnhvr_loader_{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def _load() -> Tuple[Optional[ctypes.CDLL], str]:
    """(the library, '') or (None, why it is unavailable)."""
    out = library_path()
    with _build_lock:
        if not out.is_file():
            gxx = shutil.which("g++")
            if gxx is None:
                return None, "no g++ to build native/loader.cpp"
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([gxx, *_GXX_FLAGS, str(_SRC), "-o", str(tmp),
                                   *_LIBS], capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                tail = " | ".join(proc.stderr.strip().splitlines()[-3:])
                return None, ("native/loader.cpp did not build (libjpeg's "
                              f"jpeglib.h or libpng's png.h missing?): {tail}")
            os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:                  # libjpeg / libpng missing at run time
        return None, f"native/loader.cpp built but does not load: {e}"
    lib.nhvr_decode_image.restype = ctypes.c_int
    lib.nhvr_decode_image.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int]
    lib.nhvr_batch_create.restype = ctypes.c_void_p
    lib.nhvr_batch_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int]
    lib.nhvr_batch_submit.restype = ctypes.c_int
    lib.nhvr_batch_submit.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.c_int, ctypes.c_void_p]
    lib.nhvr_batch_wait.restype = ctypes.c_int
    lib.nhvr_batch_wait.argtypes = [ctypes.c_void_p]
    lib.nhvr_batch_destroy.restype = None
    lib.nhvr_batch_destroy.argtypes = [ctypes.c_void_p]
    return lib, ""


def available() -> bool:
    return _load()[0] is not None


def unavailable_reason() -> str:
    """Why the library is unavailable on this host ('' where it loads)."""
    return _load()[1]


def _get_lib() -> ctypes.CDLL:
    lib, why = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {why}")
    return lib


def _item_shape(size: int, mode: int):
    if mode == MODE_GRAY:
        return (size, size)
    return (size, size, 3)


def _item_dtype(mode: int):
    return np.uint8 if mode == MODE_LABEL else np.float32


def decode_image(path: str, size: int, mode: int = MODE_RGB) -> np.ndarray:
    lib = _get_lib()
    out = np.empty(_item_shape(size, mode), _item_dtype(mode))
    rc = lib.nhvr_decode_image(path.encode(), out.ctypes.data_as(ctypes.c_void_p),
                               size, mode)
    if rc != 0:
        raise IOError(f"native decode failed ({rc}): {path}")
    return out


class NativeBatcher:
    """Worker-pool decoder: submit a batch of file indices, wait for the
    assembled array. Decoding overlaps the caller's device step."""

    def __init__(self, paths: Sequence[str], size: int, mode: int = MODE_RGB,
                 threads: int = 4):
        lib = _get_lib()
        self._lib = lib
        self.size, self.mode = size, mode
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = lib.nhvr_batch_create(arr, len(paths), size, mode, threads)
        self._out: Optional[np.ndarray] = None

    def submit(self, indices: Sequence[int]) -> None:
        n = len(indices)
        out = np.empty((n,) + _item_shape(self.size, self.mode),
                       _item_dtype(self.mode))
        idx = (ctypes.c_int * n)(*[int(i) for i in indices])
        rc = self._lib.nhvr_batch_submit(
            self._handle, idx, n, out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"batch submit failed ({rc})")
        self._out = out            # the workers write into it until wait()

    def wait(self) -> np.ndarray:
        rc = self._lib.nhvr_batch_wait(self._handle)
        if rc != 0:
            raise IOError(f"{-rc} decode errors in batch")
        out, self._out = self._out, None
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.nhvr_batch_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ----------------------------------------------------------------------
# the plain version: loader.cpp's decode_to after the file is decoded
# ----------------------------------------------------------------------

_F = np.float32


def _resize_bilinear(plane: np.ndarray, size: int) -> np.ndarray:
    """resize_bilinear of one uint8 (H, W) plane: half-pixel centres,
    clamped taps, float32 in loader.cpp's order of operations."""
    h, w = plane.shape
    sx, sy = _F(w) / _F(size), _F(h) / _F(size)
    o = np.arange(size, dtype=_F) + _F(0.5)
    fy, fx = o * sy - _F(0.5), o * sx - _F(0.5)
    y0, x0 = np.floor(fy).astype(np.int64), np.floor(fx).astype(np.int64)
    wy, wx = (fy - y0.astype(_F))[:, None], (fx - x0.astype(_F))[None, :]
    y0c, y1c = np.clip(y0, 0, h - 1)[:, None], np.clip(y0 + 1, 0, h - 1)[:, None]
    x0c, x1c = np.clip(x0, 0, w - 1)[None, :], np.clip(x0 + 1, 0, w - 1)[None, :]
    p = plane.astype(_F)
    v00, v01 = p[y0c, x0c], p[y0c, x1c]
    v10, v11 = p[y1c, x0c], p[y1c, x1c]
    one = _F(1)
    return ((v00 * (one - wx) + v01 * wx) * (one - wy)
            + (v10 * (one - wx) + v11 * wx) * wy)


def decode_image_plain(img: np.ndarray, size: int,
                       mode: int = MODE_RGB) -> np.ndarray:
    """What ``decode_image`` returns for a file that decodes to the uint8
    image ``img`` ((H, W), (H, W, 1) or (H, W, 3), as libpng / libjpeg give
    it after loader.cpp's expand and strip rules): the same resize and
    scaling in float32, in the same order of operations."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"decode_image_plain takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 3):
        raise ValueError(f"decode_image_plain takes 1 or 3 channels, got "
                         f"shape {img.shape}")
    c = img.shape[-1]
    if mode == MODE_RGB:
        planes = [_resize_bilinear(img[..., ch if c == 3 else 0], size)
                  for ch in range(3)]
        return np.stack([p * (_F(2) / _F(255)) - _F(1) for p in planes], -1)
    if mode == MODE_GRAY:
        if c == 3:
            lw = (_F(0.299), _F(0.587), _F(0.114))
            plane = np.zeros((size, size), _F)
            for ch in range(3):
                plane = plane + lw[ch] * _resize_bilinear(img[..., ch], size)
        else:
            plane = _resize_bilinear(img[..., 0], size)
        return plane / _F(255)
    if mode == MODE_LABEL:
        h, w = img.shape[:2]
        sx, sy = _F(w) / _F(size), _F(h) / _F(size)
        o = np.arange(size, dtype=_F) + _F(0.5)
        y = np.minimum((o * sy).astype(np.int64), h - 1)
        x = np.minimum((o * sx).astype(np.int64), w - 1)
        out = img[y[:, None], x[None, :]]
        return np.ascontiguousarray(out if c == 3 else np.repeat(out, 3, -1))
    raise ValueError(f"unknown mode {mode}")
