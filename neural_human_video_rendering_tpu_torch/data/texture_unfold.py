"""Static texture-atlas construction: a copy of the JAX package's
``data/texture_unfold.py`` (the reference's ``unfold_texture.py``).

For every body part, frame pixels labeled with that part by DensePose are
splatted into the part's UV tile and averaged; holes are filled by a
normalized blur. The (rows x cols)-grid atlas image it writes is what
``dataset.load_texture_atlas`` reads back at train and inference time.
Offline host tool: OpenCV and numpy, the same calls as the JAX package's,
so the two write the same bytes.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .dataset import list_images
from .densepose import decode_iuv


def accumulate_frame(acc: np.ndarray, cnt: np.ndarray, frame: np.ndarray,
                     parts: np.ndarray, uv: np.ndarray, tile: int) -> None:
    """Splat one frame's pixels into the per-part accumulation bins.

    acc: (24, tile, tile, 3) float64 sum;  cnt: (24, tile, tile) counts.
    frame in [0,1] RGB; parts (H,W) int; uv (H,W,2) in [0,1].
    """
    fg = parts > 0
    p = parts[fg] - 1
    u = np.clip((uv[fg, 0] * (tile - 1)).round().astype(np.int64), 0, tile - 1)
    v = np.clip((uv[fg, 1] * (tile - 1)).round().astype(np.int64), 0, tile - 1)
    rgb = frame[fg]
    np.add.at(acc, (p, v, u), rgb)
    np.add.at(cnt, (p, v, u), 1.0)


def finalize_atlas(acc: np.ndarray, cnt: np.ndarray, blur: int = 7) -> np.ndarray:
    """Average bins and diffuse into holes -> (24, tile, tile, 3) in [0,1]."""
    import cv2
    tiles = []
    for p in range(acc.shape[0]):
        c = cnt[p][..., None]
        t = np.where(c > 0, acc[p] / np.maximum(c, 1), 0.0).astype(np.float32)
        # hole fill: normalized blur of (color*w)/(w)
        w = (cnt[p] > 0).astype(np.float32)
        for _ in range(4):
            tb = cv2.blur(t * w[..., None], (blur, blur))
            wb = cv2.blur(w, (blur, blur))
            fill = tb / np.maximum(wb[..., None], 1e-6)
            t = np.where(w[..., None] > 0, t, fill)
            w = np.maximum(w, (wb > 1e-6).astype(np.float32))
        tiles.append(np.clip(t, 0, 1))
    return np.stack(tiles)


def tiles_to_grid(tiles: np.ndarray, rows: int = 4, cols: int = 6) -> np.ndarray:
    """(24, t, t, 3) -> (rows*t, cols*t, 3) atlas grid image."""
    t = tiles.shape[1]
    out = np.zeros((rows * t, cols * t, 3), tiles.dtype)
    for i in range(tiles.shape[0]):
        r, c = divmod(i, cols)
        out[r * t:(r + 1) * t, c * t:(c + 1) * t] = tiles[i]
    return out


def unfold_texture(frame_dir: str, densepose_dir: str, out_path: str,
                   tile: int = 128, size: Optional[int] = None,
                   max_frames: int = 500) -> str:
    """Build texture.jpg from a frame dir + IUV dir. Returns out_path."""
    import cv2
    frames = list_images(frame_dir)
    iuvs = list_images(densepose_dir)
    n = min(len(frames), len(iuvs), max_frames)
    if n == 0:
        raise ValueError("no frames / densepose images found")
    acc = np.zeros((24, tile, tile, 3), np.float64)
    cnt = np.zeros((24, tile, tile), np.float64)
    for i in range(n):
        img = cv2.imread(os.path.join(frame_dir, frames[i]), cv2.IMREAD_COLOR)
        iuv = cv2.imread(os.path.join(densepose_dir, iuvs[i]), cv2.IMREAD_COLOR)
        if img is None or iuv is None:
            continue
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        iuv = cv2.cvtColor(iuv, cv2.COLOR_BGR2RGB)
        if size:
            img = cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)
            iuv = cv2.resize(iuv, (size, size), interpolation=cv2.INTER_NEAREST)
        if iuv.shape[:2] != img.shape[:2]:
            iuv = cv2.resize(iuv, img.shape[1::-1], interpolation=cv2.INTER_NEAREST)
        parts, uv = decode_iuv(iuv)
        accumulate_frame(acc, cnt, img, parts, uv, tile)
    grid = tiles_to_grid(finalize_atlas(acc, cnt))
    bgr = cv2.cvtColor((grid * 255.0).round().astype(np.uint8), cv2.COLOR_RGB2BGR)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    cv2.imwrite(out_path, bgr)
    return out_path
