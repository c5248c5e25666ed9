"""Host-side assets for the serving path: canvas geometry, image and atlas
loading, and the deterministic synthetic pose sequence / atlas /
background.

A copy of the parts of the JAX package's ``data/dataset.py`` that
inference needs. ``cv2`` is imported only where a file is decoded, so
synthetic assets need no image library.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "loading --bg_path / --texture_path images needs OpenCV (cv2), "
            "which is not installed; run without them (zero or synthetic "
            "assets) or install opencv") from e
    return cv2


def load_image(path: str, size: int) -> np.ndarray:
    """Image file -> (size, size, 3) float32 RGB in [-1, 1]."""
    cv2 = _cv2()
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.shape[0] != size or img.shape[1] != size:
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)
    return img.astype(np.float32) / 255.0 * 2.0 - 1.0


def load_texture_atlas(path: str, tile: int, rows: int = 4,
                       cols: int = 6) -> np.ndarray:
    """texture.jpg (rows x cols grid of part tiles) -> (24, tile, tile, 3)
    in [-1, 1] (the layout unfold_texture.py writes)."""
    cv2 = _cv2()
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    th, tw = img.shape[0] // rows, img.shape[1] // cols
    tiles = []
    for r in range(rows):
        for c in range(cols):
            t = img[r * th:(r + 1) * th, c * tw:(c + 1) * tw]
            if t.shape[0] != tile or t.shape[1] != tile:
                t = cv2.resize(t, (tile, tile), interpolation=cv2.INTER_AREA)
            tiles.append(t)
    return np.stack(tiles).astype(np.float32) * 2.0 - 1.0


def canvas_geom(mode: str, W: int, H: int, S: int) -> Tuple[float, float, int]:
    """(sx, sy, oy): map native (W, H) pixels onto the square S canvas as
    x' = sx*x, y' = sy*y + oy.

    resize / resize_and_crop / crop / none -> anisotropic resize to S x S;
    scale_width / scale_width_and_crop -> aspect-preserving scale so width
    == S, height centered on the square canvas.
    """
    if mode.startswith("scale_width"):
        sc = S / W
        h2 = int(round(H * sc))
        return sc, sc, (S - h2) // 2
    return S / W, S / H, 0


class SyntheticDataset:
    """Deterministic synthetic driving sequence and target assets.

    The pose sequence, static atlas and background of the JAX package's
    SyntheticDataset (the same numbers from the same seed); the frames,
    DensePose and flow it also fabricates belong to the training slice.
    """

    def __init__(self, opt, length: int = 16, seed: int = 0):
        self.opt = opt
        self.size = opt.train_size
        rng = np.random.RandomState(seed)
        base = self._canonical_pose(self.size)
        self.joints = np.stack([
            self._wiggle(base, rng, t, self.size) for t in range(length)])

    @staticmethod
    def _canonical_pose(S: int) -> np.ndarray:
        u = S / 512.0
        pts = np.array([
            [256, 90], [256, 140], [216, 140], [200, 210], [196, 270],
            [296, 140], [312, 210], [316, 270], [232, 280], [228, 360],
            [226, 440], [280, 280], [284, 360], [286, 440], [246, 80],
            [266, 80], [236, 88], [276, 88],
        ], np.float32) * u
        return np.concatenate([pts, np.ones((18, 1), np.float32)], axis=1)

    @staticmethod
    def _wiggle(base: np.ndarray, rng, t: int, S: int) -> np.ndarray:
        out = base.copy()
        out[:, 0] += 20 * np.sin(0.3 * t) + rng.uniform(-2, 2, 18)
        out[:, 1] += 5 * np.cos(0.2 * t) + rng.uniform(-2, 2, 18)
        out[:, :2] = np.clip(out[:, :2], 4, S - 4)
        return out

    def texture_atlas(self) -> np.ndarray:
        """Deterministic (24, tile, tile, 3) static atlas in [-1, 1]."""
        t = self.opt.tex_tile
        g = np.mgrid[0:t, 0:t].astype(np.float32) / t
        tiles = []
        for p in range(24):
            tiles.append(np.stack([np.sin(3 * g[0] + p), np.cos(4 * g[1] + 0.5 * p),
                                   np.sin(2 * (g[0] + g[1]) + 0.2 * p)], -1) * 0.8)
        return np.stack(tiles).astype(np.float32)

    def background(self) -> np.ndarray:
        S = self.size
        yy, xx = np.mgrid[0:S, 0:S].astype(np.float32) / S
        return np.stack([0.2 * np.sin(3 * xx), 0.2 * np.cos(3 * yy),
                         xx * 0.4 - 0.2], -1).astype(np.float32)
