"""Host-side data: canvas geometry, image and atlas loading, the
deterministic synthetic dataset, batching.

A copy of the parts of the JAX package's ``data/dataset.py`` that serving
and the stage-2 train step need (``FrameDataset``, the real-data reader,
is not ported yet). ``cv2`` is imported only where a file is decoded, so
synthetic data needs no image library.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Sequence, Tuple

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
    """Deterministic synthetic stand-in for the full data contract: a
    driving pose sequence and, per item, the frame, its predecessor, the
    mask, DensePose parts and UV, and the flows, plus the static atlas and
    background. The same numbers as the JAX package's SyntheticDataset
    from the same seed.
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

    def __len__(self) -> int:
        return len(self.joints)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        """One training sample (NHWC float32 arrays, as the JAX package's)."""
        i = int(i)
        S = self.size
        j = self.joints[i]
        jp = self.joints[max(i - 1, 0)]

        # frame: smooth color field + bright blob at the body bbox
        yy, xx = np.mgrid[0:S, 0:S].astype(np.float32) / S
        img = np.stack([np.sin(6 * xx + i * 0.1), np.cos(5 * yy),
                        np.sin(4 * (xx + yy))], -1) * 0.3
        cx, cy = j[:, 0].mean() / S, j[:, 1].mean() / S
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 0.08))
        img += blob[..., None] * 0.5
        img = np.clip(img, -1, 1).astype(np.float32)

        # mask / parts from joint proximity
        d2 = np.full((S, S), np.inf, np.float32)
        nearest = np.zeros((S, S), np.int32)
        ys, xs = np.mgrid[0:S, 0:S].astype(np.float32)
        for jid in range(18):
            dj = (xs - j[jid, 0]) ** 2 + (ys - j[jid, 1]) ** 2
            upd = dj < d2
            d2[upd] = dj[upd]
            nearest[upd] = jid
        mask = (d2 < (0.09 * S) ** 2).astype(np.float32)
        parts = np.where(mask > 0, (nearest % 24) + 1, 0).astype(np.int32)
        uv = np.stack([np.mod(xs / S + 0.1 * nearest, 1.0),
                       np.mod(ys / S + 0.07 * nearest, 1.0)],
                      -1).astype(np.float32)
        uv[parts == 0] = 0.0

        flow = np.stack([np.broadcast_to((j - jp)[:, 0].mean(), (S, S)),
                         np.broadcast_to((j - jp)[:, 1].mean(), (S, S))],
                        -1).astype(np.float32)
        return {
            "index": np.int32(i),
            "joints": j, "joints_prev": jp,
            "image": img,
            "image_prev": img,  # static-ish scene; flow ~ rigid shift
            "mask": mask[..., None],
            "dp_parts": parts, "dp_uv": uv,
            "flow": flow, "flow_inv": -flow,
        }

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


# ----------------------------------------------------------------------
# batching
# ----------------------------------------------------------------------

def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}


class BatchLoader:
    """Full batches of a dataset (the short tail is dropped), assembled up
    to two batches ahead on a background thread so the host's data work
    overlaps the device's step. Epoch order: a RandomState(seed + epoch)
    shuffle (as the JAX package's BatchLoader on one host), or in order
    with shuffle=False. ``transform`` runs on each collated batch in the
    thread (wire.pack_batch)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, transform=None):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.transform = transform
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.ds) // self.bs

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()

        def worker():
            try:
                for b in range(len(self)):
                    if stop.is_set():
                        return
                    sel = order[b * self.bs:(b + 1) * self.bs]
                    batch = collate([self.ds[int(i)] for i in sel])
                    if self.transform is not None:
                        batch = self.transform(batch)
                    q.put(batch)
            except BaseException as e:          # surfaced in the consumer
                q.put(e)
                return
            q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():          # unblock a worker waiting on put
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.01)
        self.epoch += 1
