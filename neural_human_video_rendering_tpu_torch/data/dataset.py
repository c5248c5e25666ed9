"""Host-side data: file decoding, canvas geometry, the real-data
FrameDataset, the deterministic synthetic dataset, batching.

A copy of the JAX package's ``data/dataset.py``. Files decode through
``utils/image`` (OpenCV where it imports, else the port's own PNG reader
and a JPEG decoder), so synthetic data and PNG corpora need no image
library.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.image import read_image, resize
from . import densepose as dp
from . import keypoints as kp
from . import laplace as lp

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


# ----------------------------------------------------------------------
# file I/O helpers
# ----------------------------------------------------------------------

def list_images(d: str) -> List[str]:
    return sorted(f for f in os.listdir(d) if f.lower().endswith(IMG_EXTS))


def load_image(path: str, size: int) -> np.ndarray:
    """Image file -> (size, size, 3) float32 RGB in [-1, 1]."""
    img = read_image(path, "rgb")
    if img.shape[0] != size or img.shape[1] != size:
        img = resize(img, (size, size), "area")
    return img.astype(np.float32) / 255.0 * 2.0 - 1.0


def load_mask(path: str, size: int) -> np.ndarray:
    """Mask file -> (size, size, 1) float32 in [0, 1]."""
    m = read_image(path, "gray")
    if m.shape[0] != size or m.shape[1] != size:
        m = resize(m, (size, size), "nearest")
    return (m.astype(np.float32) / 255.0)[..., None]


def load_iuv(path: str, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """DensePose IUV image -> (parts (S,S) int32, uv (S,S,2) float32)."""
    img = read_image(path, "rgb")
    if img.shape[0] != size or img.shape[1] != size:
        img = resize(img, (size, size), "nearest")
    return dp.decode_iuv(img)


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo reader (FlowNet2 output format) -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.frombuffer(f.read(4), np.float32)[0]
        if abs(magic - 202021.25) > 1e-3:
            raise ValueError(f"bad .flo magic in {path}: {magic}")
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(h * w * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()


def load_flow(path: str, size: int) -> np.ndarray:
    """Flow file (.flo or .npy) -> (size, size, 2), rescaled to the new grid."""
    if path.endswith(".npy"):
        fl = np.load(path).astype(np.float32)
    else:
        fl = read_flo(path)
    h, w = fl.shape[:2]
    if h != size or w != size:
        fl = resize(fl, (size, size), "linear")
        fl[..., 0] *= size / w
        fl[..., 1] *= size / h
    return fl.astype(np.float32)


def load_texture_atlas(path: str, tile: int, rows: int = 4,
                       cols: int = 6) -> np.ndarray:
    """texture.jpg (rows x cols grid of part tiles) -> (24, tile, tile, 3)
    in [-1, 1] (the layout unfold_texture.py writes)."""
    img = read_image(path, "rgb").astype(np.float32) / 255.0
    th, tw = img.shape[0] // rows, img.shape[1] // cols
    tiles = []
    for r in range(rows):
        for c in range(cols):
            t = img[r * th:(r + 1) * th, c * tw:(c + 1) * tw]
            if t.shape[0] != tile or t.shape[1] != tile:
                t = resize(t, (tile, tile), "area")
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


def apply_canvas(arr: np.ndarray, geom: Tuple[float, float, int], S: int,
                 interp: str, fill: float = 0.0) -> np.ndarray:
    """Resize a native-resolution (H, W, C) array per `geom` and paste it
    centered onto an S x S canvas (vertical pad with `fill` / center-crop)."""
    sx, sy, oy = geom
    H, W = arr.shape[:2]
    w2, h2 = int(round(W * sx)), int(round(H * sy))
    if (w2, h2) != (W, H):
        nd = arr.ndim
        arr = resize(arr, (w2, h2), interp)
        if arr.ndim < nd:
            arr = arr[..., None]
    if w2 == S and h2 == S:
        return np.ascontiguousarray(arr.astype(np.float32))
    out = np.full((S, S) + arr.shape[2:], fill, np.float32)
    ys, ye = max(oy, 0), min(oy + h2, S)
    xe = min(w2, S)
    out[ys:ye, :xe] = arr[ys - oy:ye - oy, :xe]
    return out


class FrameDataset:
    """Aligned per-frame multi-modal dataset over the reference directory
    contract (the JAX package's FrameDataset).

    Modalities are index-aligned by sorted filename within each directory
    (frameNNNNN.* across dirs). pose_path holds OpenPose keypoint JSONs
    (rasterized on the device by the step) or pre-rendered pose images.
    Augmentation: optional horizontal flip (unless --no_flip; the sample
    carries ``bg_flip``, and the renderer mirrors the refined background)
    and random crop for the *_crop resize modes (the sample carries its
    window of the background, ``bg``). All randomness
    is a deterministic function of (opt.seed, epoch, frame index), so the
    decode order of --nThreads cannot change it; BatchLoader sets
    ``epoch`` before each epoch.
    """

    def __init__(self, opt, phase: str = "train"):
        self.opt = opt
        self.phase = phase
        self.size = opt.loadSize
        self.epoch = 0
        # crop modes: load at loadSize, random-crop train_size (the same
        # offset for every modality of a sample and its background)
        self.crop = opt.train_size if opt.train_size < opt.loadSize else 0
        self.flip = (not opt.no_flip) and phase == "train"

        def _dir(p):
            return p if p and os.path.isdir(p) else ""

        self.pose_names: List[str] = []
        self.pose_img_names: List[str] = []
        if _dir(opt.pose_path):
            self.pose_names = kp.keypoint_jsons(opt.pose_path)
            if not self.pose_names:
                self.pose_img_names = list_images(opt.pose_path)
        self.img_names = list_images(opt.img_path) if _dir(opt.img_path) else []
        self.mask_names = list_images(opt.mask_path) if _dir(opt.mask_path) else []
        self.dp_names = (list_images(opt.densepose_path)
                         if _dir(opt.densepose_path) else [])
        self.lap_names = (lp.list_frames(opt.lapalce_path)
                          if _dir(opt.lapalce_path) else [])
        self.flow_names = (sorted(os.listdir(opt.flow_path))
                           if _dir(opt.flow_path) else [])
        self.flow_inv_names = (sorted(os.listdir(opt.flow_inv_path))
                               if _dir(opt.flow_inv_path) else [])
        if not any((self.pose_names, self.pose_img_names, self.img_names,
                    self.mask_names, self.dp_names, self.lap_names)):
            raise ValueError(
                "FrameDataset built with no per-frame modality directories")
        n = min(x for x in [len(self.pose_names) or len(self.pose_img_names)
                            or None,
                            len(self.img_names) or None,
                            len(self.mask_names) or None,
                            len(self.dp_names) or None,
                            len(self.lap_names) or None,
                            opt.max_dataset_size] if x)
        idx = np.arange(n)
        split = int(round(n * opt.data_ratio))
        self.indices = idx[:split] if phase == "train" else idx[split:]
        if len(self.indices) == 0:
            self.indices = idx

        # native canvas (W, H) from the first decodable image modality:
        # frames > densepose > mask > rendered pose; every modality maps
        # onto the square loadSize canvas through one shared geometry
        self._canvas: Optional[Tuple[int, int]] = None
        for d, names in ((opt.img_path, self.img_names),
                         (opt.densepose_path, self.dp_names),
                         (opt.mask_path, self.mask_names),
                         (opt.pose_path, self.pose_img_names)):
            if names:
                first = read_image(os.path.join(d, names[0]), "unchanged")
                self._canvas = (first.shape[1], first.shape[0])
                break
        self._geom = (canvas_geom(opt.resize_or_crop, *self._canvas, self.size)
                      if self._canvas else None)
        self._scale_width = opt.resize_or_crop.startswith("scale_width")

        # sequence-cut sidecar ({corpus_root}/cuts.json): listed frames
        # restart the sequence and get frame-0 semantics (self-paired
        # temporal sample, zero flow)
        self.cuts: set = set()
        for d_ in (opt.pose_path, opt.img_path, opt.mask_path,
                   opt.densepose_path):
            if d_ and os.path.isdir(d_):
                cj = os.path.join(os.path.dirname(d_.rstrip("/")), "cuts.json")
                if os.path.isfile(cj):
                    with open(cj) as f:
                        self.cuts = set(json.load(f).get("cuts", []))
                break

        self._bg_full: Optional[np.ndarray] = None
        if ((self.crop or self.flip) and opt.bg_path
                and os.path.isfile(opt.bg_path)):
            # each cropped / mirrored sample composites against its own
            # background window
            self._bg_full = self._image(opt.bg_path)

    def __len__(self) -> int:
        return len(self.indices)

    # -- mode-aware modality loaders (square resize unless a scale_width
    # mode asks for aspect-preserving canvas placement) --

    def _image(self, path: str) -> np.ndarray:
        if not self._scale_width:
            return load_image(path, self.size)
        img = read_image(path, "rgb").astype(np.float32) / 255.0 * 2.0 - 1.0
        return apply_canvas(img, self._geom, self.size, "area", -1.0)

    def _mask(self, path: str) -> np.ndarray:
        if not self._scale_width:
            return load_mask(path, self.size)
        m = (read_image(path, "gray").astype(np.float32) / 255.0)[..., None]
        return apply_canvas(m, self._geom, self.size, "nearest", 0.0)

    def _iuv(self, path: str) -> Tuple[np.ndarray, np.ndarray]:
        if not self._scale_width:
            return load_iuv(path, self.size)
        img = read_image(path, "rgb").astype(np.float32)
        img = apply_canvas(img, self._geom, self.size, "nearest", 0.0)
        return dp.decode_iuv(img.astype(np.uint8))

    def _flow(self, path: str) -> np.ndarray:
        if not self._scale_width:
            return load_flow(path, self.size)
        fl = (np.load(path).astype(np.float32) if path.endswith(".npy")
              else read_flo(path))
        sx, sy, _ = self._geom
        out = apply_canvas(fl, self._geom, self.size, "linear", 0.0)
        out[..., 0] *= sx
        out[..., 1] *= sy
        return out

    def _laplace(self, path: str) -> np.ndarray:
        ch = self.opt.laplace_nc_eff or self.opt.laplace_nc
        if not self._scale_width:
            return lp.load_laplace(path, self.size, ch)
        arr = lp.load_laplace(path, 0, ch)   # size 0 = native resolution
        return apply_canvas(arr, self._geom, self.size, "linear", 0.0)

    def _pose(self, i: int) -> np.ndarray:
        if not self.pose_names:
            return np.zeros((kp.N_COCO18, 3), np.float32)
        body = kp.parse_keypoint_json(
            os.path.join(self.opt.pose_path, self.pose_names[i]))["body"]
        joints = kp.body25_to_coco18(body)
        if self._geom is not None:
            sx, sy, oy = self._geom
            joints = kp.scale_keypoints(joints, sx, sy)
            has = joints[:, 2] > 0
            joints[has, 1] += oy
        return joints

    def __getitem__(self, k: int) -> Dict[str, np.ndarray]:
        i = int(self.indices[k])
        opt = self.opt
        out: Dict[str, np.ndarray] = {"index": np.int32(i)}
        out["joints"] = self._pose(i)
        prev = i if i in self.cuts else max(i - 1, 0)
        out["joints_prev"] = self._pose(prev)
        if self.pose_img_names:
            out["pose_img"] = self._image(
                os.path.join(opt.pose_path, self.pose_img_names[i]))
            out["pose_img_prev"] = self._image(
                os.path.join(opt.pose_path, self.pose_img_names[prev]))
        if self.img_names:
            out["image"] = self._image(os.path.join(opt.img_path,
                                                    self.img_names[i]))
            out["image_prev"] = self._image(
                os.path.join(opt.img_path, self.img_names[prev]))
        if self.mask_names:
            out["mask"] = self._mask(os.path.join(opt.mask_path,
                                                  self.mask_names[i]))
        if self.dp_names:
            parts, uv = self._iuv(os.path.join(opt.densepose_path,
                                               self.dp_names[i]))
            out["dp_parts"], out["dp_uv"] = parts, uv
        if self.lap_names:
            out["laplace"] = self._laplace(
                os.path.join(opt.lapalce_path, self.lap_names[i]))
        # FlowNet2 writes N-1 pairwise files: flow[j] maps frame j+1 back to
        # frame j (the forward flow of frame t is file t-1), flow_inv the
        # reverse. Frame 0 has no predecessor -> zero flow, matching its
        # self-paired temporal sample.
        if self.flow_names:
            out["flow"] = self._frame_flow(self.flow_names, opt.flow_path, i)
        if self.flow_inv_names:
            out["flow_inv"] = self._frame_flow(self.flow_inv_names,
                                               opt.flow_inv_path, i)

        rng = np.random.default_rng((opt.seed, self.epoch, i))
        flipped = bool(self.flip and rng.random() < 0.5)
        if flipped:
            out = self._apply_flip(out)
        if self.crop:
            out = self._apply_crop(out, rng, flipped)
        elif self.flip:
            # the renderer mirrors the shared refined background for
            # flipped samples
            out["bg_flip"] = np.float32(1.0 if flipped else 0.0)
        return out

    def _frame_flow(self, names: List[str], d: str, i: int) -> np.ndarray:
        if i == 0 or i in self.cuts or len(names) == 0:
            return np.zeros((self.size, self.size, 2), np.float32)
        j = min(i - 1, len(names) - 1)
        return self._flow(os.path.join(d, names[j]))

    def _apply_flip(self, out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        for k in ("image", "image_prev", "mask", "laplace",
                  "pose_img", "pose_img_prev"):
            if k in out:
                out[k] = np.ascontiguousarray(out[k][:, ::-1])
        if "dp_parts" in out:
            out["dp_parts"], out["dp_uv"] = dp.flip_iuv(out["dp_parts"],
                                                        out["dp_uv"])
        for k in ("flow", "flow_inv"):
            if k in out:
                f = np.ascontiguousarray(out[k][:, ::-1])
                f[..., 0] *= -1.0
                out[k] = f
        for k in ("joints", "joints_prev"):
            out[k] = kp.flip_keypoints(out[k], self.size)
        return out

    def _apply_crop(self, out: Dict[str, np.ndarray], rng,
                    flipped: bool = False) -> Dict[str, np.ndarray]:
        c, S = self.crop, self.size
        if self.phase == "train":
            oy = int(rng.integers(0, S - c + 1))
            ox = int(rng.integers(0, S - c + 1))
        else:       # deterministic center crop for eval / test
            oy = ox = (S - c) // 2
        for k, v in out.items():
            if isinstance(v, np.ndarray) and v.ndim >= 2 and v.shape[0] == S \
                    and v.shape[1] == S:
                out[k] = np.ascontiguousarray(v[oy:oy + c, ox:ox + c])
        for k in ("joints", "joints_prev"):
            j = out[k].copy()
            has = j[:, 2] > 0
            j[has, 0] -= ox
            j[has, 1] -= oy
            out[k] = j
        if self._bg_full is not None:
            bg = self._bg_full[:, ::-1] if flipped else self._bg_full
            out["bg"] = np.ascontiguousarray(bg[oy:oy + c, ox:ox + c])
        return out


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
    """Batches of a dataset, assembled up to two batches ahead on a
    background thread so the host's data work overlaps the device's step;
    ``threads`` > 1 (--nThreads) also decodes the samples of a batch on a
    thread pool (OpenCV, zlib and numpy release the GIL). Epoch order: a
    RandomState(seed + epoch) shuffle (as the JAX package's BatchLoader on
    one host), or in order with shuffle=False; the short tail is dropped
    unless drop_last=False. Before each epoch the dataset's ``epoch`` (if
    it has one) is set, so FrameDataset's per-(seed, epoch, index)
    augmentation advances. ``transform`` runs on each collated batch in the
    thread (wire.pack_batch).

    ``shard=(index, count)``: rank ``index`` of ``count`` reads a disjoint
    1/count of every epoch: the epoch order (the same shuffle on every
    rank) strided from ``index`` and cut to floor(N / count) samples, so
    every rank reports the same length and the same steps an epoch (the
    JAX package's multi-host shards). Its batch_size is the rank's share
    of the global batch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, threads: int = 1,
                 transform=None, shard: Tuple[int, int] = (0, 1)):
        if not 0 <= shard[0] < shard[1]:
            raise ValueError(f"bad shard {shard}")
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.threads = max(1, threads)
        self.transform = transform
        self.shard = shard
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.ds) // self.shard[1]
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        i, n = self.shard
        return idx[i::n][:len(self.ds) // n]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if hasattr(self.ds, "epoch"):
            self.ds.epoch = self.epoch
        order = self._order()
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()
        pool = None
        if self.threads > 1:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(self.threads)

        def fetch(sel):
            if pool is not None:
                return list(pool.map(lambda i: self.ds[int(i)], sel))
            return [self.ds[int(i)] for i in sel]

        def worker():
            try:
                for b in range(len(self)):
                    if stop.is_set():
                        return
                    batch = collate(fetch(order[b * self.bs:(b + 1) * self.bs]))
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
            if pool is not None:
                pool.shutdown(wait=True)
        self.epoch += 1
