"""Inference / pose-transfer driver: keypoints -> frames (test.py).

Port of the JAX package's ``infer/test_driver.py`` for keypoint driving:
load the target assets (texture atlas, background), align the driving
keypoints to the target person, build the renderer, then run the batched
pose -> IUV -> texture-warp -> composite forward and write PNG frames and
an HTML gallery to --results_dir.

The forward of batch k+1 runs on the card while batch k is copied to
pinned host memory and a thread pool encodes batch k-1's PNGs.

    python -m neural_human_video_rendering_tpu_torch.infer.test_driver \\
        --pose_path KEYPOINT_DIR --results_dir OUT [test.py flags]

The weights come from --checkpoints_dir/--name at --which_epoch (the
port's .pth files or the JAX package's .msgpack files, G_ema preferred;
see ``build_renderer``), else a seeded random init.

Not in this slice: driving with pre-rendered pose images, LaplaceProj
channels, feature-encoder codes and video assembly.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import TestOptions, resolve_device
from ..data import dataset as dsm
from ..data import keypoints as kp
from ..data import pose_align
from ..models.renderer import init_params, renderer_from_options
from ..train.steps import make_forward_fn
from ..utils import checkpoint as ckpt
from ..utils.html import HTMLGallery
from ..utils.image import save_image


def _target_canvas(opt) -> Optional[tuple]:
    """(H, W) pixel canvas the (aligned) keypoints live on: --target_shape
    beats the align_meta.json sidecar written by graph_posenorm beats
    nothing (caller falls back to corpus extent)."""
    hw = opt.parse_shape(opt.target_shape)
    if hw is not None:
        return hw
    for d in (opt.pose_path, opt.pose_tgt_path):
        meta = os.path.join(d, "align_meta.json") if d else ""
        if meta and os.path.isfile(meta):
            with open(meta) as f:
                ts = json.load(f).get("target_shape")
            if ts:
                return int(ts[0]), int(ts[1])
    return None


def map_driving_joints(opt, joints: np.ndarray,
                       canvas: Optional[tuple]) -> np.ndarray:
    """Map target-canvas pixel keypoints onto the square model canvas with
    the geometry training used (dataset.canvas_geom; crop modes add the
    deterministic center-crop offset). Falls back to a corpus-extent
    squeeze when no canvas is known."""
    S = opt.train_size
    if canvas is not None:
        Ht, Wt = max(float(canvas[0]), 1.0), max(float(canvas[1]), 1.0)
        sx, sy, oy = dsm.canvas_geom(opt.resize_or_crop, Wt, Ht, opt.loadSize)
        oc = (opt.loadSize - S) // 2 if S < opt.loadSize else 0
        joints = joints.copy()
        has = joints[..., 2] > 0
        joints[..., 0] = np.where(has, joints[..., 0] * sx - oc,
                                  joints[..., 0])
        joints[..., 1] = np.where(has, joints[..., 1] * sy + oy - oc,
                                  joints[..., 1])
        return joints
    extent = max(float(np.max(joints[..., :2])), 1.0)
    if extent > S:
        joints = joints.copy()
        joints[..., :2] *= S / extent
    return joints


def load_driving_joints(opt) -> Tuple[List[str], np.ndarray]:
    """Keypoint JSON names and (N, 18, 3) joints on the model canvas,
    retargeted to --pose_tgt_path's person when it is given."""
    names, joints = kp.load_pose_dir(opt.pose_path)
    if not names:
        raise FileNotFoundError(
            f"--pose_path {opt.pose_path!r} holds no keypoint JSONs (driving "
            "with pre-rendered pose images is not in the PyTorch port yet)")
    if opt.pose_tgt_path and os.path.isdir(opt.pose_tgt_path):
        s, t = pose_align.fit_scale_translation(
            opt.pose_tgt_path, opt.pose_path,
            target_shape=_target_canvas(opt),
            source_shape=opt.parse_shape(opt.source_shape))
        joints = joints.copy()
        has = joints[..., 2] > 0
        joints[..., 0] = np.where(has, s * joints[..., 0] + t[0], joints[..., 0])
        joints[..., 1] = np.where(has, s * joints[..., 1] + t[1], joints[..., 1])
        print(f"[align] scale {s:.3f}, translation {t}", flush=True)
    canvas = _target_canvas(opt)
    if canvas is None and opt.pose_tgt_path and os.path.isdir(opt.pose_tgt_path):
        _, hi = pose_align.corpus_extent(opt.pose_tgt_path)
        if np.all(np.isfinite(hi)):
            canvas = (float(hi[1]), float(hi[0]))
    return names, map_driving_joints(opt, joints, canvas)


def load_assets(opt) -> Tuple[np.ndarray, np.ndarray]:
    """(texture atlas (P, T, T, 3), background (S, S, 3)) in [-1, 1] from
    --texture_path / --bg_path, zeros where a path is not given."""
    S = opt.train_size
    tex = (dsm.load_texture_atlas(opt.texture_path, opt.tex_tile,
                                  opt.tex_rows, opt.tex_cols)
           if opt.texture_path and os.path.isfile(opt.texture_path)
           else np.zeros((opt.n_parts, opt.tex_tile, opt.tex_tile, 3),
                         np.float32))
    bg = (dsm.load_image(opt.bg_path, S)
          if opt.bg_path and os.path.isfile(opt.bg_path)
          else np.zeros((S, S, 3), np.float32))
    return tex, bg


def assets_to_device(opt, tex: np.ndarray, bg: np.ndarray,
                     device: torch.device):
    """Numpy assets -> the forward's (static_tex (P, 3, T, T), bg (3, S, S),
    tex_mask (P, 1, T, T) or None) on `device`."""
    static_tex = torch.from_numpy(np.ascontiguousarray(
        tex.transpose(0, 3, 1, 2), np.float32)).to(device)
    bg_t = torch.from_numpy(np.ascontiguousarray(
        bg.transpose(2, 0, 1), np.float32)).to(device)
    tex_mask = None
    if opt.use_mask_texture:
        tex_mask = ((static_tex + 1.0).abs().sum(1, keepdim=True) > 0.05).float()
    return static_tex, bg_t, tex_mask


def build_renderer(opt, device: torch.device):
    """The renderer on `device`, in eval mode: the weights of --name's run
    dir when it holds a numeric-epoch G file (.pth or .msgpack), from the
    G_ema file at --which_epoch where one exists (unless --no_ema), else
    G; a seeded random init (--seed) when it holds none."""
    renderer = init_params(renderer_from_options(opt), opt.seed)
    run_dir = opt.run_dir
    if ckpt.latest_epoch(run_dir, "G") is not None:
        label = ("G_ema" if not opt.no_ema and ckpt.find_net(
            run_dir, "G_ema", opt.which_epoch) else "G")
        path = ckpt.load_net_into(renderer, run_dir, label, opt.which_epoch)
        print(f"[ckpt] loaded {label} epoch {opt.which_epoch} from {path}",
              flush=True)
    else:
        print("[ckpt] no checkpoint found -> random-init demo render",
              flush=True)
    return renderer.to(device).eval()


def run_inference(opt, batch_size: Optional[int] = None,
                  max_frames: Optional[int] = None,
                  assets: Optional[Tuple[np.ndarray, np.ndarray]] = None) -> int:
    """Render the driving sequence; returns the number of frames written.

    assets: optional (texture atlas (P, T, T, 3), background (S, S, 3)) in
    [-1, 1] to use instead of --texture_path / --bg_path (e.g. the
    synthetic ones of data.dataset.SyntheticDataset).
    """
    device = resolve_device(opt.gpu_ids)
    if batch_size is None:
        batch_size = max(1, opt.infer_batch)
    names, joints = load_driving_joints(opt)
    n = len(names) if max_frames is None else min(len(names), max_frames)
    n = min(n, opt.how_many)
    tex, bg = load_assets(opt) if assets is None else assets
    state_assets = assets_to_device(opt, tex, bg, device)
    renderer = build_renderer(opt, device)
    fwd = make_forward_fn(opt, renderer)
    os.makedirs(opt.results_dir, exist_ok=True)
    gallery = HTMLGallery(opt.results_dir, f"{opt.name} @ {opt.which_epoch}")
    on_cuda = device.type == "cuda"
    pending: deque = deque()       # (frame indices, host frames, ready event)
    writes = []
    written = 0
    t0 = time.perf_counter()

    def drain_one(pool):
        nonlocal written
        sel, host, ready = pending.popleft()
        if ready is not None:
            ready.synchronize()
        fakes = host.permute(0, 2, 3, 1).numpy()
        if not np.isfinite(fakes[:len(sel)]).all():
            raise FloatingPointError(
                f"non-finite values in rendered frames {sel[0]}..{sel[-1]}")
        for j, i in enumerate(sel):
            fname = (f"{os.path.splitext(names[i])[0].replace('_keypoints', '')}"
                     "_synthesized.png")
            writes.append(pool.submit(
                save_image, os.path.join(opt.results_dir, "images", fname),
                fakes[j]))
            gallery.add_images(names[i], [("synthesized", fname)])
            written += 1

    with ThreadPoolExecutor(max_workers=4) as pool:
        for start in range(0, n, batch_size):
            sel = list(range(start, min(start + batch_size, n)))
            # pad the tail so every forward sees one batch shape
            padded = sel + [sel[-1]] * (batch_size - len(sel))
            jb = torch.from_numpy(joints[padded].astype(np.float32)).to(device)
            fake = fwd(state_assets, jb)["fake"]
            if on_cuda:
                host = torch.empty(fake.shape, dtype=fake.dtype,
                                   pin_memory=True)
                host.copy_(fake, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
            else:
                host, ready = fake, None
            pending.append((sel, host, ready))
            if len(pending) > 1:
                drain_one(pool)
        while pending:
            drain_one(pool)
        for w in writes:
            w.result()                  # surface any encode errors
    gallery.save()
    secs = time.perf_counter() - t0
    print(f"[infer] wrote {written} frames -> {opt.results_dir} "
          f"({secs:.2f} s, device {device})", flush=True)
    return written


def main(argv=None) -> int:
    opt = TestOptions().parse(argv, save=False)
    return run_inference(opt)


if __name__ == "__main__":
    main()
