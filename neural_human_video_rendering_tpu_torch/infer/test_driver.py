"""Inference / pose-transfer driver: driving poses -> frames (test.py).

Port of the JAX package's ``infer/test_driver.py``: load the target
assets (texture atlas, background), load the driving poses (keypoint
JSONs aligned to the target person, or pre-rendered pose images read with
the training geometry), build the renderer, then run the batched pose ->
IUV -> texture-warp -> composite forward and write PNG frames and an HTML
gallery to --results_dir, and with --save_video {results_dir}/video.mp4.
Each batch also takes its LaplaceProj frames (--use_laplace with
--lapalce_path) and, under --instance_feat, the appearance codes of
--load_features / --cluster_idx (zero codes without them).

The forward of batch k+1 runs on the card while batch k is copied to
pinned host memory and a thread pool encodes batch k-1's PNGs.

    python -m neural_human_video_rendering_tpu_torch.infer.test_driver \\
        --pose_path KEYPOINT_DIR --results_dir OUT [test.py flags]

The weights come from --checkpoints_dir/--name at --which_epoch (the
port's .pth files or the JAX package's .msgpack files, G_ema preferred;
see ``build_renderer``), else a seeded random init.

Several ranks (``runtime.launch``: several --gpu_ids, or torchrun) shard
every batch, as the JAX driver shards it over its mesh: the batch is
rounded up to a multiple of the world, each rank renders its rows and
writes their frames under their global names, and after a barrier rank 0
writes the HTML gallery and the video.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import TestOptions
from ..data import dataset as dsm
from ..data import keypoints as kp
from ..data import laplace as lp
from ..data import pose_align
from ..models.renderer import init_params, renderer_from_options
from ..parallel.mesh import DataParallel
from ..runtime import launch
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
            f"--pose_path {opt.pose_path!r} holds no keypoint JSONs")
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


def load_driving_poses(opt):
    """(names, (N, 18, 3) joints on the model canvas, pose-image dataset or
    None): keypoint JSONs (load_driving_joints) or, where --pose_path holds
    none, pre-rendered pose images, read through a FrameDataset so they
    get the training geometry (loadSize canvas, scale_width letterbox, the
    eval centre crop). Pose images cannot be retargeted: --pose_tgt_path
    is then ignored, with a warning."""
    if kp.keypoint_jsons(opt.pose_path):
        return (*load_driving_joints(opt), None)
    names = dsm.list_images(opt.pose_path)
    if not names:
        raise FileNotFoundError(
            f"--pose_path {opt.pose_path!r} contains neither keypoint JSONs "
            "nor pose images")
    pose_ds = dsm.FrameDataset(dataclasses.replace(
        opt, img_path="", mask_path="", densepose_path="", flow_path="",
        flow_inv_path="", lapalce_path="", data_ratio=1.0, no_flip=True),
        "test")
    if opt.pose_tgt_path:
        print("[align] WARNING: --pose_tgt_path ignored: pose-image driving "
              "cannot be retargeted (alignment needs keypoints)", flush=True)
    print(f"[pose] driving with {len(names)} pre-rendered pose images",
          flush=True)
    return names, np.zeros((len(names), kp.N_COCO18, 3), np.float32), pose_ds


def load_cluster_feats(opt) -> Optional[np.ndarray]:
    """Under --instance_feat / --label_feat: the (P+1, feat_num) codes of
    cluster --cluster_idx in --load_features (encode_features' .npz), or
    None for zero codes; the JAX driver's errors for a missing file and an
    index out of range."""
    if not (opt.instance_feat or opt.label_feat):
        return None
    if not opt.load_features:
        print("[feat] --instance_feat/--label_feat without --load_features: "
              "rendering with ZERO appearance codes (build codes with "
              "python -m neural_human_video_rendering_tpu_torch."
              "encode_features)", flush=True)
        return None
    if not os.path.isfile(opt.load_features):
        raise FileNotFoundError(
            f"--load_features {opt.load_features!r} does not exist (build it "
            "with python -m neural_human_video_rendering_tpu_torch."
            "encode_features)")
    centers = np.load(opt.load_features)["centers"]
    if not 0 <= opt.cluster_idx < len(centers):
        raise ValueError(
            f"--cluster_idx {opt.cluster_idx} out of range: "
            f"{opt.load_features} has {len(centers)} clusters")
    print(f"[feat] cluster {opt.cluster_idx} codes from {opt.load_features}",
          flush=True)
    return centers[opt.cluster_idx]


def _nchw(arrays, device: torch.device) -> torch.Tensor:
    """A list of (S, S, C) numpy arrays -> a (B, C, S, S) float32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        np.stack(arrays).transpose(0, 3, 1, 2), np.float32)).to(device)


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
                  assets: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                  dp: Optional[DataParallel] = None) -> Optional[int]:
    """Render the driving sequence; returns the number of frames written
    (by all ranks; None in a process that spawned its ranks).

    assets: optional (texture atlas (P, T, T, 3), background (S, S, 3)) in
    [-1, 1] to use instead of --texture_path / --bg_path (e.g. the
    synthetic ones of data.dataset.SyntheticDataset). ``dp``: this rank,
    when the caller has started it (``runtime.launch``).
    """
    if dp is None:
        return launch(run_inference, opt, batch_size, max_frames, assets,
                      where=opt.results_dir)
    if opt.save_video:
        try:
            import cv2  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "--save_video writes the video with OpenCV, and cv2 does not "
                "import here: drop --save_video (the frames are written as "
                "PNG)") from e
    device = dp.device
    S = opt.train_size
    if batch_size is None:
        batch_size = max(1, opt.infer_batch)
    if dp.parallel:
        batch_size = dp.world * -(-batch_size // dp.world)
        if dp.is_lead:
            print(f"[mesh] inference sharded over {dp.world} ranks (batch "
                  f"{batch_size}, {batch_size // dp.world} a rank)",
                  flush=True)
    mine = dp.rows(batch_size)
    names, joints, pose_ds = load_driving_poses(opt)
    n = len(names) if max_frames is None else min(len(names), max_frames)
    n = min(n, opt.how_many)
    tex, bg = load_assets(opt) if assets is None else assets
    state_assets = assets_to_device(opt, tex, bg, device)
    renderer = build_renderer(opt, device)
    fwd = make_forward_fn(opt, renderer, load_cluster_feats(opt))
    lap_files = (lp.list_frames(opt.lapalce_path) if opt.use_laplace
                 and opt.lapalce_path and os.path.isdir(opt.lapalce_path)
                 else [])
    lap_nc = opt.laplace_nc_eff or opt.laplace_nc
    os.makedirs(opt.results_dir, exist_ok=True)
    gallery = HTMLGallery(opt.results_dir, f"{opt.name} @ {opt.which_epoch}")
    on_cuda = device.type == "cuda"
    pending: deque = deque()       # (frame indices, host frames, ready event)
    writes = []
    written = 0
    t0 = time.perf_counter()

    def frame_name(i):
        return (f"{os.path.splitext(names[i])[0].replace('_keypoints', '')}"
                "_synthesized.png")

    def drain_one(pool):
        nonlocal written
        sel, rows, host, ready = pending.popleft()
        if ready is not None:
            ready.synchronize()
        fakes = host.permute(0, 2, 3, 1).numpy()
        if not np.isfinite(fakes[:len(rows)]).all():
            raise FloatingPointError(
                f"non-finite values in rendered frames {sel[0]}..{sel[-1]}")
        for j, i in enumerate(rows):
            writes.append(pool.submit(
                save_image,
                os.path.join(opt.results_dir, "images", frame_name(i)),
                fakes[j]))
            written += 1
        for i in sel:
            gallery.add_images(names[i], [("synthesized", frame_name(i))])

    with ThreadPoolExecutor(max_workers=4) as pool:
        for start in range(0, n, batch_size):
            sel = list(range(start, min(start + batch_size, n)))
            # pad the tail so every forward sees one batch shape; this
            # rank renders its rows of it and writes the real frames there
            padded = (sel + [sel[-1]] * (batch_size - len(sel)))[mine]
            rows = sel[mine]
            jb = torch.from_numpy(joints[padded].astype(np.float32)).to(device)
            lap = pimg = None
            if lap_files:
                lap = _nchw([lp.load_laplace(os.path.join(
                    opt.lapalce_path, lap_files[min(i, len(lap_files) - 1)]),
                    S, lap_nc) for i in padded], device)
            if pose_ds is not None:
                pimg = _nchw([pose_ds[i]["pose_img"] for i in padded], device)
            fake = fwd(state_assets, jb, lap, pimg)["fake"]
            if on_cuda:
                host = torch.empty(fake.shape, dtype=fake.dtype,
                                   pin_memory=True)
                host.copy_(fake, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
            else:
                host, ready = fake, None
            pending.append((sel, rows, host, ready))
            if len(pending) > 1:
                drain_one(pool)
        while pending:
            drain_one(pool)
        for w in writes:
            w.result()                  # surface any encode errors
    written = int(dp.global_count(torch.tensor(written, device=device)))
    dp.barrier()                        # every rank's frames are on disk
    secs = time.perf_counter() - t0
    if dp.parallel:
        from ..train.drivers import kernel_launches
        print(f"[kernels] {dp} launches since the counters' reset: "
              f"{json.dumps(kernel_launches())}", flush=True)
    if not dp.is_lead:
        return written
    gallery.save()
    if opt.save_video and written:
        from ..utils.video import write_video
        nv, vpath = write_video(os.path.join(opt.results_dir, "images"),
                                os.path.join(opt.results_dir, "video.mp4"),
                                fps=opt.video_fps)
        print(f"[infer] wrote {nv}-frame video -> {vpath}", flush=True)
    print(f"[infer] wrote {written} frames -> {opt.results_dir} "
          f"({secs:.2f} s, {dp})", flush=True)
    return written


def main(argv=None) -> int:
    run_inference(TestOptions().parse(argv, save=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
