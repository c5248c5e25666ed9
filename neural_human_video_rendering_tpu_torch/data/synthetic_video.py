"""A learnable video corpus fabricated from a keypoint sequence: the port
of the JAX package's ``data/synthetic_video.py`` (the same construction and
the same numbers).

A capsule-skeleton person: every COCO-18 limb is a capsule, each pixel
takes the part of its nearest capsule (``LIMB_TO_PART``) with
  u = the normalised position along the limb's axis,
  v = the normalised signed offset across it,
and the frame is exactly the renderer's own equation,
  frame = mask * texture[part](u, v) + (1 - mask) * bg,
so a quality number on this corpus measures optimisation, not an
unreachable target. ``render_frame`` samples the atlas "nearest" (the JAX
package's default; a renderer that warps bilinearly then tops out near
45 dB) or "bilinear" (the renderer's own sampling: a perfect TransG / TexG
/ BGNet stack reconstructs the frame to float precision). The flow
between consecutive frames moves each limb's pixels with its midpoint
(piecewise rigid).

``write_corpus`` writes the reference's data layout (frames, masks,
DensePose IUV, keypoint JSONs, Middlebury .flo flows, bg.jpg and the atlas)
through OpenCV, as the JAX package does, and refuses to start where cv2
does not import.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from . import densepose as dp
from . import keypoints as kp

# COCO-18 limb -> DensePose-style part id (1..24). Limbs follow
# kp.COCO18_LIMBS order; head/face limbs map onto the two head parts,
# torso-ish limbs onto torso parts, arms/legs onto the upper/lower
# arm/leg parts — a plausible, FIXED correspondence (the spec of record
# for this synthetic corpus, pinned by tests).
LIMB_TO_PART = np.array([
    15,  # neck->RShoulder   : upper arm L slot
    16,  # neck->LShoulder   : upper arm R slot
    19,  # RShoulder->RElbow : lower arm L slot
    3,   # RElbow->RWrist    : right hand
    20,  # LShoulder->LElbow : lower arm R slot
    4,   # LElbow->LWrist    : left hand
    1,   # neck->RHip        : torso back
    7,   # RHip->RKnee       : upper leg R
    11,  # RKnee->RAnkle     : lower leg R
    2,   # neck->LHip        : torso front
    8,   # LHip->LKnee       : upper leg L
    12,  # LKnee->LAnkle     : lower leg L
    23,  # neck->nose        : head R
    24,  # nose->REye        : head L
    21,  # REye->REar        : lower arm L back slot (reused)
    22,  # nose->LEye        : lower arm R back slot (reused)
    17,  # LEye->LEar        : upper arm slots (reused)
])

LIMB_RADIUS = 0.035   # capsule half-width as a fraction of canvas size


def part_texture_atlas(n_parts: int = 24, tile: int = 64) -> np.ndarray:
    """(P, T, T, 3) deterministic, visually-distinct per-part textures in
    [-1, 1] — smooth enough to be learnable, structured enough that UV
    errors are visible."""
    g = np.mgrid[0:tile, 0:tile].astype(np.float32) / tile   # (2, T, T) v,u
    v, u = g[0], g[1]
    tiles = []
    for p in range(n_parts):
        r = 0.55 * np.sin(2 * np.pi * (u * (1 + p % 3) + 0.13 * p)) \
            + 0.25 * np.cos(2 * np.pi * v * (1 + p % 2))
        gch = 0.55 * np.cos(2 * np.pi * (v * (1 + p % 4) - 0.07 * p)) \
            + 0.2 * np.sin(2 * np.pi * u)
        b = 0.5 * np.sin(2 * np.pi * ((u + v) * (1 + p % 2) + 0.05 * p))
        tiles.append(np.stack([r, gch, b], -1))
    return np.clip(np.stack(tiles), -1, 1).astype(np.float32)


def background_image(size: int) -> np.ndarray:
    """(S, S, 3) deterministic background in [-1, 1]."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    return np.clip(np.stack([
        0.5 * np.sin(3.1 * xx + 1.0) + 0.15 * np.cos(9 * yy),
        0.5 * np.cos(2.3 * yy) - 0.1,
        0.4 * np.sin(2.0 * (xx + yy)),
    ], -1), -1, 1).astype(np.float32)


def rasterize_iuv(joints: np.ndarray, size: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(18,3) joints -> (parts (S,S) int32, uv (S,S,2) f32, limb (S,S) int32).

    Nearest-capsule assignment over the COCO-18 limb set; limb index -1 =
    background. Vectorized over pixels x limbs."""
    S = size
    ys, xs = np.mgrid[0:S, 0:S].astype(np.float32)
    px = np.stack([xs, ys], -1).reshape(-1, 2)              # (N, 2)
    best_d = np.full(px.shape[0], np.inf, np.float32)
    best_limb = np.full(px.shape[0], -1, np.int32)
    best_u = np.zeros(px.shape[0], np.float32)
    best_v = np.zeros(px.shape[0], np.float32)
    r = LIMB_RADIUS * S
    for li, (a, b) in enumerate(kp.COCO18_LIMBS):
        ja, jb = joints[a], joints[b]
        if ja[2] <= 0.05 or jb[2] <= 0.05:
            continue
        pa, pb = ja[:2], jb[:2]
        d = pb - pa
        L2 = float(d @ d) + 1e-6
        t = np.clip(((px - pa) @ d) / L2, 0.0, 1.0)
        proj = pa + t[:, None] * d
        off = px - proj
        dist = np.sqrt((off * off).sum(-1))
        # signed cross-axis offset for the v coordinate
        nrm = np.array([-d[1], d[0]], np.float32) / np.sqrt(L2)
        vv = (off @ nrm) / r
        upd = (dist < r) & (dist < best_d)
        best_d[upd] = dist[upd]
        best_limb[upd] = li
        best_u[upd] = t[upd]
        best_v[upd] = np.clip(vv[upd] * 0.5 + 0.5, 0.0, 1.0)
    parts = np.where(best_limb >= 0, LIMB_TO_PART[np.clip(best_limb, 0, None)],
                     0).astype(np.int32)
    uv = np.stack([best_u, best_v], -1).astype(np.float32)
    uv[parts == 0] = 0.0
    return (parts.reshape(S, S), uv.reshape(S, S, 2),
            best_limb.reshape(S, S))


def render_frame(parts: np.ndarray, uv: np.ndarray, atlas: np.ndarray,
                 bg: np.ndarray, sampling: str = "nearest"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The model's own forward equation on ground-truth IUV:
    frame = mask * atlas[part](u, v) + (1-mask) * bg. Returns (frame, mask).

    sampling: "nearest" (the default) or "bilinear": the model warps
    bilinearly, so a nearest-rendered corpus caps a GT-everything
    reconstruction at ~45 dB (docs/QUALITY.md); a bilinear corpus makes
    float-precision reconstruction reachable."""
    T = atlas.shape[1]
    pi = np.clip(parts - 1, 0, atlas.shape[0] - 1)
    x = np.clip(uv[..., 0] * (T - 1), 0, T - 1)
    y = np.clip(uv[..., 1] * (T - 1), 0, T - 1)
    if sampling == "bilinear":
        x0 = np.floor(x).astype(np.int32)
        y0 = np.floor(y).astype(np.int32)
        x1 = np.minimum(x0 + 1, T - 1)
        y1 = np.minimum(y0 + 1, T - 1)
        wx = (x - x0)[..., None]
        wy = (y - y0)[..., None]
        fg = ((atlas[pi, y0, x0] * (1 - wx) + atlas[pi, y0, x1] * wx)
              * (1 - wy)
              + (atlas[pi, y1, x0] * (1 - wx) + atlas[pi, y1, x1] * wx)
              * wy)
    else:
        fg = atlas[pi, np.round(y).astype(np.int32),
                   np.round(x).astype(np.int32)]
    mask = (parts > 0).astype(np.float32)[..., None]
    return (mask * fg + (1 - mask) * bg).astype(np.float32), mask


def limb_flow(joints: np.ndarray, joints_prev: np.ndarray,
              limb_map: np.ndarray) -> np.ndarray:
    """(S,S,2) flow t -> t-1 from per-limb midpoint displacement
    (piecewise-rigid); zero on background."""
    S = limb_map.shape[0]
    flow = np.zeros((S, S, 2), np.float32)
    for li, (a, b) in enumerate(kp.COCO18_LIMBS):
        sel = limb_map == li
        if not sel.any():
            continue
        mid_now = (joints[a, :2] + joints[b, :2]) / 2
        mid_prev = (joints_prev[a, :2] + joints_prev[b, :2]) / 2
        flow[sel] = (mid_prev - mid_now)[None, :]
    return flow


def fit_canvas_joints(all_joints: np.ndarray, size: int,
                      margin: float = 0.08) -> np.ndarray:
    """Map a keypoint sequence onto the square canvas, preserving aspect."""
    pts = all_joints[..., :2][all_joints[..., 2] > 0.05]
    lo, hi = pts.min(0), pts.max(0)
    span = float(max(hi[0] - lo[0], hi[1] - lo[1], 1.0))
    s = size * (1 - 2 * margin) / span
    out = all_joints.copy()
    has = out[..., 2] > 0.05
    for ax in (0, 1):
        c = (lo[ax] + hi[ax]) / 2
        out[..., ax] = np.where(has, (out[..., ax] - c) * s + size / 2,
                                out[..., ax])
    return out


def write_corpus(out_dir: str, joints_seq: np.ndarray, size: int = 512,
                 tile: int = 64, laplace_ch: int = 0,
                 cuts=(), corrupt: float = 0.0,
                 corrupt_seed: int = 0,
                 sampling: str = "nearest") -> Dict[str, str]:
    """Write the full reference data-contract tree for a joint sequence.

    joints_seq: (N, 18, 3) in canvas coordinates. Returns path dict.
    cuts: frame indices where the sequence restarts (multi-person pools:
    person boundaries) — the pairwise flow there is zeroed instead of
    computed across unrelated identities.
    corrupt > 0: write CORRUPTED pseudo-GT (mask / densepose IUV / bg.jpg —
    data/corruption.py simulates each preprocessing tool's failure modes at
    this strength) while the frames stay TRUE — the noisy-supervision
    regime the reference's online refinement claims to train past.
    """
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "write_corpus writes its PNG and JPEG files with OpenCV, and cv2 "
            "does not import here: install OpenCV's Python package "
            "(opencv-python or opencv-python-headless)") from e

    from . import corruption as cr

    def d(name):
        p = os.path.join(out_dir, name)
        os.makedirs(p, exist_ok=True)
        return p

    paths = {"root": out_dir}
    img_d = paths["frames"] = d("frames")
    dp_d = paths["densepose"] = d("densepose")
    mask_d = paths["mask"] = d("mask")
    flow_d = paths["flow"] = d("flow")
    flowi_d = paths["flow_inv"] = d("flow_inv")
    kp_d = paths["openpose_json"] = d("openpose_json")
    atlas = part_texture_atlas(tile=tile)
    bg = background_image(size)

    def imwrite_rgb(path, img01):
        cv2.imwrite(path, cv2.cvtColor(
            (np.clip(img01, 0, 1) * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))

    prev = None
    masks_sum = np.zeros((size, size), np.float32)
    for i, joints in enumerate(joints_seq):
        parts, uv, limb = rasterize_iuv(joints, size)
        frame, mask = render_frame(parts, uv, atlas, bg, sampling)
        masks_sum += mask[..., 0]
        imwrite_rgb(os.path.join(img_d, f"frame{i:05d}.png"),
                    (frame + 1) / 2)
        mask_out = mask[..., 0]
        parts_out, uv_out = parts, uv
        if corrupt > 0:
            mask_out = cr.corrupt_mask(mask_out, corrupt_seed, i, corrupt)
            parts_out, uv_out = cr.corrupt_iuv(parts, uv, corrupt_seed, i,
                                               corrupt)
        cv2.imwrite(os.path.join(mask_d, f"frame{i:05d}.png"),
                    (mask_out * 255).astype(np.uint8))
        cv2.imwrite(os.path.join(dp_d, f"frame{i:05d}.png"),
                    cv2.cvtColor(dp.encode_iuv(parts_out, uv_out),
                                 cv2.COLOR_RGB2BGR))
        body25 = np.zeros((25, 3), np.float32)
        body25[kp.BODY25_TO_COCO18] = joints
        kp.write_keypoint_json(
            os.path.join(kp_d, f"frame{i:05d}_keypoints.json"), body25)
        if prev is not None:
            fl = (np.zeros((size, size, 2), np.float32) if i in cuts
                  else limb_flow(joints, prev, limb))
            for dd, arr in ((flow_d, fl), (flowi_d, -fl)):
                with open(os.path.join(dd, f"frame{i - 1:05d}.flo"), "wb") as f:
                    f.write(np.float32(202021.25).tobytes())
                    f.write(np.int32(size).tobytes())
                    f.write(np.int32(size).tobytes())
                    f.write(fl.astype(np.float32).tobytes()
                            if dd is flow_d else
                            (-fl).astype(np.float32).tobytes())
        prev = joints
        if laplace_ch:
            lap_d = paths.setdefault("LaplaceProj", d("LaplaceProj"))
            lap = np.zeros((size, size, laplace_ch), np.float32)
            np.save(os.path.join(lap_d, f"frame{i:05d}.npy"), lap)

    if cuts:
        # sidecar consumed by FrameDataset: frames listed here restart the
        # sequence (multi-person pools) and get frame-0 semantics — self-
        # paired temporal sample + zero flow — instead of pairing with the
        # previous identity's last frame
        import json
        with open(os.path.join(out_dir, "cuts.json"), "w") as f:
            json.dump({"cuts": sorted(int(c) for c in cuts)}, f)
    paths["bg.jpg"] = os.path.join(out_dir, "bg.jpg")
    bg_out = bg
    if corrupt > 0:
        occ = cr.occupancy(masks_sum, len(joints_seq))
        bg_out = cr.corrupt_bg(bg, occ, corrupt_seed, corrupt)
    imwrite_rgb(paths["bg.jpg"], (bg_out + 1) / 2)
    from . import texture_unfold as tu
    paths["texture.jpg"] = os.path.join(out_dir, "texture.png")
    if corrupt > 0:
        # the reference's texture.jpg is DERIVED pseudo-GT: unfold_texture
        # over the (noisy) DensePose IUV + real frames (README.md:64). The
        # corrupted corpus reproduces that provenance — the static atlas
        # inherits the IUV corruption instead of being handed the
        # generating truth.
        tu.unfold_texture(img_d, dp_d, paths["texture.jpg"], tile=tile)
    else:
        grid = tu.tiles_to_grid((atlas + 1) / 2)
        imwrite_rgb(paths["texture.jpg"], grid)
    return paths


def load_reference_joints(keypoints_dir: str, size: int) -> np.ndarray:
    """All reference keypoint JSONs -> (N, 18, 3) fit to the canvas."""
    _, joints = kp.load_pose_dir(keypoints_dir)
    return fit_canvas_joints(joints.astype(np.float32), size)


def person_variant(joints_seq: np.ndarray, size: int, seed: int
                   ) -> np.ndarray:
    """Deterministic per-identity body variation for multi-person pools.

    Stage-1 pretraining is person-AGNOSTIC in the reference
    (pretrainTrans.sh pools keypoints/masks/densepose across people); the
    fabricated corpus expresses that by re-proportioning the driving
    sequence per identity: global scale + horizontal offset + per-limb
    length scaling about the neck anchor, clamped to the canvas. seed=0
    returns the sequence unchanged.
    """
    if seed == 0:
        return joints_seq
    rng = np.random.RandomState(seed)
    scale = 0.8 + 0.3 * rng.rand()
    dx = (rng.rand() - 0.5) * 0.2 * size
    limb_scale = 0.85 + 0.3 * rng.rand(18).astype(np.float32)
    out = joints_seq.copy()
    has = out[..., 2] > 0
    anchor = out[:, 1:2, :2]                     # neck, (N,1,2)
    rel = out[..., :2] - anchor
    rel *= scale * limb_scale[None, :, None]
    out[..., :2] = anchor + rel
    out[..., 0] += dx
    out[..., 0] = np.where(has, np.clip(out[..., 0], 0, size - 1), 0)
    out[..., 1] = np.where(has, np.clip(out[..., 1], 0, size - 1), 0)
    return out
