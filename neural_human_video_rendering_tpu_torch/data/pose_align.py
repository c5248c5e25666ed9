"""Cross-person pose retargeting (graph_posenorm): a copy of the JAX
package's ``data/pose_align.py``.

The fit (global scale + translation from corpus statistics,
Everybody-Dance-Now style), which the inference driver also applies:
  * per frame, body height = max ankle y - min head y (nose/eyes/ears), and
    anchor = ankle midpoint;
  * frames whose height falls outside the spread range are discarded;
  * scale s = median(target heights) / median(source heights);
  * translation t maps the median source anchor onto the median target
    anchor: t = anchor_tgt - s * anchor_src.
Then the rewrite: every source keypoint (body, face, hands) maps to
x' = s * x + t in a keypoint JSON of the results dir, beside an
align_meta.json with the fit and the canvases, and optional overlays of
the aligned skeletons on the source frames. NumPy (and OpenCV for the
overlays) on the host.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from . import keypoints as kp

# BODY_25 indices
_HEAD = (0, 15, 16, 17, 18)   # nose, eyes, ears
_ANKLES = (11, 14)            # RAnkle, LAnkle
_CONF = 0.05


def frame_stats(body25: np.ndarray) -> Optional[Tuple[float, np.ndarray]]:
    """(25,3) -> (height, ankle-midpoint anchor (2,)) or None if unusable."""
    head = body25[list(_HEAD)]
    ank = body25[list(_ANKLES)]
    head = head[head[:, 2] > _CONF]
    ank = ank[ank[:, 2] > _CONF]
    if len(head) == 0 or len(ank) == 0:
        return None
    y_top = float(head[:, 1].min())
    y_bot = float(ank[:, 1].max())
    if y_bot <= y_top:
        return None
    anchor = ank[:, :2].mean(axis=0)
    return y_bot - y_top, anchor


def corpus_stats(pose_dir: str, spread: Tuple[float, float]) -> Tuple[float, np.ndarray]:
    """Median (height, anchor) over all usable frames within the spread range."""
    names = kp.keypoint_jsons(pose_dir)
    heights, anchors = [], []
    for n in names:
        body = kp.parse_keypoint_json(os.path.join(pose_dir, n))["body"]
        st = frame_stats(body)
        if st is None:
            continue
        h, a = st
        if spread[0] <= h <= spread[1]:
            heights.append(h)
            anchors.append(a)
    if not heights:
        raise ValueError(f"no usable frames in {pose_dir} within spread {spread}")
    return float(np.median(heights)), np.median(np.stack(anchors), axis=0)


def corpus_extent(pose_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """((min_x, min_y), (max_x, max_y)) over all detected keypoints."""
    names = kp.keypoint_jsons(pose_dir)
    lo = np.array([np.inf, np.inf])
    hi = np.array([-np.inf, -np.inf])
    for n in names:
        body = kp.parse_keypoint_json(os.path.join(pose_dir, n))["body"]
        pts = body[body[:, 2] > _CONF, :2]
        if len(pts):
            lo = np.minimum(lo, pts.min(axis=0))
            hi = np.maximum(hi, pts.max(axis=0))
    return lo, hi


def fit_scale_translation(target_dir: str, source_dir: str,
                          target_spread: Tuple[float, float] = (0.0, 1e9),
                          source_spread: Tuple[float, float] = (0.0, 1e9),
                          target_shape: Optional[Tuple[int, int]] = None,
                          source_shape: Optional[Tuple[int, int]] = None,
                          ) -> Tuple[float, np.ndarray]:
    """Fit global (s, t) so source skeletons land in the target frame.

    With a target canvas (H, W), the scale shrinks (anchor preserved) until
    the mapped source motion envelope fits the canvas, then t slides it
    inside. source_shape only documents the source coordinate domain.
    """
    th, ta = corpus_stats(target_dir, target_spread)
    sh, sa = corpus_stats(source_dir, source_spread)
    s = th / sh
    t = ta - s * sa
    if target_shape is not None:
        Ht, Wt = target_shape
        lo, hi = corpus_extent(source_dir)
        if np.all(np.isfinite(lo)):
            span = np.maximum(hi - lo, 1e-6)
            s = min(s, (Wt - 1) / span[0], (Ht - 1) / span[1])
            t = ta - s * sa
            m_lo, m_hi = s * lo + t, s * hi + t
            t = t + np.array([
                max(0.0, -m_lo[0]) - max(0.0, m_hi[0] - (Wt - 1)),
                max(0.0, -m_lo[1]) - max(0.0, m_hi[1] - (Ht - 1))])
    return s, t


def apply_scale_translation(person: Dict[str, np.ndarray], s: float,
                            t: np.ndarray) -> Dict[str, np.ndarray]:
    """x' = s*x + t on every keypoint group; confidence untouched."""
    out = {}
    for key, arr in person.items():
        a = arr.copy()
        has = a[:, 2] > 0
        a[has, 0] = s * a[has, 0] + t[0]
        a[has, 1] = s * a[has, 1] + t[1]
        out[key] = a
    return out


def align_pose_dir(source_dir: str, results_dir: str, s: float, t: np.ndarray) -> int:
    """Rewrite every source keypoint JSON into results_dir, retargeted."""
    os.makedirs(results_dir, exist_ok=True)
    names = kp.keypoint_jsons(source_dir)
    for n in names:
        person = kp.parse_keypoint_json(os.path.join(source_dir, n))
        moved = apply_scale_translation(person, s, t)
        kp.write_keypoint_json(os.path.join(results_dir, n), moved["body"],
                               moved["face"], moved["hand_l"], moved["hand_r"])
    return len(names)


def write_align_meta(results_dir: str, s: float, t: np.ndarray,
                     target_shape: Optional[Tuple[int, int]] = None,
                     source_shape: Optional[Tuple[int, int]] = None) -> str:
    """Record the fit + canvas shapes next to the aligned JSONs, so the
    inference driver maps target-canvas coordinates exactly instead of
    guessing the canvas from the largest coordinate."""
    path = os.path.join(results_dir, kp.ALIGN_META)
    with open(path, "w") as f:
        json.dump({"scale": float(s), "translation": [float(t[0]), float(t[1])],
                   "target_shape": list(target_shape) if target_shape else None,
                   "source_shape": list(source_shape) if source_shape else None},
                  f)
    return path


def write_debug_overlays(frames_dir: str, results_dir: str,
                         canvas_hw: Tuple[int, int] = (1024, 1024),
                         max_frames: int = 50) -> int:
    """Draw the ALIGNED skeletons over the source frames into
    {results_dir}/overlay: a visual check that the fitted scale and
    translation land the source person inside the target canvas. The
    align_meta.json sidecar is not a frame (the JAX package pairs it with
    the first frame when the meta is written first, as graph_posenorm
    writes it)."""
    import cv2
    out_dir = os.path.join(results_dir, "overlay")
    os.makedirs(out_dir, exist_ok=True)
    jsons = kp.keypoint_jsons(results_dir)
    frames = sorted(f for f in os.listdir(frames_dir)
                    if f.lower().endswith((".png", ".jpg", ".jpeg")))
    n = min(len(jsons), len(frames), max_frames)
    H, W = canvas_hw
    for i in range(n):
        img = cv2.imread(os.path.join(frames_dir, frames[i]))
        if img is None:
            continue
        img = cv2.resize(img, (W, H))
        body = kp.parse_keypoint_json(os.path.join(results_dir, jsons[i]))["body"]
        joints = kp.body25_to_coco18(body)
        for li, (a, b) in enumerate(kp.COCO18_LIMBS):
            if joints[a, 2] > 0.05 and joints[b, 2] > 0.05:
                c = tuple(int(255 * v) for v in kp.LIMB_COLORS[li][::-1])
                cv2.line(img, tuple(joints[a, :2].astype(int)),
                         tuple(joints[b, :2].astype(int)), c, 3)
        cv2.imwrite(os.path.join(out_dir, frames[i]), img)
    return n
