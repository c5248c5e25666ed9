"""Cross-person pose retargeting: the fit the inference driver applies.

A copy of the JAX package's ``data/pose_align.py`` fit (global scale +
translation from corpus statistics, Everybody-Dance-Now style):
  * per frame, body height = max ankle y - min head y (nose/eyes/ears), and
    anchor = ankle midpoint;
  * frames whose height falls outside the spread range are discarded;
  * scale s = median(target heights) / median(source heights);
  * translation t maps the median source anchor onto the median target
    anchor: t = anchor_tgt - s * anchor_src.
NumPy on the host.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

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
    names = sorted(f for f in os.listdir(pose_dir) if f.endswith(".json"))
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
    names = sorted(f for f in os.listdir(pose_dir) if f.endswith(".json"))
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
