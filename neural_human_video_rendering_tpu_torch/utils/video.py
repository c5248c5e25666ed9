"""Assemble rendered frames into a video file: a copy of the JAX package's
``utils/video.py``.

--save_video assembles {results_dir}/video.mp4 from the synthesized
frames in filename order through OpenCV's VideoWriter; where this OpenCV
build has no mp4 codec it falls back to an MJPG .avi beside it, as the
JAX writer does. The inference driver refuses --save_video at the start
of a run where cv2 does not import.
"""

from __future__ import annotations

import os
from typing import Tuple


def write_video(frames_dir: str, out_path: str, fps: float = 25.0,
                pattern: str = "_synthesized") -> Tuple[int, str]:
    """Encode every image in frames_dir whose name contains `pattern`
    (all images if none match) into out_path (mp4, else the .avi
    fallback). Returns (frame count, the file written)."""
    import cv2

    names = sorted(f for f in os.listdir(frames_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    sel = [n for n in names if pattern in n] or names
    if not sel:
        return 0, out_path
    first = cv2.imread(os.path.join(frames_dir, sel[0]))
    h, w = first.shape[:2]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                         fps, (w, h))
    if not vw.isOpened():
        # codec unavailable in this build: fall back to MJPG .avi
        out_path = os.path.splitext(out_path)[0] + ".avi"
        vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"MJPG"),
                             fps, (w, h))
        if not vw.isOpened():
            raise RuntimeError("no usable video codec in this OpenCV build")
    n = 0
    for name in sel:
        img = cv2.imread(os.path.join(frames_dir, name))
        if img is None:
            continue
        if img.shape[:2] != (h, w):
            img = cv2.resize(img, (w, h))
        vw.write(img)
        n += 1
    vw.release()
    return n, out_path
