"""OpenPose keypoint JSON parsing and the 18-joint pose encoding.

Schema (verified against all 100 reference demo files,
reference: keypoints/frame00000_keypoints.json): OpenPose v1.2 output with
``people[i].pose_keypoints_2d`` = 25 BODY_25 joints x (x, y, confidence),
``face_keypoints_2d`` = 70 x 3, ``hand_{left,right}_keypoints_2d`` = 21 x 3.

The reference run names (``*_18Feature_*``, test_start/start.sh:7) indicate an
18-joint (COCO-18) feature encoding; BODY_25 is reduced to COCO-18 here.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

N_BODY25 = 25
N_COCO18 = 18
N_FACE = 70
N_HAND = 21

# BODY_25 index -> COCO-18 order (drops MidHip(8) and feet 19-24)
BODY25_TO_COCO18 = np.array([0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18])

# COCO-18 skeleton (OpenPose limb connectivity)
COCO18_LIMBS: Tuple[Tuple[int, int], ...] = (
    (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7),
    (1, 8), (8, 9), (9, 10), (1, 11), (11, 12), (12, 13),
    (1, 0), (0, 14), (14, 16), (0, 15), (15, 17),
)

# OpenPose rainbow palette, one RGB color per limb (float in [0,1])
LIMB_COLORS = np.array([
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170],
], dtype=np.float32) / 255.0


def parse_keypoint_json(path: str) -> Dict[str, np.ndarray]:
    """Parse one OpenPose JSON into float32 arrays (first person only).

    Returns dict with 'body' (25,3), 'face' (70,3), 'hand_l'/'hand_r' (21,3).
    Missing people yield zero arrays (confidence 0 everywhere).
    """
    with open(path) as f:
        data = json.load(f)
    people = data.get("people", [])

    def grab(person, key, n):
        if person is None:
            return np.zeros((n, 3), np.float32)
        arr = np.asarray(person.get(key, []), np.float32)
        if arr.size != n * 3:
            return np.zeros((n, 3), np.float32)
        return arr.reshape(n, 3)

    p = people[0] if people else None
    return {
        "body": grab(p, "pose_keypoints_2d", N_BODY25),
        "face": grab(p, "face_keypoints_2d", N_FACE),
        "hand_l": grab(p, "hand_left_keypoints_2d", N_HAND),
        "hand_r": grab(p, "hand_right_keypoints_2d", N_HAND),
    }


def body25_to_coco18(body: np.ndarray) -> np.ndarray:
    """(25,3) BODY_25 -> (18,3) COCO-18 keypoints."""
    return body[BODY25_TO_COCO18]


def load_pose_dir(pose_dir: str) -> Tuple[List[str], np.ndarray]:
    """Load every *_keypoints.json in a directory (sorted).

    Returns (filenames, (N,18,3) COCO-18 array).
    """
    names = sorted(f for f in os.listdir(pose_dir) if f.endswith(".json"))
    out = np.zeros((len(names), N_COCO18, 3), np.float32)
    for i, n in enumerate(names):
        out[i] = body25_to_coco18(parse_keypoint_json(os.path.join(pose_dir, n))["body"])
    return names, out


def write_keypoint_json(path: str, body25: np.ndarray,
                        face: Optional[np.ndarray] = None,
                        hand_l: Optional[np.ndarray] = None,
                        hand_r: Optional[np.ndarray] = None) -> None:
    """Write an OpenPose-v1.2-format JSON (inverse of parse_keypoint_json)."""
    def flat(a, n):
        if a is None:
            return []
        return [round(float(x), 6) for x in np.asarray(a, np.float32).reshape(-1)]

    data = {
        "version": 1.2,
        "people": [{
            "pose_keypoints_2d": flat(body25, N_BODY25),
            "face_keypoints_2d": flat(face, N_FACE),
            "hand_left_keypoints_2d": flat(hand_l, N_HAND),
            "hand_right_keypoints_2d": flat(hand_r, N_HAND),
            "pose_keypoints_3d": [], "face_keypoints_3d": [],
            "hand_left_keypoints_3d": [], "hand_right_keypoints_3d": [],
        }],
    }
    with open(path, "w") as f:
        json.dump(data, f)


def scale_keypoints(kp: np.ndarray, sx: float, sy: float) -> np.ndarray:
    """Scale (.., 3) keypoints' xy (e.g. original image size -> loadSize)."""
    out = kp.copy()
    out[..., 0] *= sx
    out[..., 1] *= sy
    return out


# Horizontal-mirror permutation of COCO-18 (swap L/R limbs + face points):
# 0 nose, 1 neck stay; shoulders 2<->5, elbows 3<->6, wrists 4<->7,
# hips 8<->11, knees 9<->12, ankles 10<->13, eyes 14<->15, ears 16<->17.
COCO18_FLIP_PERM = np.array(
    [0, 1, 5, 6, 7, 2, 3, 4, 11, 12, 13, 8, 9, 10, 15, 14, 17, 16])


def flip_keypoints(joints: np.ndarray, width: float) -> np.ndarray:
    """Horizontally mirror (18,3) COCO-18 keypoints on a canvas of `width`:
    x -> width-1-x on detected joints, then the L/R joint swap (pix2pixHD
    flip augmentation; the reference disables it with --no_flip on every
    launcher — train_start/pretrain_start.sh:23 — but the forked framework
    has it, VERDICT.md missing #3)."""
    out = joints[COCO18_FLIP_PERM].copy()
    has = out[:, 2] > 0
    out[has, 0] = (width - 1.0) - out[has, 0]
    return out
