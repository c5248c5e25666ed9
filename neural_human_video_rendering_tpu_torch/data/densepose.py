"""DensePose IUV decoding (pseudo-ground-truth for the UV generator): a
copy of the JAX package's ``data/densepose.py``.

The reference consumes detectron2-DensePose IUV images from the per-video
``densepose/`` directory (reference: README.md:54, train_start/
pretrain_start.sh:18). Contract pinned here (and by tests): an IUV image is
an 8-bit 3-channel image whose channel 0 holds the part index I in {0..24}
(0 = background), channel 1 holds U*255 and channel 2 holds V*255.

Decoded form used throughout the framework:
  parts: (H, W) int32 part index map, 0 = background
  uv:    (H, W, 2) float32 in [0, 1]
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

N_PARTS = 24


def decode_iuv(iuv: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(H,W,3) uint8 IUV image -> (parts (H,W) int32, uv (H,W,2) float32)."""
    iuv = np.asarray(iuv)
    parts = iuv[..., 0].astype(np.int32)
    parts = np.clip(parts, 0, N_PARTS)
    uv = iuv[..., 1:3].astype(np.float32) / 255.0
    uv[parts == 0] = 0.0
    return parts, uv


def encode_iuv(parts: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Inverse of decode_iuv -> (H,W,3) uint8."""
    out = np.zeros(parts.shape + (3,), np.uint8)
    out[..., 0] = np.clip(parts, 0, N_PARTS).astype(np.uint8)
    out[..., 1] = np.clip(np.round(uv[..., 0] * 255.0), 0, 255).astype(np.uint8)
    out[..., 2] = np.clip(np.round(uv[..., 1] * 255.0), 0, 255).astype(np.uint8)
    out[parts == 0, 1:] = 0
    return out


def parts_one_hot(parts: np.ndarray, n_parts: int = N_PARTS) -> np.ndarray:
    """(H,W) int -> (H,W,n_parts+1) float32 one-hot (channel 0 = background)."""
    return (parts[..., None] == np.arange(n_parts + 1)).astype(np.float32)


# Horizontal-mirror part permutation (index = original part, value = mirrored
# part). DensePose fine segmentation: 1,2 torso (self-mirror), 3/4 R/L hand,
# 5/6 L/R foot, 7-14 upper/lower legs in R/L back/front pairs, 15-22 upper/
# lower arms in L/R pairs, 23/24 head halves.
PART_MIRROR = np.array([0, 1, 2, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13,
                        16, 15, 18, 17, 20, 19, 22, 21, 24, 23])


def flip_iuv(parts: np.ndarray, uv: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontally mirror a decoded IUV pair: x-flip the maps, swap L/R part
    labels via PART_MIRROR, and mirror the intra-part U coordinate
    (u -> 1-u on body texels)."""
    p = PART_MIRROR[parts[:, ::-1]].astype(np.int32)
    uv2 = uv[:, ::-1].copy()
    body = p > 0
    uv2[..., 0] = np.where(body, 1.0 - uv2[..., 0], 0.0)
    return p, uv2
