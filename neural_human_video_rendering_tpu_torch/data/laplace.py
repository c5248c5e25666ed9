"""LaplaceProj 3D pose-label loading: a copy of the JAX package's
``data/laplace.py``, decoding through ``utils/image``.

The reference optionally concatenates precomputed 3D pose-label images
("LaplaceProj", arXiv:2003.13510) with the 2D pose input when
``--use_laplace`` / ``--pose_plus_laplace``. They are per-frame image files
(or .npy arrays) in a directory; this loader reads, resizes and normalizes
them to [-1, 1] float32 channels that FrameDataset adds to a sample and
the inference driver loads per batch; ``train/steps.build_pose_input``
appends them to the pose input (``laplace_nc_eff`` of them: 78 under the
texture pretrain's --input_nc 81 contract, laplace_nc otherwise).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..utils.image import read_image, resize

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".npy")


def list_frames(d: str) -> List[str]:
    return sorted(f for f in os.listdir(d) if f.lower().endswith(IMG_EXTS))


def load_laplace(path: str, size: int, channels: int = 3) -> np.ndarray:
    """Load one LaplaceProj frame -> (size, size, channels) float32 in [-1,1].

    size=0 keeps the file's native resolution. A grayscale file may
    broadcast to up to 3 channels; any other mismatch with the configured
    channel count raises.
    """
    if path.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
    else:
        arr = read_image(path, "unchanged")
        if arr.ndim == 2:
            arr = arr[..., None]
        elif arr.shape[-1] >= 3:
            arr = arr[..., :3]
        arr = arr.astype(np.float32) / 255.0 * 2.0 - 1.0
    if arr.shape[-1] == 1 and channels <= 3:
        arr = np.repeat(arr, channels, axis=-1)
    if arr.shape[-1] != channels:
        raise ValueError(
            f"LaplaceProj channel mismatch: {path} has {arr.shape[-1]} "
            f"channels, config demands {channels} (laplace_nc / the "
            f"--input_nc 81 contract = 3 pose + input_nc-3 Laplace channels)")
    if size and (arr.shape[0] != size or arr.shape[1] != size):
        arr = resize(arr, (size, size), "linear")
        if arr.ndim == 2:
            arr = arr[..., None]
    return arr.astype(np.float32)
