"""LPIPS perceptual metric (Zhang et al. 2018) over the port's VGG: the
port of the JAX package's ``utils/lpips.py``.

    d(x, y) = sum_l mean_hw || w_l (.) (f_l(x) / |f_l(x)| - f_l(y) / |f_l(y)|) ||_2^2

The taps are ``models.vgg.VGG19Features``' (relu{1..5}_1, widths 64, 128,
256, 512, 512: the official VGG head's widths, so its file loads as it
is). The linear head is an official LPIPS checkpoint (``.pth`` of the
lpips package, keys ``lin{i}.model.1.weight`` of shape (1, C, 1, 1), or
``.npz`` with arrays ``lin{i}``) from the path given or $LPIPS_WEIGHTS,
else the uniform head 1/C_l (the paper's unweighted baseline).

Tap 0 arrives space-to-depth packed in NCHW: (B, 4 * 64, H/2, W/2), the
channel of pixel offset (m, n) and feature c at k = m*(2*64) + n*64 + c
(``models/vgg.pack_conv_weights``). LPIPS normalises each original
pixel's feature vector, so the tap is viewed as (B, 4, 64, H/2, W/2) and
normalised over the 64 axis; normalising over all 256 channels would mix
four pixels and still give a plausible number.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.vgg import _CFG

# channel width of each tap (relu{1..5}_1)
TAP_WIDTHS = tuple(width for width, _ in _CFG)
_EPS = 1e-10


def normalize_tap(x: torch.Tensor, width: int) -> torch.Tensor:
    """Unit-normalise the feature vector of every pixel of an NCHW tap.
    A packed tap (channels a multiple of ``width``) is viewed as
    (B, groups, width, H, W) and each group normalised on its own."""
    x = x.float()
    if x.shape[1] != width:
        x = x.view(x.shape[0], x.shape[1] // width, width, *x.shape[2:])
    axis = 1 if x.dim() == 4 else 2
    return x / torch.sqrt((x * x).sum(axis, keepdim=True) + _EPS)


def uniform_lin_weights() -> List[np.ndarray]:
    """The weight-free head: 1/C per channel of each tap."""
    return [np.full((c,), 1.0 / c, np.float32) for c in TAP_WIDTHS]


def load_lin_weights(path: str) -> List[np.ndarray]:
    """An official LPIPS linear head: .pth / .pt (the lpips package's
    state_dict) or .npz (``lin{i}`` arrays of shape (C,)). Negative
    entries are clamped to 0, as the official code does when scoring; a
    head of another width than a tap's raises ValueError."""
    if path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        lins = [sd[f"lin{i}.model.1.weight"].float().numpy().reshape(-1)
                for i in range(len(TAP_WIDTHS))]
    else:
        with np.load(path) as arrays:
            lins = [np.asarray(arrays[f"lin{i}"]).reshape(-1)
                    for i in range(len(TAP_WIDTHS))]
    for i, (w, c) in enumerate(zip(lins, TAP_WIDTHS)):
        if w.shape[0] != c:
            raise ValueError(
                f"lin{i} has {w.shape[0]} channels, tap expects {c}")
    return [np.maximum(w.astype(np.float32), 0.0) for w in lins]


def get_lin_weights(path: str = "") -> List[np.ndarray]:
    """The head of ``path`` or $LPIPS_WEIGHTS where that file exists, else
    the uniform head."""
    path = path or os.environ.get("LPIPS_WEIGHTS", "")
    if path and os.path.exists(path):
        return load_lin_weights(path)
    return uniform_lin_weights()


def lpips_taps(fa: Sequence[torch.Tensor], fb: Sequence[torch.Tensor],
               lin_weights: Optional[Sequence] = None) -> torch.Tensor:
    """(B,) LPIPS of two images' VGG taps (NCHW, float32)."""
    if lin_weights is None:
        lin_weights = uniform_lin_weights()
    d = 0.0
    for w, width, x, y in zip(lin_weights, TAP_WIDTHS, fa, fb):
        diff = normalize_tap(x, width) - normalize_tap(y, width)
        # w (.) diff^2 summed over the channels, averaged over space (and
        # over tap 0's pixel groups, which are space too)
        wt = torch.as_tensor(np.asarray(w, np.float32), device=diff.device)
        shape = [1] * diff.dim()
        shape[1 if diff.dim() == 4 else 2] = -1
        per_loc = (wt.view(shape) * diff * diff).sum(1 if diff.dim() == 4
                                                     else 2)
        d = d + per_loc.flatten(1).mean(1)
    return d


def lpips_distance(vgg, a: torch.Tensor, b: torch.Tensor,
                   lin_weights: Optional[Sequence] = None,
                   per_sample: bool = False) -> torch.Tensor:
    """LPIPS between image batches (B, 3, H, W) in [-1, 1]: (B,) with
    ``per_sample``, else their mean. ``vgg`` is a models.vgg.VGG19Features
    (bfloat16, as the JAX package runs it); ``lin_weights`` the five
    per-channel heads (get_lin_weights()), uniform when None."""
    d = lpips_taps(vgg(a), vgg(b), lin_weights)
    return d if per_sample else d.mean()
