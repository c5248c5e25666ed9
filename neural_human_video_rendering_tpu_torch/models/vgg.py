"""VGG19 feature extractor for the perceptual loss (NCHW shapes, NHWC
convs: ``layers.py``): the port of
the JAX package's ``models/vgg.py``.

The pix2pixHD tap points (relu1_1, relu2_1, relu3_1, relu4_1, relu5_1)
with loss weights [1/32, 1/16, 1/8, 1/4, 1]. Block 1 runs in
space-to-depth-packed space exactly as the JAX module does: its two convs
are 3x3 convs on the s2d(2) grid (12 -> 256 and 256 -> 256 channels), its
tap is compared packed, and its 2x2 max pool is a max over the four
channel groups. Random-feature weights are initialised in that packed
space, so they cannot be unpacked into a plain VGG (a pretrained
torchvision VGG19 is packed by ``pack_conv_weights``). The convs are named
``conv{i}`` as flax names them, so the JAX package's VGG tree maps onto
the state_dict (``models/bridge.py``).

Weights: a torchvision ``vgg19`` state_dict saved as .npz or .pth at
$VGG19_WEIGHTS (or the path given), else a seeded random init of the
port's own (not the JAX package's numbers: bridge those across).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, conv_input, space_to_depth

# convs per block for VGG19; taps after the first conv+relu of each block
_CFG = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))
FEATURE_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)

# torchvision `features` indices of conv layers, in order
_TV_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34)
_N_CONVS = 13     # convs up to relu5_1, the deepest tap


class VGG19Features(nn.Module):
    """(B, 3, H, W) in [-1, 1] (H, W even) -> the 5 tap activations, in
    float32; the convs run in ``dtype`` with float32 parameters."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        in_ch, i = 3 * 4, 0
        for block, (width, n_convs) in enumerate(_CFG):
            out_ch = 4 * width if block == 0 else width
            for c in range(n_convs):
                if i == _N_CONVS:
                    break
                self.add_module(f"conv{i}", Conv(in_ch, out_ch, 3, padding=1))
                in_ch, i = out_ch, i + 1
            if block == 0:
                in_ch = width
        self._norm = {}                     # ImageNet mean and std by device

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = (x.float() + 1.0) * 0.5
        if x.device not in self._norm:     # made once per device, no copy
            self._norm[x.device] = tuple(
                torch.tensor(v, device=x.device).view(1, 3, 1, 1)
                for v in ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)))
        mean, std = self._norm[x.device]
        x = conv_input((x - mean) / std, self.dtype)
        x = space_to_depth(x, 2)
        taps = []
        x = F.relu(self.conv0(x))
        taps.append(x.float())
        x = F.relu(self.conv1(x))
        # packed 2x2-pixel max pool: a max over the 4 channel groups
        w1 = _CFG[0][0]
        x = torch.maximum(x[:, :2 * w1], x[:, 2 * w1:])
        x = torch.maximum(x[:, :w1], x[:, w1:])
        i = 2
        for block, (_, n_convs) in enumerate(_CFG[1:], start=1):
            for c in range(n_convs):
                x = F.relu(getattr(self, f"conv{i}")(x))
                if c == 0:
                    taps.append(x.float())
                    if block == len(_CFG) - 1:
                        return taps      # relu5_1 is the deepest tap used
                i += 1
            x = F.max_pool2d(x, 2, stride=2)
        return taps


def pack_conv_weights(w: np.ndarray, b: np.ndarray, f: int = 2):
    """Exact weight transform: a 3x3 SAME conv on the original grid -> a
    3x3 SAME conv on the space_to_depth(f) grid (flax HWIO layout; a copy
    of the JAX package's vgg.pack_conv_weights). Packed channel order
    k = row_offset * (f*C) + col_offset * C + c."""
    K = w.shape[0]
    if K != 3 or w.shape[1] != 3:
        raise ValueError("transform written for 3x3 convs")
    Cin, Cout = w.shape[2], w.shape[3]
    wp = np.zeros((3, 3, f * f * Cin, f * f * Cout), w.dtype)
    for m in range(f):
        for n in range(f):
            out_sl = slice(m * f * Cout + n * Cout,
                           m * f * Cout + (n + 1) * Cout)
            for dy in range(K):
                a, i = divmod(m + dy - 1, f)
                for dx in range(K):
                    bb, j = divmod(n + dx - 1, f)
                    in_sl = slice(i * f * Cin + j * Cin,
                                  i * f * Cin + (j + 1) * Cin)
                    wp[a + 1, bb + 1, in_sl, out_sl] += w[dy, dx]
    return wp, np.tile(b, f * f)


def load_pretrained(path: str) -> dict:
    """A torchvision vgg19 state_dict (.npz arrays under
    ``features.{i}.weight`` / ``.bias``, or a .pth / .pt file) -> the
    state_dict of VGG19Features, block 1 packed."""
    if path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        arrays = {k: v.numpy() for k, v in sd.items()}
    else:
        arrays = dict(np.load(path))
    out = {}
    for conv_i, tv_i in enumerate(_TV_CONV_IDX[:_N_CONVS]):
        w = arrays[f"features.{tv_i}.weight"]          # OIHW
        b = arrays[f"features.{tv_i}.bias"]
        if conv_i < _CFG[0][1]:
            k, b = pack_conv_weights(np.transpose(w, (2, 3, 1, 0)), b, 2)
            w = np.transpose(k, (3, 2, 0, 1))
        out[f"conv{conv_i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w, np.float32))
        out[f"conv{conv_i}.bias"] = torch.from_numpy(
            np.ascontiguousarray(b, np.float32))
    return out


def build_vgg(seed: int = 0, weights_path: str = "",
              dtype: torch.dtype = torch.bfloat16) -> VGG19Features:
    """The loss network on the CPU: pretrained weights if a file is given
    or at $VGG19_WEIGHTS, else seeded random features (flax's default
    conv init, from torch.Generator(seed))."""
    from .renderer import init_params
    with torch.device("meta"):
        vgg = VGG19Features(dtype=dtype)
    vgg = init_params(vgg, seed)
    path = weights_path or os.environ.get("VGG19_WEIGHTS", "")
    if path and os.path.exists(path):
        vgg.load_state_dict(load_pretrained(path))
    return vgg.requires_grad_(False)
