"""Conv building blocks in NCHW: the port of the JAX package's
``models/layers.py``.

pix2pixHD-lineage blocks: reflection- or zero-padded convs, instance norm
without affine, ResNet blocks, 2x upsampling. Parameters stay float32 and
are cast to the activation's dtype at each call, as flax does with
``param_dtype=float32, dtype=bfloat16``. Submodules carry the names flax
gives them (``Conv_0``, ``ConvNormRelu_1``, ...), so a flax parameter tree
maps onto the state_dict by path (``models/bridge.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Conv(nn.Conv2d):
    """nn.Conv2d whose float32 parameters are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype))


class ConvTranspose(nn.ConvTranspose2d):
    """3x3 stride-2 transposed conv with flax's alignment.

    pad_mode "reflect": flax padding ((1, 2), (1, 2)) == torch padding 1,
    output_padding 1. pad_mode "same": flax "SAME" == torch padding 0,
    cropped to (2H, 2W). The weight is (in, out, 3, 3) with flax's kernel
    flipped in both spatial axes (bridge.py does the flip).
    """

    def __init__(self, in_ch: int, out_ch: int, pad_mode: str):
        same = pad_mode != "reflect"
        super().__init__(in_ch, out_ch, 3, stride=2, padding=0 if same else 1,
                         output_padding=0 if same else 1)
        self.same = same

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[2], x.shape[3]
        y = F.conv_transpose2d(x, self.weight.to(x.dtype),
                               self.bias.to(x.dtype), stride=2,
                               padding=self.padding,
                               output_padding=self.output_padding)
        return y[:, :, :2 * H, :2 * W] if self.same else y


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over H, W (no affine).
    Statistics in float32 in one pass (E[x], E[x^2], variance clamped at
    0), output in the input's dtype."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        sqmean = (xf * xf).mean(dim=(2, 3), keepdim=True)
        var = torch.clamp(sqmean - mean * mean, min=0.0)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


def space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, f*f*C, H/f, W/f) with the JAX package's channel
    order fy*f*C + fx*C + c (not pixel_unshuffle's c*f*f + fy*f + fx)."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // f, f, W // f, f)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(B, f * f * C, H // f, W // f)


def depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    """(B, f*f*C, H, W) -> (B, C, H*f, W*f): inverse of space_to_depth."""
    B, C4, H, W = x.shape
    c = C4 // (f * f)
    x = x.reshape(B, f, f, c, H, W)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(B, c, H * f, W * f)


class ConvNormRelu(nn.Module):
    """Pad -> Conv -> InstanceNorm -> ReLU. pad_mode "reflect" reflects
    only stride-1 convs (pix2pixHD's stride-2 convs are zero-padded);
    "same" zero-pads every conv."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, pad: Optional[int] = None,
                 use_norm: bool = True, use_relu: bool = True,
                 pad_mode: str = "reflect"):
        super().__init__()
        pad = kernel // 2 if pad is None else pad
        self.reflect = bool(pad) and pad_mode == "reflect" and stride == 1
        self.pad = pad
        self.Conv_0 = Conv(in_ch, features, kernel, stride=stride,
                           padding=0 if self.reflect else pad)
        self.norm = InstanceNorm() if use_norm else None
        self.use_relu = use_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.reflect:
            x = F.pad(x, (self.pad,) * 4, mode="reflect")
        x = self.Conv_0(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.relu(x) if self.use_relu else x


class ResnetBlock(nn.Module):
    """pix2pixHD ResnetBlock: two padded 3x3 convs with a skip."""

    def __init__(self, features: int, pad_mode: str = "reflect"):
        super().__init__()
        self.ConvNormRelu_0 = ConvNormRelu(features, features, 3,
                                           pad_mode=pad_mode)
        self.ConvNormRelu_1 = ConvNormRelu(features, features, 3,
                                           use_relu=False, pad_mode=pad_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.ConvNormRelu_1(self.ConvNormRelu_0(x))


class Upsample(nn.Module):
    """2x upsampling decoder stage, then InstanceNorm and ReLU.
    mode "deconv": stride-2 transposed conv (flax alignment per pad_mode).
    mode "resize": nearest 2x repeat + zero-padded 3x3 conv."""

    def __init__(self, in_ch: int, features: int, mode: str = "deconv",
                 pad_mode: str = "reflect"):
        super().__init__()
        self.mode = mode
        if mode == "resize":
            self.Conv_0 = Conv(in_ch, features, 3, padding=1)
        else:
            self.ConvTranspose_0 = ConvTranspose(in_ch, features, pad_mode)
        self.norm = InstanceNorm()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "resize":
            x = self.Conv_0(x.repeat_interleave(2, dim=2)
                            .repeat_interleave(2, dim=3))
        else:
            x = self.ConvTranspose_0(x)
        return F.relu(self.norm(x))
