"""Conv building blocks: the port of the JAX package's
``models/layers.py``.

pix2pixHD-lineage blocks: reflection- or zero-padded convs, instance norm
without affine, ResNet blocks, 2x upsampling. Parameters stay float32 and
are cast to the activation's dtype at each call, as flax does with
``param_dtype=float32, dtype=bfloat16``. Submodules carry the names flax
gives them (``Conv_0``, ``ConvNormRelu_1``, ...), so a flax parameter tree
maps onto the state_dict by path (``models/bridge.py``).

Shapes are NCHW. On the card the memory layout of the convolutions is
NHWC (``torch.channels_last``), the layout cuDNN runs bf16 convolutions in,
so that it transposes nothing in or out of a conv (``layout``). Each conv's
float32 weight is held channels_last from construction (a state_dict
loads into it in place and keeps the layout; the per-call cast keeps it
too), and each conv makes its input channels_last, a no-op where the op
before it kept the layout, as every op between two convs here does
(InstanceNorm, ReLU, the residual add, zero and reflection padding,
nearest upsampling, the transposed conv's crop, space_to_depth). A
network converts its input once (``conv_input``) and its float32 output
back to NCHW (``nchw_float``), the layout of the warp kernels, the losses
and the compositor. ``conv_counts`` counts the calls and those that found
both operands NHWC already: the layout's engagement (``train/graphs.py``
prints it for each capture).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

NHWC = torch.channels_last
# Conv and ConvTranspose calls, and those whose input and weight arrived
# NHWC, as Python runs them (eagerly, or once while a program is captured:
# a replay runs no Python)
_COUNTS = {"calls": 0, "nhwc": 0}


def conv_counts() -> Tuple[int, int]:
    """(calls whose input and weight were both NHWC, calls) of every Conv
    and ConvTranspose so far in this process."""
    return _COUNTS["nhwc"], _COUNTS["calls"]


def is_nhwc(x: torch.Tensor) -> bool:
    return x.is_contiguous(memory_format=NHWC)


def layout(x: torch.Tensor) -> torch.memory_format:
    """The memory layout of the convs on x's device: NHWC on the card;
    NCHW on the CPU, where oneDNN sums some NHWC convolutions in another
    order than NCHW ones, which would move the CPU's numbers (held against
    the JAX package's by the port's tests) by the last bits."""
    return NHWC if x.is_cuda else torch.contiguous_format


def conv_input(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A network's input in its dtype and the convs' layout: one kernel,
    the cast it needs anyway (none where x is both already)."""
    return x.to(dtype, memory_format=layout(x))


def nchw_float(x: torch.Tensor) -> torch.Tensor:
    """A network's output as float32 NCHW: the cast and the transpose in
    one kernel."""
    return x.to(torch.float32, memory_format=torch.contiguous_format)


def _hold_nhwc(conv: nn.Module) -> None:
    """Lay a conv's weight out channels_last, where it is built (on the
    meta device too: to_empty keeps the strides)."""
    with torch.no_grad():
        conv.weight.data = conv.weight.data.contiguous(memory_format=NHWC)


def _operands(x: torch.Tensor, weight: torch.Tensor):
    """Count a conv call; -> its input and its weight cast to the input's
    dtype, both in the convs' layout (no copy where they are already)."""
    _COUNTS["calls"] += 1
    if is_nhwc(x) and is_nhwc(weight):
        _COUNTS["nhwc"] += 1
    fmt = layout(x)
    return (x.contiguous(memory_format=fmt),
            weight.to(x.dtype, memory_format=fmt))


class Conv(nn.Conv2d):
    """nn.Conv2d whose float32 parameters are cast to the input's dtype;
    the weight held channels_last, both operands in the convs' layout."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _hold_nhwc(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = _operands(x, self.weight)
        return self._conv_forward(x, w, self.bias.to(x.dtype))


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
        _hold_nhwc(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[2], x.shape[3]
        x, w = _operands(x, self.weight)
        y = F.conv_transpose2d(x, w, self.bias.to(x.dtype), stride=2,
                               padding=self.padding,
                               output_padding=self.output_padding)
        return y[:, :, :2 * H, :2 * W] if self.same else y


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> its (B, H*W, C) rows: a view of a channels_last x."""
    B, C, H, W = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, H * W, C)


@functools.lru_cache(maxsize=None)
def _chunk(n: int) -> int:
    """The largest divisor of n that is at most 4096."""
    return next(m for m in range(min(n, 4096), 0, -1) if n % m == 0)


def _sum_rows(t: torch.Tensor) -> torch.Tensor:
    """(B, N, C) float32 -> (B, 1, C), the sum over N: products with a row
    of ones over chunks of at most 4096 rows, then the chunks' sum. On the
    card the GEMV reads the rows at full rate; a reduction along the
    strided axis does not (about 1.5x the time on an H100). The
    products are float32 ones while TF32 stays off for matrix products,
    PyTorch's default, which the port keeps."""
    B, N, C = t.shape
    m = _chunk(N)
    k = N // m
    ones = t.new_ones((1, 1, m)).expand(B * k, 1, m)
    s = torch.bmm(ones, t.reshape(B * k, m, C))
    return s if k == 1 else s.view(B, k, C).sum(1, keepdim=True)


def _nhwc_norm(x: torch.Tensor, eps: float):
    """InstanceNorm's formula on the rows of x -> (y channels_last in x's
    dtype, the float32 rows X, mean, rsqrt(var + eps), E[x^2] - mean^2)."""
    X = _rows(x.float())
    n = X.shape[1]
    mean = _sum_rows(X) / n
    d = _sum_rows(X * X) / n - mean * mean
    r = torch.rsqrt(torch.clamp(d, min=0.0) + eps)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device,
                    memory_format=NHWC)
    torch.mul(X - mean, r, out=_rows(y))
    return y, X, mean, r, d


class _NHWCNorm(torch.autograd.Function):
    """InstanceNorm of a channels_last x with its gradient written out, so
    that its sums over H, W are _sum_rows's too (autograd's backward of
    the formula sums along the strided axis)."""

    @staticmethod
    def forward(ctx, x, eps):
        y, X, mean, r, d = _nhwc_norm(x, eps)
        ctx.save_for_backward(X, mean, r, d)
        ctx.shape, ctx.dtype = x.shape, x.dtype
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        X, mean, r, d = ctx.saved_tensors
        n = X.shape[1]
        G = _rows(gy).float()
        a = _sum_rows(G)
        dr = _sum_rows(G * X) - mean * a           # sum of g (x - mean)
        dv = torch.where(d >= 0, -0.5 * dr * r * r * r, 0.0)  # the clamp
        dm = -r * a - 2.0 * mean * dv              # directly, and via var
        gx = torch.addcmul(dm / n, G, r)
        gx.addcmul_(X, 2.0 * dv / n)               # via E[x^2]
        out = torch.empty(ctx.shape, dtype=ctx.dtype, device=gx.device,
                          memory_format=NHWC)
        _rows(out).copy_(gx)
        return out, None


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over H, W (no affine).
    Statistics in float32 in one pass (E[x], E[x^2], variance clamped at
    0), output in the input's dtype. In the NHWC layout the same formula
    runs over the rows of x, its sums and its gradient's as _sum_rows
    (``_NHWCNorm``); in NCHW as autograd takes it."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if layout(x) == NHWC:
            if torch.is_grad_enabled() and x.requires_grad:
                return _NHWCNorm.apply(x, self.eps)
            return _nhwc_norm(x, self.eps)[0]
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        sqmean = (xf * xf).mean(dim=(2, 3), keepdim=True)
        var = torch.clamp(sqmean - mean * mean, min=0.0)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


def space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, f*f*C, H/f, W/f) with the JAX package's channel
    order fy*f*C + fx*C + c (not pixel_unshuffle's c*f*f + fy*f + fx). A
    channels_last x gives a channels_last result: the JAX package's NHWC
    reshapes over x's NHWC view, one copy."""
    B, C, H, W = x.shape
    if is_nhwc(x):
        x = x.permute(0, 2, 3, 1).reshape(B, H // f, f, W // f, f, C)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(
            B, H // f, W // f, f * f * C).permute(0, 3, 1, 2)
    x = x.reshape(B, C, H // f, f, W // f, f)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(B, f * f * C, H // f, W // f)


def depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    """(B, f*f*C, H, W) -> (B, C, H*f, W*f): inverse of space_to_depth,
    channels_last for a channels_last x as there."""
    B, C4, H, W = x.shape
    c = C4 // (f * f)
    if is_nhwc(x):
        x = x.permute(0, 2, 3, 1).reshape(B, H, W, f, f, c)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(
            B, H * f, W * f, c).permute(0, 3, 1, 2)
    x = x.reshape(B, f, f, c, H, W)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(B, c, H * f, W * f)


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Reflection padding of H and W by p, in x's layout: on the card
    F.pad's 2-D reflection writes NCHW whatever it reads, so a
    channels_last x is padded as the NHWC volume (B, 1, H, W, C) by the
    3-D reflection with no padding of C."""
    if is_nhwc(x) and not x.is_contiguous():
        v = F.pad(x.permute(0, 2, 3, 1).unsqueeze(1), (0, 0, p, p, p, p),
                  mode="reflect")
        return v.squeeze(1).permute(0, 3, 1, 2)
    return F.pad(x, (p,) * 4, mode="reflect")


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
            x = reflect_pad(x, self.pad)
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
            x = self.Conv_0(F.interpolate(x, scale_factor=2,
                                          mode="nearest"))
        else:
            x = self.ConvTranspose_0(x)
        return F.relu(self.norm(x))
