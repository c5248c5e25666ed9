"""Generator networks in NCHW: GlobalGenerator trunk, TransG, TexG, BGNet.

Port of the JAX package's ``models/generators.py`` for the serving path
(``LocalEnhancer``, ``FeatEncoder``, the ``uv_refine`` head and the
``ms_uv`` aux heads come with later slices).

Outputs:
  TransG:  pose labels -> part logits (B, P+1, H, W), background at 0, and
           per-part UV in [0, 1] as (B, P, 2, H, W) (u then v).
  TexG:    pose labels -> per-part texture residual (B, P, 3, T, T).
  BGNet:   static background -> refined background in [-1, 1].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (ConvNormRelu, ResnetBlock, Upsample, depth_to_space,
                     space_to_depth)


class GlobalGenerator(nn.Module):
    """pix2pixHD GlobalGenerator: c7s1-ngf, n_down x d-stride2, n_blocks x
    ResNet, n_down x u-stride2, c7s1-out.

    stem_s2d packs the input by space-to-depth and starts the encoder that
    many levels down; head_s2d produces the last levels of the decoder as
    a pixel shuffle (the skipped upsamples become stride-1 convs). Both are
    powers of two, clamped to 2**n_downsampling. Submodules are named and
    numbered per class in creation order, as flax names them.
    """

    def __init__(self, in_nc: int, out_nc: int, ngf: int = 64,
                 n_downsampling: int = 4, n_blocks: int = 9,
                 final_tanh: bool = True, pad_mode: str = "reflect",
                 upsample_mode: str = "deconv", stem_s2d: int = 1,
                 head_s2d: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        s = stem_s2d.bit_length() - 1
        h = head_s2d.bit_length() - 1
        if 2 ** s != stem_s2d or 2 ** h != head_s2d:
            raise ValueError("s2d factors must be powers of two")
        self.s = min(s, n_downsampling)
        self.h = min(h, n_downsampling)
        self.final_tanh = final_tanh
        self.dtype = dtype
        self.order = []
        counts = {}

        def add(module: nn.Module) -> None:
            kind = type(module).__name__
            name = f"{kind}_{counts.get(kind, 0)}"
            counts[kind] = counts.get(kind, 0) + 1
            self.add_module(name, module)
            self.order.append(name)

        ch = ngf * 2 ** self.s
        add(ConvNormRelu(in_nc * 4 ** self.s, ch, 7, pad_mode=pad_mode))
        for i in range(self.s, n_downsampling):
            add(ConvNormRelu(ch, ngf * 2 ** (i + 1), 3, stride=2,
                             pad_mode=pad_mode))
            ch = ngf * 2 ** (i + 1)
        for _ in range(n_blocks):
            add(ResnetBlock(ch, pad_mode=pad_mode))
        for i in range(n_downsampling):
            feats = ngf * 2 ** (n_downsampling - i - 1)
            if i < n_downsampling - self.h:
                add(Upsample(ch, feats, mode=upsample_mode, pad_mode=pad_mode))
            else:
                add(ConvNormRelu(ch, feats, 3, pad_mode=pad_mode))
            ch = feats
        add(ConvNormRelu(ch, out_nc * 4 ** self.h, 7, use_norm=False,
                         use_relu=False, pad_mode=pad_mode))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.s:
            x = space_to_depth(x, 2 ** self.s)
        for name in self.order:
            x = getattr(self, name)(x)
        if self.h:
            x = depth_to_space(x, 2 ** self.h)
        x = x.float()
        return torch.tanh(x) if self.final_tanh else x


class TransG(nn.Module):
    """Pose -> IUV: part logits (P+1, background at 0) and per-part UV.
    Raw output channel 25+2p is u_p and 26+2p is v_p (for P=24); UV is
    0.5 * (tanh + 1) in float32."""

    def __init__(self, in_nc: int, n_parts: int = 24, ngf: int = 64,
                 n_downsampling: int = 4, n_blocks: int = 9,
                 stem_s2d: int = 1, head_s2d: int = 1,
                 pad_mode: str = "reflect", upsample_mode: str = "deconv",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_parts = n_parts
        self.GlobalGenerator_0 = GlobalGenerator(
            in_nc, (1 + n_parts) + 2 * n_parts, ngf, n_downsampling,
            n_blocks, final_tanh=False, pad_mode=pad_mode,
            upsample_mode=upsample_mode, stem_s2d=stem_s2d,
            head_s2d=head_s2d, dtype=dtype)

    def forward(self, pose: torch.Tensor):
        raw = self.GlobalGenerator_0(pose)
        B, _, H, W = raw.shape
        logits = raw[:, :1 + self.n_parts]
        uv = 0.5 * (torch.tanh(raw[:, 1 + self.n_parts:]) + 1.0)
        return logits, uv.view(B, self.n_parts, 2, H, W)


class TexG(nn.Module):
    """Dynamic texture generator, 'part' variant: the pose, resized to the
    tile with an antialiased bilinear filter (== jax.image.resize
    "linear"), through a GlobalGenerator to a (P*3)-channel map at tile
    resolution; channel p*3 + c is part p's residual for colour c."""

    def __init__(self, in_nc: int, n_parts: int = 24, tile: int = 128,
                 ngf: int = 64, n_downsampling: int = 2, n_blocks: int = 5,
                 stem_s2d: int = 1, head_s2d: int = 1,
                 pad_mode: str = "reflect", upsample_mode: str = "deconv",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_parts = n_parts
        self.tile = tile
        self.GlobalGenerator_0 = GlobalGenerator(
            in_nc, n_parts * 3, ngf, n_downsampling, n_blocks,
            final_tanh=True, pad_mode=pad_mode, upsample_mode=upsample_mode,
            stem_s2d=stem_s2d, head_s2d=head_s2d, dtype=dtype)

    def forward(self, pose: torch.Tensor) -> torch.Tensor:
        B, _, H, W = pose.shape
        if H != self.tile or W != self.tile:
            pose = F.interpolate(pose.float(), size=(self.tile, self.tile),
                                 mode="bilinear", align_corners=False,
                                 antialias=True)
        out = self.GlobalGenerator_0(pose)
        return out.view(B, self.n_parts, 3, self.tile, self.tile)


class BGNet(nn.Module):
    """Background refinement: clip(bg + GlobalGenerator(bg), -1, 1)."""

    def __init__(self, ngf: int = 32, n_downsampling: int = 2,
                 n_blocks: int = 2, s2d: int = 1, pad_mode: str = "reflect",
                 upsample_mode: str = "deconv",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.GlobalGenerator_0 = GlobalGenerator(
            3, 3, ngf, n_downsampling, n_blocks, final_tanh=True,
            pad_mode=pad_mode, upsample_mode=upsample_mode, stem_s2d=s2d,
            head_s2d=s2d, dtype=dtype)

    def forward(self, bg: torch.Tensor) -> torch.Tensor:
        return torch.clamp(bg + self.GlobalGenerator_0(bg), -1.0, 1.0)
