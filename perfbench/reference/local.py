"""pix2pixHD's LocalEnhancer (``--netG local``) in plain PyTorch, float32,
NCHW, as the port builds it.

Coarse to fine: the input average-pooled ``n_local_enhancers`` times; a
GlobalGenerator trunk ``global_trunk`` of width ngf * 2**n on the
coarsest level that returns its decoder features; then for each level
l = n..1 a branch on level l-1's input: ``enh{l}_stem`` (7x7),
``enh{l}_down`` (stride 2), the coarser features added, the residual
blocks ``enh{l}_block{b}`` and ``enh{l}_up``; last the 7x7 ``head``
without norm or ReLU, and tanh where final_tanh is set. Submodules carry
the port's names and creation order, so one state_dict loads into either.

Where it departs from pix2pixHD (NVIDIA/pix2pixHD ``models/networks.py``
``LocalEnhancer``), it follows the port:
  - the trunk takes the configuration's s2d stem (its first 7x7 conv on
    the input packed by space-to-depth), and keeps no output head;
  - the pooling counts the padding in its divisor (flax's avg_pool);
    pix2pixHD's ``AvgPool2d(3, 2, 1, count_include_pad=False)`` does not;
  - the convolutions pad as the configuration's pad_mode says (zeros
    under "same") where pix2pixHD pads by reflection;
  - the trunk's parameters are never frozen (``niter_fix_global`` 0).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .nets import (ConvNormRelu, GlobalGenerator, ResnetBlock, Upsample,
                   _Operands)


class LocalEnhancer(nn.Module, _Operands):
    def __init__(self, in_nc: int, out_nc: int, ngf: int, n_down: int,
                 n_blocks: int, n_local_enhancers: int, n_blocks_local: int,
                 final_tanh: bool, pad_mode: str, stem_s2d: int):
        super().__init__()
        n = self.n = n_local_enhancers
        self.n_blocks_local = n_blocks_local
        self.final_tanh = final_tanh
        self.global_trunk = GlobalGenerator(
            in_nc, out_nc, ngf * 2 ** n, n_down, n_blocks, False,
            pad_mode=pad_mode, stem_s2d=stem_s2d, head_s2d=1,
            return_features=True)
        for level in range(n, 0, -1):
            ngf_l = ngf * 2 ** (level - 1)
            self.add_module(f"enh{level}_stem", ConvNormRelu(
                in_nc, ngf_l, 7, pad_mode=pad_mode))
            self.add_module(f"enh{level}_down", ConvNormRelu(
                ngf_l, ngf_l * 2, 3, stride=2, pad_mode=pad_mode))
            for b in range(n_blocks_local):
                self.add_module(f"enh{level}_block{b}",
                                ResnetBlock(ngf_l * 2, pad_mode))
            self.add_module(f"enh{level}_up",
                            Upsample(ngf_l * 2, ngf_l, pad_mode))
        self.head = ConvNormRelu(ngf, out_nc, 7, use_norm=False,
                                 use_relu=False, pad_mode=pad_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pyramid = [self.act(x.float())]
        for _ in range(self.n):
            pyramid.append(self.act(F.avg_pool2d(
                pyramid[-1], 3, stride=2, padding=1, count_include_pad=True)))
        feat = self.global_trunk(pyramid[-1])
        for level in range(self.n, 0, -1):
            down = getattr(self, f"enh{level}_down")(
                getattr(self, f"enh{level}_stem")(pyramid[level - 1]))
            feat = self.act(down + feat)
            for b in range(self.n_blocks_local):
                feat = getattr(self, f"enh{level}_block{b}")(feat)
            feat = getattr(self, f"enh{level}_up")(feat)
        out = self.head(feat)
        return torch.tanh(out) if self.final_tanh else out
