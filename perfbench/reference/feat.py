"""pix2pixHD's instance-level feature encoder E (``--instance_feat``, and
the port's ``--label_feat``, which builds the same) and its per-region
average pooling, in plain PyTorch, float32, NCHW, as the port computes
them.

E: a 7x7 stem of width nef, n_downsample_E stride-2 3x3 convs that
double the width, as many transposed convs that halve it, each followed
by the instance norm and ReLU, then a 7x7 head of feat_num channels
without norm, and tanh. The renderer (``nets.Renderer``) averages E's
output over each region and hands the pooled codes to TexG as feat_num
input channels beside the pose. Submodules carry the port's names and
creation order (``ConvNormRelu_0..n+1``, ``Upsample_0..n-1``), so one
state_dict loads into either.

Where it departs from pix2pixHD (NVIDIA/pix2pixHD ``models/networks.py``
``Encoder``), it follows the port:
  - a region is a DensePose body part (the background one more), the
    argmax of the renderer's own part probabilities, taken without
    gradient, where pix2pixHD pools over the dataset's instance map;
  - the convolutions pad as the configuration's pad_mode says (zeros
    under "same") where pix2pixHD pads the 7x7 ones by reflection;
  - the mean's divisor gets +1e-6, so a region with no pixel has the
    code 0, where pix2pixHD pools only the instances present.
"""

from __future__ import annotations

import torch
from torch import nn

from .nets import ConvNormRelu, Upsample, _Operands


class FeatEncoder(nn.Module, _Operands):
    def __init__(self, feat_num: int, nef: int, n_down: int, pad_mode: str):
        super().__init__()
        self.n = n_down
        self.ConvNormRelu_0 = ConvNormRelu(3, nef, 7, pad_mode=pad_mode)
        for i in range(n_down):
            self.add_module(f"ConvNormRelu_{i + 1}", ConvNormRelu(
                nef * 2 ** i, nef * 2 ** (i + 1), 3, stride=2,
                pad_mode=pad_mode))
        for i in range(n_down):
            self.add_module(f"Upsample_{i}", Upsample(
                nef * 2 ** (n_down - i), nef * 2 ** (n_down - i - 1),
                pad_mode))
        self.add_module(f"ConvNormRelu_{n_down + 1}", ConvNormRelu(
            nef, feat_num, 7, use_norm=False, use_relu=False,
            pad_mode=pad_mode))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.act(img.float())
        for i in range(self.n + 1):
            x = getattr(self, f"ConvNormRelu_{i}")(x)
        for i in range(self.n):
            x = getattr(self, f"Upsample_{i}")(x)
        return torch.tanh(getattr(self, f"ConvNormRelu_{self.n + 1}")(x))


def regions(probs: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) probabilities -> the float32 one-hot of each pixel's
    most probable region, without gradient."""
    best = probs.detach().argmax(dim=1, keepdim=True)
    ids = torch.arange(probs.shape[1], device=probs.device)
    return (best == ids.view(1, -1, 1, 1)).float()


def region_mean(fmap: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """fmap (B, F, H, W), onehot (B, C, H, W) -> (B, C, F) the mean
    feature of each region."""
    total = torch.einsum("bfhw,bchw->bcf", fmap, onehot)
    return total / (onehot.sum(dim=(2, 3))[..., None] + 1e-6)


def part_pool(fmap: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """fmap (B, F, H, W), onehot (B, C, H, W) -> (B, F, H, W): each pixel
    the mean feature of its region."""
    return torch.einsum("bcf,bchw->bfhw", region_mean(fmap, onehot), onehot)
