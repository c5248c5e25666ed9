"""Multiscale PatchGAN discriminators (NCHW shapes, NHWC convs:
``layers.py``): the port of the JAX
package's ``models/discriminator.py``.

pix2pixHD ``MultiscaleDiscriminator`` semantics: num_D PatchGANs on an
average-pool pyramid, every layer's activations returned for the
feature-matching loss, LeakyReLU(0.2), instance norm on the middle layers.
Submodules carry flax's names (``scale_{d}``, ``Conv_{i}``), so the JAX
package's ``d_params`` tree maps onto the state_dict
(``models/bridge.py``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, InstanceNorm, conv_input, space_to_depth


class NLayerDiscriminator(nn.Module):
    """70x70-style PatchGAN: ndf, 2ndf, ... (capped at 512) -> 1-channel
    patch logits.

    stem_s2d > 1 space-to-depth packs the input first and runs the stem as
    a (4/f + 1)-square stride-1 "SAME" conv on the packed grid; the JAX
    package takes that stem only when the scale's input divides by f, so
    the port decides it from the scale's input size at construction. The
    other convs are 4x4 with padding 2: stride 2 down the pyramid, then
    two stride-1 convs that each grow the map by one.
    """

    def __init__(self, in_nc: int, size: int, ndf: int = 64,
                 n_layers: int = 3, stem_s2d: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        f = stem_s2d
        self.s2d = f if f > 1 and size % f == 0 else 1
        if self.s2d > 1:
            k = 4 // f + 1
            lo = (k - 1) // 2
            self.stem_pad = (lo, k - 1 - lo, lo, k - 1 - lo)   # flax SAME
            self.Conv_0 = Conv(in_nc * f * f, ndf, k)
        else:
            self.stem_pad = None
            self.Conv_0 = Conv(in_nc, ndf, 4, stride=2, padding=2)
        self.norms = nn.ModuleList()
        nf, i = ndf, 1
        for _ in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            self.add_module(f"Conv_{i}", Conv(nf_prev, nf, 4, stride=2,
                                              padding=2))
            i += 1
        nf_prev, nf = nf, min(nf * 2, 512)
        self.add_module(f"Conv_{i}", Conv(nf_prev, nf, 4, stride=1, padding=2))
        self.add_module(f"Conv_{i + 1}", Conv(nf, 1, 4, stride=1, padding=2))
        self.n_layers = n_layers
        self.norm = InstanceNorm()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = conv_input(x, self.dtype)
        if self.s2d > 1:
            x = F.pad(space_to_depth(x, self.s2d), self.stem_pad)
        x = F.leaky_relu(self.Conv_0(x), 0.2)
        feats = [x]
        for i in range(1, self.n_layers + 1):
            x = F.leaky_relu(self.norm(getattr(self, f"Conv_{i}")(x)), 0.2)
            feats.append(x)
        feats.append(getattr(self, f"Conv_{self.n_layers + 1}")(x).float())
        return feats


class MultiscaleDiscriminator(nn.Module):
    """num_D PatchGANs over a 2x average-pool pyramid of the input
    (3x3, stride 2, pad 1, the padding counted in the divisor as flax's
    avg_pool counts it). Returns one feature list per scale, logits last."""

    def __init__(self, in_nc: int, size: int, num_D: int = 2, ndf: int = 64,
                 n_layers: int = 3, stem_s2d: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_D = num_D
        for d in range(num_D):
            self.add_module(f"scale_{d}", NLayerDiscriminator(
                in_nc, size, ndf, n_layers, stem_s2d=stem_s2d, dtype=dtype))
            size = (size - 1) // 2 + 1

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        outs = []
        for d in range(self.num_D):
            outs.append(getattr(self, f"scale_{d}")(x))
            if d != self.num_D - 1:
                x = F.avg_pool2d(x, 3, stride=2, padding=1,
                                 count_include_pad=True)
        return outs


def discriminator_from_options(opt) -> MultiscaleDiscriminator:
    """The stage-2 discriminator of --num_D / --ndf / --n_layers_D, its
    stem packed by --stem_s2d, in --dtype; input is the pose labels and a
    frame, concatenated on channels (on the meta device: call
    renderer.init_params, then move it)."""
    dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
    with torch.device("meta"):
        return MultiscaleDiscriminator(
            opt.pose_nc + 3, opt.train_size, num_D=opt.num_D, ndf=opt.ndf,
            n_layers=opt.n_layers_D, stem_s2d=opt.stem_s2d, dtype=dtype)
