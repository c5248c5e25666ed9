"""Import pix2pixHD PyTorch checkpoints into the port: the port of the JAX
package's ``utils/torch_import.py``.

The reference trains pix2pixHD-lineage generators and saves each subnet's
``state_dict`` as ``{epoch}_net_{label}.pth`` (e.g. ``30_net_TransG.pth``).
``global_generator_state_dict`` maps an ordered pix2pixHD
``GlobalGenerator`` state_dict onto the port's ``GlobalGenerator`` by
execution order, as the JAX package's ``_module_order`` /
``ordered_torch_convs`` / ``convert_global_generator`` do: the stem, the
stride-2 downsamples, two convs per residual block, the transposed-conv
upsamples, the head. Both sides are torch, so the tensors copy as they
are: Conv2d (O, I, kH, kW) and ConvTranspose2d (I, O, kH, kW) are the
port's layouts, and the port's ``ConvTranspose`` under pad_mode reflect is
padding 1, output_padding 1, pix2pixHD's. InstanceNorm2d is affine-free
there: nothing to map.

It needs the parity topology (pad_mode reflect, upsample_mode deconv,
stem_s2d = head_s2d = 1, no aux heads); any other is refused with the
first layer that differs named, as is a checkpoint whose layer count or
shapes differ. ``.npz`` dumps of the same state_dict are read as well.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ..models.generators import GlobalGenerator
from ..models.layers import ConvNormRelu, ResnetBlock, Upsample


def ordered_torch_convs(state_dict) -> List[Tuple[str, torch.Tensor,
                                                  torch.Tensor]]:
    """(name, weight, bias or None) of every 4-D weight, in state_dict
    order (torch state_dicts keep the modules' definition order)."""
    out = []
    for k, v in state_dict.items():
        if not k.endswith(".weight") or v.dim() != 4:
            continue
        out.append((k, v, state_dict.get(k[:-len(".weight")] + ".bias")))
    return out


def _conv_layers(cnr: ConvNormRelu, path: str):
    """A ConvNormRelu as (path, conv), refusing what pix2pixHD does not
    do: a zero-padded stride-1 conv (pad_mode same)."""
    conv = cnr.Conv_0
    if conv.stride == (1, 1) and cnr.pad and not cnr.reflect:
        raise ValueError(f"{path}.Conv_0: zero-padded stride-1 conv "
                         "(pad_mode same); the import needs pix2pixHD's "
                         "topology (pad_mode reflect)")
    return [(f"{path}.Conv_0", conv)]


def module_order(gen: GlobalGenerator, prefix: str = ""
                 ) -> List[Tuple[str, nn.Module]]:
    """The port GlobalGenerator's convs in execution order, (state_dict
    prefix, module); raises ValueError naming the first layer outside the
    parity topology."""
    if not isinstance(gen, GlobalGenerator):
        raise ValueError(f"{prefix or 'module'}: a {type(gen).__name__}; the "
                         "import maps pix2pixHD's GlobalGenerator (--netG "
                         "global)")
    if gen.s or gen.h:
        first = gen.order[0] if gen.s else gen.order[-1]
        raise ValueError(f"{prefix}{first}: space-to-depth by "
                         f"{2 ** (gen.s or gen.h)} (stem_s2d / head_s2d); "
                         "the import needs s2d 1")
    order = []
    for name in gen.order:
        m = getattr(gen, name)
        path = f"{prefix}{name}"
        if name.startswith("aux_head"):
            raise ValueError(f"{path}: an aux head (--ms_uv); pix2pixHD has "
                             "none")
        if isinstance(m, ConvNormRelu):
            order += _conv_layers(m, path)
        elif isinstance(m, ResnetBlock):
            order += _conv_layers(m.ConvNormRelu_0, f"{path}.ConvNormRelu_0")
            order += _conv_layers(m.ConvNormRelu_1, f"{path}.ConvNormRelu_1")
        elif isinstance(m, Upsample):
            if m.mode != "deconv" or m.ConvTranspose_0.same:
                raise ValueError(f"{path}: not pix2pixHD's transposed conv "
                                 "(upsample_mode deconv, pad_mode reflect)")
            order.append((f"{path}.ConvTranspose_0", m.ConvTranspose_0))
        else:
            raise ValueError(f"{path}: unexpected {type(m).__name__}")
    return order


def global_generator_state_dict(state_dict, gen: GlobalGenerator,
                                prefix: str = "") -> Dict[str, torch.Tensor]:
    """A pix2pixHD GlobalGenerator state_dict -> the state_dict of the
    port's `gen` (keys under `prefix`), by execution order. Raises
    ValueError on another topology, another number of conv layers
    ("conv count mismatch") or a shape that differs (the layer and the
    checkpoint's key named)."""
    order = module_order(gen, prefix)
    convs = ordered_torch_convs(state_dict)
    if len(convs) != len(order):
        raise ValueError(
            f"conv count mismatch: checkpoint has {len(convs)} conv layers, "
            f"the target expects {len(order)}: architecture flags differ")
    out = {}
    for (name, w, b), (path, conv) in zip(convs, order):
        if tuple(w.shape) != tuple(conv.weight.shape):
            raise ValueError(f"shape mismatch at {path} <- {name}: "
                             f"{tuple(w.shape)} vs {tuple(conv.weight.shape)}")
        if b is None:
            raise ValueError(f"{name}: the checkpoint has no bias")
        out[f"{path}.weight"] = w.detach().to(torch.float32).clone()
        out[f"{path}.bias"] = b.detach().to(torch.float32).clone()
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A .pth (torch.load, weights only) or .npz state_dict as CPU tensors,
    DataParallel's 'module.' prefixes stripped."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            sd = {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(raw, "state_dict"):
            raw = raw.state_dict()
        sd = {k: torch.as_tensor(v) for k, v in raw.items()}
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def pix2pixhd_global_generator(in_nc: int, out_nc: int, ngf: int = 64,
                               n_downsampling: int = 3, n_blocks: int = 9,
                               final_tanh: bool = True) -> nn.Sequential:
    """pix2pixHD's GlobalGenerator layout in plain torch, the network an
    imported checkpoint comes from: a reflect-padded 7x7 stem, stride-2
    3x3 downsamples (zero padding 1), residual blocks of two
    reflect-padded 3x3 convs, ConvTranspose2d(3, 2, padding 1,
    output_padding 1) upsamples, a reflect-padded 7x7 head; affine-free
    instance norms. For checking an import against its original."""

    class ResnetBlockRef(nn.Module):
        def __init__(self, dim):
            super().__init__()
            self.conv_block = nn.Sequential(
                nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3),
                nn.InstanceNorm2d(dim), nn.ReLU(True),
                nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3),
                nn.InstanceNorm2d(dim))

        def forward(self, x):
            return x + self.conv_block(x)

    layers = [nn.ReflectionPad2d(3), nn.Conv2d(in_nc, ngf, 7),
              nn.InstanceNorm2d(ngf), nn.ReLU(True)]
    for i in range(n_downsampling):
        m = ngf * 2 ** i
        layers += [nn.Conv2d(m, m * 2, 3, stride=2, padding=1),
                   nn.InstanceNorm2d(m * 2), nn.ReLU(True)]
    dim = ngf * 2 ** n_downsampling
    layers += [ResnetBlockRef(dim) for _ in range(n_blocks)]
    for i in range(n_downsampling):
        m = ngf * 2 ** (n_downsampling - i)
        layers += [nn.ConvTranspose2d(m, m // 2, 3, stride=2, padding=1,
                                      output_padding=1),
                   nn.InstanceNorm2d(m // 2), nn.ReLU(True)]
    layers += [nn.ReflectionPad2d(3), nn.Conv2d(ngf, out_nc, 7)]
    if final_tanh:
        layers.append(nn.Tanh())
    return nn.Sequential(*layers)
