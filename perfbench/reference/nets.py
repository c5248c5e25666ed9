"""The renderer, the discriminator and the VGG loss network in plain
PyTorch, float32, NCHW.

A frozen copy of the port's model arithmetic for the configurations the
benchmark runs (the global generator or, under netG "local", pix2pixHD's
LocalEnhancer of ``local.py``; pose render plus heatmaps and coord conv,
s2d stems and heads; under instance_feat or label_feat pix2pixHD's
feature encoder E of ``feat.py``; no UV refinement, no deep
supervision). Module names follow the port's, so one state_dict
loads into either. Every convolution takes its operands through
``Conv.operand``, and every activation the program keeps in its compute
dtype passes ``act``: float32 as they are, or (``set_precision``) the
float8 control that the benchmark's limits are set against, the
program's bfloat16 with its convolutions lowered to float8 e4m3
operands under a per-tensor scale.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .warp import texture_warp

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to the format's largest, back in float32; the
    gradient passes straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = E4M3_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, back in float32; gradient straight through."""
    return x + (x.detach().bfloat16().float() - x.detach())


# (a convolution's operands, the activations) at each precision. The
# program's bfloat16 keeps every activation in bfloat16 (each conv's
# output, each norm's, the residual sums, the networks' inputs); the
# float8 control lowers its convolutions one step: operands in float8,
# the activations in bfloat16 as the program keeps them
ROUND = {"float32": (None, None), "float8": (fp8_round, bf16_round)}


class _Operands:
    rounding = (None, None)

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        return self.rounding[0](t) if self.rounding[0] is not None else t

    def act(self, t: torch.Tensor) -> torch.Tensor:
        return self.rounding[1](t) if self.rounding[1] is not None else t


class Conv(nn.Conv2d, _Operands):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self._conv_forward(
            self.operand(x), self.operand(self.weight), self.bias))


class ConvTranspose(nn.ConvTranspose2d, _Operands):
    """3x3 stride-2 transposed conv; pad_mode "same" crops to (2H, 2W)."""

    def __init__(self, in_ch: int, out_ch: int, pad_mode: str):
        same = pad_mode != "reflect"
        super().__init__(in_ch, out_ch, 3, stride=2, padding=0 if same else 1,
                         output_padding=0 if same else 1)
        self.same = same

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[2], x.shape[3]
        y = self.act(F.conv_transpose2d(
            self.operand(x), self.operand(self.weight), self.bias, stride=2,
            padding=self.padding, output_padding=self.output_padding))
        return y[:, :, :2 * H, :2 * W] if self.same else y


def set_precision(module: nn.Module, precision: str) -> nn.Module:
    """Every convolution computed at `precision` (ROUND)."""
    for m in module.modules():
        if isinstance(m, _Operands):
            m.rounding = ROUND[precision]
    return module


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """Channel order fy*f*C + fx*C + c."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // f, f, W // f, f)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(B, f * f * C, H // f, W // f)


def depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    B, C4, H, W = x.shape
    c = C4 // (f * f)
    x = x.reshape(B, f, f, c, H, W)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(B, c, H * f, W * f)


class ConvNormRelu(nn.Module, _Operands):
    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, use_norm: bool = True,
                 use_relu: bool = True, pad_mode: str = "reflect"):
        super().__init__()
        pad = kernel // 2
        self.reflect = bool(pad) and pad_mode == "reflect" and stride == 1
        self.pad = pad
        self.Conv_0 = Conv(in_ch, features, kernel, stride=stride,
                           padding=0 if self.reflect else pad)
        self.use_norm = use_norm
        self.use_relu = use_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.reflect:
            x = F.pad(x, (self.pad,) * 4, mode="reflect")
        x = self.Conv_0(x)
        if self.use_norm:
            x = self.act(instance_norm(x))
        return F.relu(x) if self.use_relu else x


class ResnetBlock(nn.Module, _Operands):
    def __init__(self, features: int, pad_mode: str):
        super().__init__()
        self.ConvNormRelu_0 = ConvNormRelu(features, features, 3,
                                           pad_mode=pad_mode)
        self.ConvNormRelu_1 = ConvNormRelu(features, features, 3,
                                           use_relu=False, pad_mode=pad_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(x + self.ConvNormRelu_1(self.ConvNormRelu_0(x)))


class Upsample(nn.Module, _Operands):
    def __init__(self, in_ch: int, features: int, pad_mode: str):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(in_ch, features, pad_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.act(instance_norm(self.ConvTranspose_0(x))))


class GlobalGenerator(nn.Module, _Operands):
    """pix2pixHD's global generator with an s2d stem and a pixel-shuffle
    head; submodules named by class and creation order. return_features
    leaves out the head (and the pixel shuffle) and returns the decoder's
    (B, ngf, H, W) features, as the LocalEnhancer's trunk."""

    def __init__(self, in_nc: int, out_nc: int, ngf: int, n_down: int,
                 n_blocks: int, final_tanh: bool, pad_mode: str,
                 stem_s2d: int, head_s2d: int,
                 return_features: bool = False):
        super().__init__()
        self.s = min(stem_s2d.bit_length() - 1, n_down)
        self.h = 0 if return_features else min(head_s2d.bit_length() - 1,
                                                n_down)
        self.final_tanh = final_tanh
        self.return_features = return_features
        self.order: List[str] = []
        counts: Dict[str, int] = {}

        def add(module: nn.Module) -> None:
            kind = type(module).__name__
            name = f"{kind}_{counts.get(kind, 0)}"
            counts[kind] = counts.get(kind, 0) + 1
            self.add_module(name, module)
            self.order.append(name)

        ch = ngf * 2 ** self.s
        add(ConvNormRelu(in_nc * 4 ** self.s, ch, 7, pad_mode=pad_mode))
        for i in range(self.s, n_down):
            add(ConvNormRelu(ch, ngf * 2 ** (i + 1), 3, stride=2,
                             pad_mode=pad_mode))
            ch = ngf * 2 ** (i + 1)
        for _ in range(n_blocks):
            add(ResnetBlock(ch, pad_mode))
        for i in range(n_down):
            feats = ngf * 2 ** (n_down - i - 1)
            if i < n_down - self.h:
                add(Upsample(ch, feats, pad_mode))
            else:
                add(ConvNormRelu(ch, feats, 3, pad_mode=pad_mode))
            ch = feats
        if not return_features:
            add(ConvNormRelu(ch, out_nc * 4 ** self.h, 7, use_norm=False,
                             use_relu=False, pad_mode=pad_mode))

    @property
    def head(self) -> nn.Module:
        """The output convolution."""
        return getattr(self, self.order[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(x.float())
        if self.s:
            x = space_to_depth(x, 2 ** self.s)
        for name in self.order:
            x = getattr(self, name)(x)
        if self.return_features:
            return x
        if self.h:
            x = depth_to_space(x, 2 ** self.h)
        return torch.tanh(x) if self.final_tanh else x


def make_backbone(cfg, in_nc: int, out_nc: int, ngf: int, n_down: int,
                  n_blocks: int, final_tanh: bool) -> nn.Module:
    """The generator that cfg.netG names, as the port's make_backbone
    builds it: "local" has no pixel-shuffle head."""
    kw = dict(pad_mode=cfg.pad_mode, stem_s2d=cfg.stem_s2d)
    if cfg.netG == "local":
        from .local import LocalEnhancer   # local.py builds on this module
        return LocalEnhancer(in_nc, out_nc, ngf, n_down, n_blocks,
                             cfg.n_local_enhancers, cfg.n_blocks_local,
                             final_tanh, **kw)
    return GlobalGenerator(in_nc, out_nc, ngf, n_down, n_blocks, final_tanh,
                           head_s2d=cfg.head_s2d, **kw)


class _Backbone(nn.Module):
    """Holds its backbone under flax's name for it, ``GlobalGenerator_0``
    or ``LocalEnhancer_0``, as the port's generators do."""

    def _set_backbone(self, module: nn.Module) -> None:
        self.backbone_name = f"{type(module).__name__}_0"
        self.add_module(self.backbone_name, module)

    @property
    def backbone(self) -> nn.Module:
        return getattr(self, self.backbone_name)


class TransG(_Backbone):
    def __init__(self, cfg, in_nc: int, n_parts: int, ngf: int, n_down: int,
                 n_blocks: int):
        super().__init__()
        self.n_parts = n_parts
        self._set_backbone(make_backbone(cfg, in_nc, 1 + 3 * n_parts, ngf,
                                         n_down, n_blocks, False))

    def forward(self, pose: torch.Tensor):
        raw = self.backbone(pose)
        B, _, H, W = raw.shape
        uv = 0.5 * (torch.tanh(raw[:, 1 + self.n_parts:]) + 1.0)
        return raw[:, :1 + self.n_parts], uv.view(B, self.n_parts, 2, H, W)


class TexG(_Backbone):
    def __init__(self, cfg, in_nc: int, n_parts: int, tile: int, ngf: int,
                 n_down: int, n_blocks: int):
        super().__init__()
        self.n_parts, self.tile = n_parts, tile
        self._set_backbone(make_backbone(cfg, in_nc, n_parts * 3, ngf,
                                         n_down, n_blocks, True))

    def forward(self, pose: torch.Tensor) -> torch.Tensor:
        B, _, H, W = pose.shape
        if H != self.tile or W != self.tile:
            pose = F.interpolate(pose, size=(self.tile, self.tile),
                                 mode="bilinear", align_corners=False,
                                 antialias=True)
        out = self.backbone(pose)
        return out.view(B, self.n_parts, 3, self.tile, self.tile)


class BGNet(nn.Module):
    def __init__(self, n_down: int, n_blocks: int, s2d: int, pad_mode: str):
        super().__init__()
        self.GlobalGenerator_0 = GlobalGenerator(
            3, 3, 32, n_down, n_blocks, True, pad_mode=pad_mode,
            stem_s2d=s2d, head_s2d=s2d)

    def forward(self, bg: torch.Tensor) -> torch.Tensor:
        return torch.clamp(bg + self.GlobalGenerator_0(bg), -1.0, 1.0)


class Renderer(nn.Module):
    """pose -> IUV -> warped texture -> composite over the refined
    background. Under cfg.use_feat TexG also takes feat_num channels of
    appearance codes: with a real frame (``feat_image``), E's features
    averaged over each pixel's most probable part; without one, zeros.
    Without E a frame is not used."""

    def __init__(self, cfg):
        super().__init__()
        P = cfg.n_parts
        self.feat_num = cfg.feat_num if cfg.use_feat else 0
        self.TransG = TransG(cfg, cfg.pose_nc, P, cfg.ngf,
                             cfg.n_downsample_translate,
                             cfg.n_blocks_translate)
        self.TexG = TexG(cfg, cfg.pose_nc + self.feat_num, P, cfg.tex_tile,
                         cfg.ngf_global, cfg.n_downsample_global,
                         cfg.n_blocks_global)
        self.BGNet = BGNet(cfg.n_downsample_bg, cfg.n_blocks_bg, cfg.bg_s2d,
                           cfg.pad_mode)
        if cfg.use_feat:
            from .feat import FeatEncoder   # feat.py builds on this module
            self.FeatE = FeatEncoder(cfg.feat_num, cfg.nef,
                                     cfg.n_downsample_E, cfg.pad_mode)
        self.warp = dict(k=cfg.warp_topk, eps=cfg.warp_eps,
                         bf16_texture=cfg.warp_dtype == "bfloat16")

    def codes(self, probs: torch.Tensor,
              feat_image: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, feat_num, H, W) appearance codes for TexG."""
        from .feat import part_pool, regions
        B, _, H, W = probs.shape
        if feat_image is None:
            return probs.new_zeros((B, self.feat_num, H, W))
        return part_pool(self.FeatE(feat_image), regions(probs))

    def forward(self, pose: torch.Tensor, bg: torch.Tensor,
                static_tex: torch.Tensor,
                feat_image: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        B = pose.shape[0]
        logits, uv = self.TransG(pose)
        probs = torch.softmax(logits, dim=1)
        texg_in = pose
        if self.feat_num:
            texg_in = torch.cat([pose, self.codes(probs, feat_image)], dim=1)
        texture = torch.clamp(static_tex + self.TexG(texg_in), -1.0, 1.0)
        fg = texture_warp(texture, uv, probs, **self.warp)
        bg_refined = self.BGNet(bg)
        mask = 1.0 - probs[:, :1]
        fake = mask * fg + (1.0 - mask) * bg_refined
        return {"fake": fake, "mask": mask, "probs": probs,
                "logits": logits, "uv": uv}


class NLayerDiscriminator(nn.Module, _Operands):
    def __init__(self, in_nc: int, size: int, ndf: int, n_layers: int,
                 stem_s2d: int):
        super().__init__()
        f = stem_s2d
        self.s2d = f if f > 1 and size % f == 0 else 1
        if self.s2d > 1:
            k = 4 // f + 1
            lo = (k - 1) // 2
            self.stem_pad = (lo, k - 1 - lo, lo, k - 1 - lo)
            self.Conv_0 = Conv(in_nc * f * f, ndf, k)
        else:
            self.stem_pad = None
            self.Conv_0 = Conv(in_nc, ndf, 4, stride=2, padding=2)
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

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.act(x)
        if self.s2d > 1:
            x = F.pad(space_to_depth(x, self.s2d), self.stem_pad)
        x = F.leaky_relu(self.Conv_0(x), 0.2)
        feats = [x]
        for i in range(1, self.n_layers + 1):
            x = F.leaky_relu(
                self.act(instance_norm(getattr(self, f"Conv_{i}")(x))), 0.2)
            feats.append(x)
        feats.append(getattr(self, f"Conv_{self.n_layers + 1}")(x))
        return feats


class Discriminator(nn.Module):
    """num_D PatchGANs over a 2x average-pool pyramid (the padding counted
    in the divisor)."""

    def __init__(self, cfg):
        super().__init__()
        self.num_D = cfg.num_D
        size = cfg.size
        for d in range(cfg.num_D):
            self.add_module(f"scale_{d}", NLayerDiscriminator(
                cfg.pose_nc + 3, size, cfg.ndf, cfg.n_layers_D,
                cfg.stem_s2d))
            size = (size - 1) // 2 + 1

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        outs = []
        for d in range(self.num_D):
            outs.append(getattr(self, f"scale_{d}")(x))
            if d != self.num_D - 1:
                x = F.avg_pool2d(x, 3, stride=2, padding=1,
                                 count_include_pad=True)
        return outs


VGG_CFG = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))
VGG_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)
VGG_CONVS = 13


class VGG19(nn.Module, _Operands):
    """The five relu_1 taps of VGG19 with block 1 in s2d(2)-packed space
    (its pool a max over the four channel groups)."""

    def __init__(self):
        super().__init__()
        in_ch, i = 12, 0
        for block, (width, n_convs) in enumerate(VGG_CFG):
            out_ch = 4 * width if block == 0 else width
            for _ in range(n_convs):
                if i == VGG_CONVS:
                    break
                self.add_module(f"conv{i}", Conv(in_ch, out_ch, 3, padding=1))
                in_ch, i = out_ch, i + 1
            if block == 0:
                in_ch = width

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = (x + 1.0) * 0.5
        mean = x.new_tensor((0.485, 0.456, 0.406)).view(1, 3, 1, 1)
        std = x.new_tensor((0.229, 0.224, 0.225)).view(1, 3, 1, 1)
        x = space_to_depth(self.act((x - mean) / std), 2)
        x = F.relu(self.conv0(x))
        taps = [x]
        x = F.relu(self.conv1(x))
        w1 = VGG_CFG[0][0]
        x = torch.maximum(x[:, :2 * w1], x[:, 2 * w1:])
        x = torch.maximum(x[:, :w1], x[:, w1:])
        i = 2
        for block, (_, n_convs) in enumerate(VGG_CFG[1:], start=1):
            for c in range(n_convs):
                x = F.relu(getattr(self, f"conv{i}")(x))
                if c == 0:
                    taps.append(x)
                    if block == len(VGG_CFG) - 1:
                        return taps
                i += 1
            x = F.max_pool2d(x, 2, stride=2)
        return taps


def build(cfg, device, vgg: bool = True) -> Dict[str, Optional[nn.Module]]:
    """The three networks of a configuration on `device`, uninitialised
    (load a state_dict)."""
    with torch.device("meta"):
        nets = {"G": Renderer(cfg), "D": Discriminator(cfg),
                "VGG": VGG19() if vgg else None}
    return {k: (None if m is None else m.to_empty(device=device))
            for k, m in nets.items()}
