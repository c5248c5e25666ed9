"""Generator networks (NCHW shapes, NHWC convs: ``layers.py``):
GlobalGenerator trunk, pix2pixHD's LocalEnhancer (--netG local), TransG,
TexG, BGNet and the feature encoder E.

Port of the JAX package's ``models/generators.py``, every option
included: the ``ms_uv`` aux heads of GlobalGenerator, LocalEnhancer and
``make_backbone``, and TransG's ``uv_refine`` stack.

Outputs:
  TransG:  pose labels -> part logits (B, P+1, H, W), background at 0, and
           per-part UV in [0, 1] as (B, P, 2, H, W) (u then v); with
           ms_uv a third element, ((logits_k, uv_k), ...) at the
           decoder's coarser resolutions.
  TexG:    pose labels -> per-part texture residual (B, P, 3, T, T).
  BGNet:   static background -> refined background in [-1, 1].
  FeatEncoder: a frame -> feat_num feature channels in [-1, 1], which
           part_pool averages per body part (--instance_feat).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (ConvNormRelu, ResnetBlock, Upsample, depth_to_space,
                     conv_input, nchw_float, space_to_depth)


class GlobalGenerator(nn.Module):
    """pix2pixHD GlobalGenerator: c7s1-ngf, n_down x d-stride2, n_blocks x
    ResNet, n_down x u-stride2, c7s1-out.

    stem_s2d packs the input by space-to-depth and starts the encoder that
    many levels down; head_s2d produces the last levels of the decoder as
    a pixel shuffle (the skipped upsamples become stride-1 convs). Both are
    powers of two, clamped to 2**n_downsampling. return_features skips the
    head (and head_s2d) and returns the (B, ngf, H, W) decoder features in
    the model dtype. aux_heads > 0 adds a 3x3 head ``aux_head{i}`` on each
    decoder stage i with n_down-1-aux_heads <= i < n_down-1 (float32
    out_nc maps at that stage's resolution, coarse to fine) and returns
    (out, aux). Submodules are named and numbered per class in creation
    order, as flax names them; the aux heads carry their own names and
    take no number.
    """

    def __init__(self, in_nc: int, out_nc: int, ngf: int = 64,
                 n_downsampling: int = 4, n_blocks: int = 9,
                 final_tanh: bool = True, pad_mode: str = "reflect",
                 upsample_mode: str = "deconv", stem_s2d: int = 1,
                 head_s2d: int = 1, return_features: bool = False,
                 aux_heads: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        s = stem_s2d.bit_length() - 1
        h = 0 if return_features else head_s2d.bit_length() - 1
        if 2 ** s != stem_s2d or (not return_features
                                   and 2 ** h != head_s2d):
            raise ValueError("s2d factors must be powers of two")
        self.s = min(s, n_downsampling)
        self.h = min(h, n_downsampling)
        self.final_tanh = final_tanh
        self.return_features = return_features
        self.aux_heads = aux_heads
        self.dtype = dtype
        self.order = []              # submodule names in call order
        counts = {}

        def add(module: nn.Module, name: str = "") -> None:
            if not name:
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
            if aux_heads and n_downsampling - 1 - aux_heads <= i \
                    < n_downsampling - 1:
                add(ConvNormRelu(ch, out_nc, 3, use_norm=False,
                                 use_relu=False, pad_mode=pad_mode),
                    f"aux_head{i}")
        if not return_features:
            add(ConvNormRelu(ch, out_nc * 4 ** self.h, 7, use_norm=False,
                             use_relu=False, pad_mode=pad_mode))

    def forward(self, x: torch.Tensor):
        x = conv_input(x, self.dtype)
        if self.s:
            x = space_to_depth(x, 2 ** self.s)
        aux = []
        for name in self.order:
            if name.startswith("aux_head"):
                aux.append(nchw_float(getattr(self, name)(x)))
            else:
                x = getattr(self, name)(x)
        if self.return_features:
            return x
        if self.h:
            x = depth_to_space(x, 2 ** self.h)
        x = nchw_float(x)
        out = torch.tanh(x) if self.final_tanh else x
        return (out, tuple(aux)) if self.aux_heads else out


class LocalEnhancer(nn.Module):
    """pix2pixHD's LocalEnhancer (--netG local), coarse to fine: the input
    average-pooled n_local_enhancers times (3x3, stride 2, padding 1,
    counting the padding as flax's avg_pool does), a GlobalGenerator trunk
    ``global_trunk`` of width ngf * 2^n on the coarsest level returning its
    decoder features, then per level l = n..1 a branch on level l-1's input
    (``enh{l}_stem`` 7x7, ``enh{l}_down`` stride 2, plus the coarser
    features, ``enh{l}_block{b}``, ``enh{l}_up``), and the 7x7 ``head``.
    --niter_fix_global freezes the parameters under ``global_trunk``."""

    def __init__(self, in_nc: int, out_nc: int, ngf: int = 32,
                 n_downsample_global: int = 4, n_blocks_global: int = 9,
                 n_local_enhancers: int = 1, n_blocks_local: int = 3,
                 final_tanh: bool = True, pad_mode: str = "reflect",
                 upsample_mode: str = "deconv", stem_s2d: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n = self.n = n_local_enhancers
        self.n_blocks_local = n_blocks_local
        self.final_tanh = final_tanh
        self.dtype = dtype
        self.global_trunk = GlobalGenerator(
            in_nc, out_nc, ngf * 2 ** n, n_downsample_global,
            n_blocks_global, pad_mode=pad_mode, upsample_mode=upsample_mode,
            stem_s2d=stem_s2d, head_s2d=1, return_features=True,
            dtype=dtype)
        for level in range(n, 0, -1):
            ngf_l = ngf * 2 ** (level - 1)
            self.add_module(f"enh{level}_stem", ConvNormRelu(
                in_nc, ngf_l, 7, pad_mode=pad_mode))
            self.add_module(f"enh{level}_down", ConvNormRelu(
                ngf_l, ngf_l * 2, 3, stride=2, pad_mode=pad_mode))
            for b in range(n_blocks_local):
                self.add_module(f"enh{level}_block{b}",
                                ResnetBlock(ngf_l * 2, pad_mode=pad_mode))
            self.add_module(f"enh{level}_up", Upsample(
                ngf_l * 2, ngf_l, mode=upsample_mode, pad_mode=pad_mode))
        self.head = ConvNormRelu(ngf, out_nc, 7, use_norm=False,
                                 use_relu=False, pad_mode=pad_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_input(x, self.dtype)
        pyramid = [x]
        for _ in range(self.n):
            pyramid.append(F.avg_pool2d(pyramid[-1], 3, 2, 1,
                                        count_include_pad=True))
        feat = self.global_trunk(pyramid[-1])
        for level in range(self.n, 0, -1):
            down = getattr(self, f"enh{level}_down")(
                getattr(self, f"enh{level}_stem")(pyramid[level - 1]))
            feat = down + feat
            for b in range(self.n_blocks_local):
                feat = getattr(self, f"enh{level}_block{b}")(feat)
            feat = getattr(self, f"enh{level}_up")(feat)
        out = nchw_float(self.head(feat))
        return torch.tanh(out) if self.final_tanh else out


def make_backbone(netG: str, in_nc: int, out_nc: int, ngf: int,
                  n_downsampling: int, n_blocks: int, *,
                  n_local_enhancers: int = 1, n_blocks_local: int = 3,
                  final_tanh: bool = True, pad_mode: str = "reflect",
                  upsample_mode: str = "deconv", stem_s2d: int = 1,
                  head_s2d: int = 1, aux_heads: int = 0,
                  dtype: torch.dtype = torch.float32) -> nn.Module:
    """pix2pixHD's define_G dispatch: 'global' | 'local'. The aux heads of
    --ms_uv exist for 'global' only, and 'local' has no pixel-shuffle head
    (its trunk returns features), as in the JAX package."""
    if netG == "local":
        if aux_heads:
            raise ValueError("--ms_uv deep supervision is implemented for "
                             "netG=global only")
        return LocalEnhancer(in_nc, out_nc, ngf, n_downsampling, n_blocks,
                             n_local_enhancers, n_blocks_local,
                             final_tanh=final_tanh, pad_mode=pad_mode,
                             upsample_mode=upsample_mode, stem_s2d=stem_s2d,
                             dtype=dtype)
    if netG != "global":
        raise ValueError(f"unknown netG {netG!r} (global|local)")
    return GlobalGenerator(in_nc, out_nc, ngf, n_downsampling, n_blocks,
                           final_tanh=final_tanh, pad_mode=pad_mode,
                           upsample_mode=upsample_mode, stem_s2d=stem_s2d,
                           head_s2d=head_s2d, aux_heads=aux_heads,
                           dtype=dtype)


class _Backbone(nn.Module):
    """Holds its backbone under flax's automatic name for it
    (``GlobalGenerator_0`` or ``LocalEnhancer_0``)."""

    def _set_backbone(self, module: nn.Module) -> None:
        self.backbone_name = f"{type(module).__name__}_0"
        self.add_module(self.backbone_name, module)

    @property
    def backbone(self) -> nn.Module:
        return getattr(self, self.backbone_name)


class TransG(_Backbone):
    """Pose -> IUV: part logits (P+1, background at 0) and per-part UV.
    Raw output channel 25+2p is u_p and 26+2p is v_p (for P=24); UV is
    0.5 * (tanh + 1) in float32.

    uv_refine > 0 adds the refinement stack: the pose and the raw IUV,
    space-to-depth by refine_f (2 for an even frame height, else 1: the
    JAX package picks it from the input's height, the port's modules
    declare their widths up front), ``refine_stem``, uv_refine
    ``refine_block{b}`` and ``refine_head``, whose output, back at full
    resolution, is added to the raw IUV in float32. ms_uv > 0 returns a
    third element: ((logits_k, uv_k), ...) from the backbone's aux heads,
    coarse to fine."""

    def __init__(self, in_nc: int, n_parts: int = 24, ngf: int = 64,
                 n_downsampling: int = 4, n_blocks: int = 9,
                 netG: str = "global", n_local_enhancers: int = 1,
                 n_blocks_local: int = 3, stem_s2d: int = 1,
                 head_s2d: int = 1, uv_refine: int = 0,
                 uv_refine_ngf: int = 64, refine_f: int = 2, ms_uv: int = 0,
                 pad_mode: str = "reflect", upsample_mode: str = "deconv",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_parts = n_parts
        self.uv_refine = uv_refine
        self.refine_f = refine_f
        self.ms_uv = ms_uv
        self.dtype = dtype
        out_nc = (1 + n_parts) + 2 * n_parts
        self._set_backbone(make_backbone(
            netG, in_nc, out_nc, ngf, n_downsampling, n_blocks,
            n_local_enhancers=n_local_enhancers,
            n_blocks_local=n_blocks_local, final_tanh=False,
            pad_mode=pad_mode, upsample_mode=upsample_mode,
            stem_s2d=stem_s2d, head_s2d=head_s2d, aux_heads=ms_uv,
            dtype=dtype))
        if uv_refine > 0:
            f2 = refine_f * refine_f
            self.refine_stem = ConvNormRelu((in_nc + out_nc) * f2,
                                            uv_refine_ngf, 3,
                                            pad_mode=pad_mode)
            for b in range(uv_refine):
                self.add_module(f"refine_block{b}", ResnetBlock(
                    uv_refine_ngf, pad_mode=pad_mode))
            self.refine_head = ConvNormRelu(uv_refine_ngf, out_nc * f2, 3,
                                            use_norm=False, use_relu=False,
                                            pad_mode=pad_mode)

    def _split_iuv(self, raw: torch.Tensor):
        """raw (B, out_nc, h, w) -> (logits (B, P+1, h, w), uv
        (B, P, 2, h, w)): the one place of the IUV channel layout, for the
        full-resolution head and every aux head."""
        B, _, H, W = raw.shape
        uv = 0.5 * (torch.tanh(raw[:, 1 + self.n_parts:]) + 1.0)
        return raw[:, :1 + self.n_parts], uv.view(B, self.n_parts, 2, H, W)

    def forward(self, pose: torch.Tensor):
        raw = self.backbone(pose)
        aux_raw = ()
        if self.ms_uv > 0:
            raw, aux_raw = raw
        if self.uv_refine > 0:
            f = 2 if pose.shape[2] % 2 == 0 else 1
            if f != self.refine_f:
                raise ValueError(f"TransG was built with refine_f "
                                 f"{self.refine_f}; height {pose.shape[2]} "
                                 f"needs {f}")
            x = conv_input(torch.cat([pose, raw], dim=1), self.dtype)
            if f > 1:
                x = space_to_depth(x, f)
            x = self.refine_stem(x)
            for b in range(self.uv_refine):
                x = getattr(self, f"refine_block{b}")(x)
            delta = self.refine_head(x)
            if f > 1:
                delta = depth_to_space(delta, f)
            raw = raw + nchw_float(delta)
        logits, uv = self._split_iuv(raw)
        if self.ms_uv > 0:
            return logits, uv, tuple(self._split_iuv(a) for a in aux_raw)
        return logits, uv


class TexG(_Backbone):
    """Dynamic texture generator, 'part' variant: the pose, resized to the
    tile with an antialiased bilinear filter (== jax.image.resize
    "linear"), through a GlobalGenerator (or, with netG 'local', a
    LocalEnhancer) to a (P*3)-channel map at tile resolution; channel
    p*3 + c is part p's residual for colour c."""

    def __init__(self, in_nc: int, n_parts: int = 24, tile: int = 128,
                 ngf: int = 64, n_downsampling: int = 2, n_blocks: int = 5,
                 netG: str = "global", n_local_enhancers: int = 1,
                 n_blocks_local: int = 3, stem_s2d: int = 1,
                 head_s2d: int = 1, pad_mode: str = "reflect",
                 upsample_mode: str = "deconv",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_parts = n_parts
        self.tile = tile
        self._set_backbone(make_backbone(
            netG, in_nc, n_parts * 3, ngf, n_downsampling, n_blocks,
            n_local_enhancers=n_local_enhancers,
            n_blocks_local=n_blocks_local, final_tanh=True,
            pad_mode=pad_mode, upsample_mode=upsample_mode,
            stem_s2d=stem_s2d, head_s2d=head_s2d, dtype=dtype))

    def forward(self, pose: torch.Tensor) -> torch.Tensor:
        B, _, H, W = pose.shape
        if H != self.tile or W != self.tile:
            pose = F.interpolate(pose.float(), size=(self.tile, self.tile),
                                 mode="bilinear", align_corners=False,
                                 antialias=True)
        out = self.backbone(pose)
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


def region_mean(fmap: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Mean feature per region: fmap (B, F, H, W), onehot (B, C, H, W) ->
    (B, C, F). The one pooling rule: part_pool scatters from it and
    encode_features clusters it."""
    B, C = onehot.shape[:2]
    oh = onehot.reshape(B, C, -1)
    s = torch.bmm(oh, fmap.reshape(B, fmap.shape[1], -1).transpose(1, 2))
    n = oh.sum(2)
    return s / (n[..., None] + 1e-6)


def part_pool(fmap: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Region-wise average pooling (pix2pixHD's encoder semantics): fmap
    (B, F, H, W), onehot (B, C, H, W) -> (B, F, H, W), every pixel the
    mean feature of its region, as products with the one-hot map."""
    B, C, H, W = onehot.shape
    mean = region_mean(fmap, onehot)                        # (B, C, F)
    return torch.bmm(mean.transpose(1, 2),
                     onehot.reshape(B, C, -1)).view(B, -1, H, W)


class FeatEncoder(nn.Module):
    """pix2pixHD's encoder E (--instance_feat / --label_feat): c7s1-nef,
    n_downsampling stride-2 convs, the mirrored upsamples, a c7s1-feat_num
    head with tanh. The renderer pools its output per DensePose body part
    (part_pool): the human-video data has no object-instance maps, so the
    part map takes their place. Submodules carry flax's names
    (ConvNormRelu_0..n+1, Upsample_0..n-1)."""

    def __init__(self, feat_num: int = 3, nef: int = 16,
                 n_downsampling: int = 4, pad_mode: str = "reflect",
                 upsample_mode: str = "deconv",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n = n_downsampling
        self.ConvNormRelu_0 = ConvNormRelu(3, nef, 7, pad_mode=pad_mode)
        for i in range(n_downsampling):
            setattr(self, f"ConvNormRelu_{i + 1}", ConvNormRelu(
                nef * 2 ** i, nef * 2 ** (i + 1), 3, stride=2,
                pad_mode=pad_mode))
        for i in range(n_downsampling):
            setattr(self, f"Upsample_{i}", Upsample(
                nef * 2 ** (n_downsampling - i),
                nef * 2 ** (n_downsampling - i - 1), mode=upsample_mode,
                pad_mode=pad_mode))
        setattr(self, f"ConvNormRelu_{n_downsampling + 1}", ConvNormRelu(
            nef, feat_num, 7, use_norm=False, use_relu=False,
            pad_mode=pad_mode))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = conv_input(img, self.dtype)
        for i in range(self.n + 1):
            x = getattr(self, f"ConvNormRelu_{i}")(x)
        for i in range(self.n):
            x = getattr(self, f"Upsample_{i}")(x)
        x = getattr(self, f"ConvNormRelu_{self.n + 1}")(x)
        return torch.tanh(nchw_float(x))
