"""The flagship composed model: pose -> IUV -> textured foreground -> frame.

Port of the JAX package's ``models/renderer.py``: TransG + TexG + the
static texture atlas + the texture warp (the CUDA kernels of
``ops/texture_warp_kernel``) + BGNet + the soft-mask compositor, and with
--instance_feat / --label_feat the encoder E (``FeatE``), whose features,
averaged per predicted body part, join TexG's input. Every model option
of the JAX package: --netG local (TransG and TexG as LocalEnhancers),
--uv_refine, --ms_uv (``out["ms_aux"]``, train-time only; serving ignores
it) and the per-sample mirrored background of flip augmentation
(``bg_flip``). Parameters live under the ``TransG`` / ``TexG`` /
``BGNet`` / ``FeatE`` namespaces, as in the JAX package. Tensors are
NCHW.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..ops.texture_warp import texture_warp_planes
from .generators import BGNet, FeatEncoder, TexG, TransG, part_pool


class NeuralRenderer(nn.Module):
    """Full generator stack of the serving path."""

    def __init__(self, pose_nc: int, n_parts: int = 24, tex_tile: int = 128,
                 transg_ngf: int = 64, transg_downs: int = 4,
                 transg_blocks: int = 9, texg_ngf: int = 48,
                 texg_downs: int = 2, texg_blocks: int = 10,
                 bg_downs: int = 2, bg_blocks: int = 2,
                 use_mask_texture: bool = False, warp_k: int = 4,
                 warp_block_parts: int = 0, warp_eps: float = 1e-3,
                 warp_dtype: str = "float32", stem_s2d: int = 1,
                 head_s2d: int = 1, bg_s2d: int = 1,
                 pad_mode: str = "reflect", upsample_mode: str = "deconv",
                 use_feat: bool = False, feat_num: int = 3, nef: int = 16,
                 n_downsample_E: int = 4, netG: str = "global",
                 n_local_enhancers: int = 1, n_blocks_local: int = 3,
                 uv_refine: int = 0, uv_refine_ngf: int = 64,
                 refine_f: int = 2, ms_uv: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = dict(pad_mode=pad_mode, upsample_mode=upsample_mode,
                    dtype=dtype)
        gen = dict(netG=netG, n_local_enhancers=n_local_enhancers,
                   n_blocks_local=n_blocks_local, stem_s2d=stem_s2d,
                   head_s2d=head_s2d, **conv)
        self.TransG = TransG(pose_nc, n_parts, transg_ngf, transg_downs,
                             transg_blocks, uv_refine=uv_refine,
                             uv_refine_ngf=uv_refine_ngf, refine_f=refine_f,
                             ms_uv=ms_uv, **gen)
        # flax infers TexG's input width; here it is declared: the pose
        # labels, plus E's feat_num pooled channels under use_feat
        self.TexG = TexG(pose_nc + (feat_num if use_feat else 0), n_parts,
                         tex_tile, texg_ngf, texg_downs, texg_blocks, **gen)
        self.BGNet = BGNet(32, bg_downs, bg_blocks, s2d=bg_s2d, **conv)
        self.use_feat = use_feat
        self.feat_num = feat_num
        if use_feat:
            self.FeatE = FeatEncoder(feat_num, nef, n_downsample_E, **conv)
        self.use_mask_texture = use_mask_texture
        self.warp = dict(k=warp_k, block_parts=warp_block_parts, eps=warp_eps,
                         compute_dtype=warp_dtype)

    def forward(self, pose: torch.Tensor, bg: torch.Tensor,
                static_tex: torch.Tensor,
                tex_mask: Optional[torch.Tensor] = None,
                feat_image: Optional[torch.Tensor] = None,
                cluster_feats: Optional[torch.Tensor] = None,
                bg_flip: Optional[torch.Tensor] = None
                ) -> Dict[str, object]:
        """Render one batch of frames.

        pose: (B, Cp, H, W) pose labels. bg: (B or 1, 3, H, W) static
        background in [-1, 1]; batch 1 runs BGNet once and broadcasts.
        static_tex: (B or 1, P, 3, T, T) atlas in [-1, 1]. tex_mask:
        optional (P, 1, T, T) texel validity mask (--use_mask_texture).
        Under use_feat, TexG also takes feat_num channels of appearance
        codes, one code per predicted body part (the argmax of probs, a
        selection without gradient):
          * feat_image (B, 3, H, W), a real frame (training, held-out
            eval): E encodes it and part_pool averages E's features per
            part; E is differentiated;
          * cluster_feats (P+1, feat_num) codes per part (inference with
            --load_features): the part one-hot times the codes;
          * neither: zero codes, and E does not run.
        bg_flip: optional (B,) float flags of flip augmentation: a sample
        with flag 1 composites against the refined background mirrored
        along the width (a per-sample blend, so the batch-1 background
        still runs BGNet once).

        Returns float32 NCHW tensors: fake, fg, mask (B, 1, H, W), probs
        (B, P+1, H, W), logits, uv (B, P, 2, H, W), texture
        (B, P, 3, T, T), bg_refined; with ms_uv also ms_aux, TransG's
        ((logits_k, uv_k), ...) at the decoder's coarser resolutions.
        """
        B = pose.shape[0]
        logits, uv, *ms_aux = self.TransG(pose)
        probs = torch.softmax(logits.float(), dim=1)
        texg_in = pose
        if self.use_feat:
            texg_in = torch.cat([pose, self._codes(probs, feat_image,
                                                   cluster_feats)], dim=1)
        residual = self.TexG(texg_in)
        if self.use_mask_texture and tex_mask is not None:
            residual = residual * tex_mask
        texture = torch.clamp(static_tex + residual, -1.0, 1.0)
        if texture.shape[0] != B:
            texture = texture.expand(B, *texture.shape[1:])
        fg = texture_warp_planes(texture, uv, probs, **self.warp)
        bg_refined = self.BGNet(bg)
        if bg_flip is not None:
            flag = bg_flip.reshape(-1, 1, 1, 1).to(bg_refined.dtype)
            bg_refined = (flag * bg_refined.flip(3)
                          + (1.0 - flag) * bg_refined)
        mask = 1.0 - probs[:, :1]
        fake = mask * fg + (1.0 - mask) * bg_refined
        out = {"fake": fake, "fg": fg, "mask": mask, "probs": probs,
               "logits": logits, "uv": uv, "texture": texture,
               "bg_refined": bg_refined}
        if ms_aux:
            out["ms_aux"] = ms_aux[0]
        return out

    def _codes(self, probs: torch.Tensor, feat_image, cluster_feats
               ) -> torch.Tensor:
        """(B, feat_num, H, W) float32 appearance codes for TexG."""
        B, C, H, W = probs.shape
        if feat_image is None and cluster_feats is None:
            return probs.new_zeros((B, self.feat_num, H, W))
        onehot = torch.zeros_like(probs).scatter_(
            1, probs.detach().argmax(1, keepdim=True), 1.0)
        if feat_image is not None:
            return part_pool(self.FeatE(feat_image), onehot)
        codes = cluster_feats.to(device=probs.device, dtype=torch.float32)
        return torch.einsum("bchw,cf->bfhw", onehot, codes)


def renderer_from_options(opt) -> NeuralRenderer:
    """The flagship model from the reference-compatible Options (on the
    meta device: call init_params, then move it)."""
    dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
    with torch.device("meta"):
        return NeuralRenderer(
            pose_nc=opt.pose_nc, n_parts=opt.n_parts, tex_tile=opt.tex_tile,
            transg_ngf=opt.ngf, transg_downs=opt.n_downsample_translate,
            transg_blocks=opt.n_blocks_translate, texg_ngf=opt.ngf_global,
            texg_downs=opt.n_downsample_global,
            texg_blocks=opt.n_blocks_global, bg_downs=opt.n_downsample_bg,
            bg_blocks=opt.n_blocks_bg, use_mask_texture=opt.use_mask_texture,
            warp_k=opt.warp_topk, warp_block_parts=opt.warp_block_parts,
            warp_eps=opt.warp_eps, warp_dtype=opt.warp_dtype,
            stem_s2d=opt.stem_s2d, head_s2d=opt.head_s2d, bg_s2d=opt.bg_s2d,
            pad_mode=opt.pad_mode, upsample_mode=opt.upsample_mode,
            use_feat=opt.instance_feat or opt.label_feat,
            feat_num=opt.feat_num, nef=opt.nef,
            n_downsample_E=opt.n_downsample_E, netG=opt.netG,
            n_local_enhancers=opt.n_local_enhancers,
            n_blocks_local=opt.n_blocks_local, uv_refine=opt.uv_refine,
            uv_refine_ngf=opt.uv_refine_ngf,
            refine_f=2 if opt.train_size % 2 == 0 else 1, ms_uv=opt.ms_uv,
            dtype=dtype)


def init_params(model: nn.Module, seed: int) -> nn.Module:
    """Materialize a meta-device model on the CPU with flax's default init
    from a seeded torch.Generator: conv kernels lecun_normal (truncated
    normal, variance 1/fan_in), biases zero. Same distribution as the JAX
    package's init; not the same numbers (use bridge.params_from_jax to
    carry JAX weights across)."""
    gen = torch.Generator().manual_seed(seed)
    model.to_empty(device="cpu")
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            # fan_in of the flax kernel: kh * kw * in_channels
            in_ch = (m.weight.shape[0] if isinstance(m, nn.ConvTranspose2d)
                     else m.weight.shape[1])
            fan_in = in_ch * m.weight.shape[2] * m.weight.shape[3]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            # drawn in logical order, then copied into the weight's
            # layout (channels_last): the same numbers in any layout
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=gen)
            with torch.no_grad():
                m.weight.copy_(w)
                m.bias.zero_()
    return model
