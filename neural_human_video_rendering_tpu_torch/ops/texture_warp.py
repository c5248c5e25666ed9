"""Texture-warp dispatch: the renderer's per-part warp + probability blend.

Port of the JAX package's ``ops/pallas_warp.py``. Every call goes through
the two kernel wrappers of ``texture_warp_kernel``: on CUDA tensors they
launch the kernels (or raise), on CPU tensors they run their plain
PyTorch versions. There is no other path and no fallback. The TPU path's
pad of sub-128 tiles up to 128 was a Mosaic constraint; the CUDA kernel
samples a T x T tile directly.

``compute_dtype="bfloat16"`` (--warp_dtype) rounds the texture to bf16
once; all sampling and blending math stays float32, as on the TPU.
"""

from __future__ import annotations

import torch

from .texture_warp_kernel import texture_warp_fwd, topk_select


def texture_warp_planes(tex: torch.Tensor, uv: torch.Tensor,
                        probs: torch.Tensor, k: int = 4,
                        block_parts: int = 0, eps: float = 0.0,
                        compute_dtype: str = "float32") -> torch.Tensor:
    """NCHW warp. tex (B or 1, P, C, T, T) in [-1, 1]; uv (B, P, 2, H, W)
    in [0, 1] (u then v per part); probs (B, P+1, H, W) with background at
    channel 0 -> (B, C, H, W) float32.

    k in (0, P) samples each pixel's top-k parts (ties widen the set);
    k = 0 or k >= P samples all parts. eps drops blend weights below it;
    block_parts > 0 is the lossy per-1024-pixel-block part cap.
    """
    B, P = uv.shape[0], uv.shape[1]
    H, W = uv.shape[3], uv.shape[4]
    fg = probs[:, 1:].float().flatten(2)          # (B, P, N) view
    uv = uv.float()
    u = uv[:, :, 0].flatten(2)                    # (B, P, N) strided views
    v = uv[:, :, 1].flatten(2)
    kk = k if 0 < k <= P else P
    w = topk_select(fg, kk, block_parts, eps)
    tex = tex.float()
    if compute_dtype == "bfloat16":
        tex = tex.bfloat16().float()
    out = texture_warp_fwd(tex, u, v, w)
    return out.view(B, -1, H, W)


def texture_warp(tex: torch.Tensor, uv: torch.Tensor, probs: torch.Tensor,
                 k: int = 4, block_parts: int = 0, eps: float = 0.0,
                 compute_dtype: str = "float32") -> torch.Tensor:
    """The JAX package's layout: tex (B, P, T, T, C), uv (B, H, W, P, 2),
    probs (B, H, W, P+1) -> (B, H, W, C). Same semantics as
    texture_warp_planes."""
    tex_p = tex.permute(0, 1, 4, 2, 3).contiguous()
    uv_p = uv.permute(0, 3, 4, 1, 2).contiguous()
    probs_p = probs.permute(0, 3, 1, 2).contiguous()
    out = texture_warp_planes(tex_p, uv_p, probs_p, k, block_parts, eps,
                              compute_dtype)
    return out.permute(0, 2, 3, 1)
