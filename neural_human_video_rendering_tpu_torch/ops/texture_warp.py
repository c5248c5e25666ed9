"""Texture-warp dispatch: the renderer's per-part warp + probability blend.

Port of the JAX package's ``ops/pallas_warp.py`` and of the custom VJP of
``ops/pallas_warp2.texture_warp_pallas``. ``texture_warp_planes`` goes
through the kernel wrappers of ``texture_warp_kernel``: on CUDA tensors
they launch the kernels (or raise), on CPU tensors they run their plain
PyTorch versions. There is no other path and no fallback. The TPU path's
pad of sub-128 tiles up to 128 was a Mosaic constraint; the CUDA kernels
sample a T x T tile directly.

Two routes, one launch each (the lossy block_parts cap excepted):
  * no gradient needed (serving, the --temporal_prev fake t-1 render, an
    exported forward): ``texture_warp_topk_fwd`` selects in registers and
    writes no w;
  * otherwise ``TextureWarp``, an autograd Function whose forward is the
    same kernel keeping w for the backward kernel.

``compute_dtype="bfloat16"`` (--warp_dtype) rounds the texture to bf16
once; all sampling and blending math stays float32, as on the TPU, and
the texture's gradient stays float32 (the rounding is passed straight
through, as ``pallas_warp2.py:608`` returns it).
"""

from __future__ import annotations

import torch

from .texture_warp_kernel import (texture_warp_bwd, texture_warp_fwd,
                                  texture_warp_topk_fwd, topk_select)


def _operands(tex, uv, probs, compute_dtype):
    """-> the kernels' float32 texture (bf16-rounded for compute_dtype
    bfloat16, each sample contiguous) and the (B, P, N) views fg =
    probs[:, 1:], u and v of the renderer's tensors."""
    fg = probs[:, 1:].float().flatten(2)
    uv32 = uv.float()
    u = uv32[:, :, 0].flatten(2)
    v = uv32[:, :, 1].flatten(2)
    tex32 = tex.float()
    if compute_dtype == "bfloat16":
        tex32 = tex32.bfloat16().float()
    if not tex32[0].is_contiguous():            # the kernels read tiles
        tex32 = tex32.contiguous()
    return tex32, fg, u, v


def _k(k: int, P: int) -> int:
    return k if 0 < k <= P else P


class TextureWarp(torch.autograd.Function):
    """(tex, uv, probs) -> fg (B, C, H, W), differentiable in all three.

    Forward: the selection (without gradient) and the blended forward in
    one launch that keeps the selected weights w (with the block_parts cap,
    top-k and then the forward); saves tex, the u / v views of uv and w.
    Backward: the backward kernel gives duv (B, P, 2, N) in uv's layout,
    dprobs (B, P+1, N) with a zero background channel (only the parts that
    w kept get a gradient: the selection is stop-gradient) and dtex,
    summed over the batch when the texture came with batch 1."""

    @staticmethod
    def forward(ctx, tex, uv, probs, k, block_parts, eps, compute_dtype):
        B, P, _, H, W = uv.shape
        tex32, fg, u, v = _operands(tex, uv, probs, compute_dtype)
        if 0 < block_parts < P:
            w = topk_select(fg, _k(k, P), block_parts, eps)
            out = texture_warp_fwd(tex32, u, v, w)
        else:
            out, w = texture_warp_topk_fwd(tex32, fg, u, v, _k(k, P), eps,
                                           return_w=True)
        ctx.save_for_backward(tex32, u, v, w)
        ctx.shapes = (B, P, H, W)
        ctx.dtypes = (tex.dtype, uv.dtype, probs.dtype)
        return out.view(B, -1, H, W)

    @staticmethod
    def backward(ctx, g):
        tex32, u, v, w = ctx.saved_tensors
        B, P, H, W = ctx.shapes
        tex_dt, uv_dt, probs_dt = ctx.dtypes
        g = g.float().contiguous().view(B, -1, H * W)
        duv, dprobs, dtex = texture_warp_bwd(tex32, u, v, w, g)
        return (dtex.to(tex_dt), duv.view(B, P, 2, H, W).to(uv_dt),
                dprobs.view(B, P + 1, H, W).to(probs_dt),
                None, None, None, None)


def texture_warp_planes(tex: torch.Tensor, uv: torch.Tensor,
                        probs: torch.Tensor, k: int = 4,
                        block_parts: int = 0, eps: float = 0.0,
                        compute_dtype: str = "float32") -> torch.Tensor:
    """NCHW warp. tex (B or 1, P, C, T, T) in [-1, 1]; uv (B, P, 2, H, W)
    in [0, 1] (u then v per part); probs (B, P+1, H, W) with background at
    channel 0 -> (B, C, H, W) float32, differentiable in tex, uv and probs.

    k in (0, P) samples each pixel's top-k parts (ties widen the set);
    k = 0 or k >= P samples all parts. eps drops blend weights below it;
    block_parts in (0, P) is the lossy per-1024-pixel-block part cap.

    Where a gradient is needed, TextureWarp: one launch that also keeps w
    for the backward, or, with the cap, topk_select and then
    texture_warp_fwd. Where none is (grad mode off, or none of the three
    requires grad), the operators alone, so a traced or exported forward
    holds them as its nodes: one texture_warp_topk_fwd launch that writes
    no w, or, with the cap, topk_select and then texture_warp_fwd.
    """
    B, P, _, H, W = uv.shape
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (tex, uv, probs))
    if needs_grad:
        return TextureWarp.apply(tex, uv, probs, k, block_parts, eps,
                                 compute_dtype)
    tex32, fg, u, v = _operands(tex, uv, probs, compute_dtype)
    if 0 < block_parts < P:
        out = texture_warp_fwd(tex32, u, v,
                               topk_select(fg, _k(k, P), block_parts, eps))
    else:
        out = texture_warp_topk_fwd(tex32, fg, u, v, _k(k, P), eps)
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
