"""The per-part texture warp and the flow warp in plain PyTorch, float32,
differentiable by autograd: the arithmetic the port's CUDA kernels
compute, written out.

Texture warp: each pixel keeps the parts whose probability is among its k
largest (ties widen the set; the selection carries no gradient) and at
least eps, samples each kept part's tile bilinearly at its (u, v) with
x = u * (T - 1) and taps clamped to the tile, and sums the samples
weighted by the probabilities. Flow warp: out(p) = img(p + flow(p)),
taps clamped to the image, zero where p + flow(p) leaves it.
"""

from __future__ import annotations

import torch


def keep_top(values: torch.Tensor, k: int) -> torch.Tensor:
    """Mask of values >= the k-th largest along dim 1 (ties widen)."""
    remaining = values
    for _ in range(k - 1):
        m = remaining.amax(dim=1, keepdim=True)
        remaining = torch.where(remaining >= m, float("-inf"), remaining)
    return values >= remaining.amax(dim=1, keepdim=True)


def selection(probs: torch.Tensor, k: int, eps: float) -> torch.Tensor:
    """(B, P+1, H, W) probabilities -> (B, P, H*W) mask of the sampled
    (pixel, part) pairs."""
    fg = probs[:, 1:].detach().flatten(2)
    keep = keep_top(fg, k) if 0 < k < fg.shape[1] else torch.ones_like(
        fg, dtype=torch.bool)
    return keep & (fg >= eps) if eps > 0 else keep


def _bilinear(planes: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
              side: int) -> torch.Tensor:
    """planes (B, C, side*side), x, y (B, N) -> (B, C, N)."""
    B, C, _ = planes.shape
    N = x.shape[1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0f)[:, None], (y - y0f)[:, None]
    xi, yi = x0f.long(), y0f.long()
    x0, x1 = xi.clamp(0, side - 1), (xi + 1).clamp(0, side - 1)
    y0, y1 = yi.clamp(0, side - 1), (yi + 1).clamp(0, side - 1)

    def tap(ix, iy):
        return torch.gather(planes, 2, (iy * side + ix)[:, None]
                            .expand(B, C, N))

    top = tap(x0, y0) * (1 - wx) + tap(x1, y0) * wx
    bot = tap(x0, y1) * (1 - wx) + tap(x1, y1) * wx
    return top * (1 - wy) + bot * wy


def texture_warp(tex: torch.Tensor, uv: torch.Tensor, probs: torch.Tensor,
                 k: int = 4, eps: float = 0.0,
                 bf16_texture: bool = False) -> torch.Tensor:
    """tex (B or 1, P, C, T, T), uv (B, P, 2, H, W), probs (B, P+1, H, W)
    -> (B, C, H, W). bf16_texture rounds the texture to bfloat16 once,
    its gradient passed straight through."""
    B, P, _, H, W = uv.shape
    C, T = tex.shape[2], tex.shape[3]
    if bf16_texture:
        tex = tex + (tex.detach().bfloat16().float() - tex.detach())
    tex = tex.expand(B, *tex.shape[1:])
    keep = selection(probs, k, eps)
    w = torch.where(keep, probs[:, 1:].flatten(2), 0.0)
    out = tex.new_zeros((B, C, H * W))
    for p in range(P):
        samp = _bilinear(tex[:, p].reshape(B, C, T * T),
                         uv[:, p, 0].flatten(1) * (T - 1),
                         uv[:, p, 1].flatten(1) * (T - 1), T)
        out = out + samp * w[:, p, None]
    return out.view(B, C, H, W)


def flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """img (B, C, H, W), flow (B, 2, H, W) in pixels (dx, dy)."""
    B, C, H, W = img.shape
    ys = torch.arange(H, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=img.device)[None, :]
    x = (xs + flow[:, 0]).reshape(B, H * W)
    y = (ys + flow[:, 1]).reshape(B, H * W)
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0f)[:, None], (y - y0f)[:, None]
    xi, yi = x0f.long(), y0f.long()
    x0, x1 = xi.clamp(0, W - 1), (xi + 1).clamp(0, W - 1)
    y0, y1 = yi.clamp(0, H - 1), (yi + 1).clamp(0, H - 1)
    flat = img.reshape(B, C, H * W)

    def tap(ix, iy):
        return torch.gather(flat, 2, (iy * W + ix)[:, None].expand(B, C,
                                                                  H * W))

    top = tap(x0, y0) * (1 - wx) + tap(x1, y0) * wx
    bot = tap(x0, y1) * (1 - wx) + tap(x1, y1) * wx
    out = top * (1 - wy) + bot * wy
    inside = ((x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1))[:, None]
    return torch.where(inside, out, 0.0).view(B, C, H, W)
