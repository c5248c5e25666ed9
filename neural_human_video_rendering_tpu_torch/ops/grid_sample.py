"""Plain PyTorch texture-warp references: the CPU spec of the warp.

Port of the JAX package's ``ops/grid_sample.py`` warp functions, in its
layout: tex (B, P, Ht, Wt, C) in [-1, 1], uv (B, H, W, P, 2) in [0, 1]
(u -> x, v -> y), probs (B, H, W, P+1) with background at channel 0,
result (B, H, W, C). Sample position x = u * (Wt - 1) (align_corners);
taps clamp to the tile's border. ``flow_warp`` belongs to the training
slice.
"""

from __future__ import annotations

import torch


def _bilinear_planes(tex: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """tex (B, P, Ht, Wt, C); x, y (B, P, N) pixel coords -> (B, P, N, C)."""
    B, P, Ht, Wt, C = tex.shape
    N = x.shape[2]
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = (x - x0f)[..., None]
    wy = (y - y0f)[..., None]
    xi, yi = x0f.long(), y0f.long()
    x0, x1 = xi.clamp(0, Wt - 1), (xi + 1).clamp(0, Wt - 1)
    y0, y1 = yi.clamp(0, Ht - 1), (yi + 1).clamp(0, Ht - 1)
    flat = tex.reshape(B, P, Ht * Wt, C)

    def tap(ix, iy):
        idx = (iy * Wt + ix)[..., None].expand(B, P, N, C)
        return torch.gather(flat, 2, idx)

    top = tap(x0, y0) * (1 - wx) + tap(x1, y0) * wx
    bot = tap(x0, y1) * (1 - wx) + tap(x1, y1) * wx
    return top * (1 - wy) + bot * wy


def _planes(a: torch.Tensor) -> torch.Tensor:
    """(B, H, W, P) -> (B, P, H*W)."""
    return a.permute(0, 3, 1, 2).flatten(2)


def texture_warp_reference(tex: torch.Tensor, uv: torch.Tensor,
                           probs: torch.Tensor) -> torch.Tensor:
    """fg = sum_p probs[..., p+1] * tex_p(uv_p) over all P parts."""
    B, P, Ht, Wt, C = tex.shape
    H, W = uv.shape[1], uv.shape[2]
    samples = _bilinear_planes(tex, _planes(uv[..., 0]) * (Wt - 1),
                               _planes(uv[..., 1]) * (Ht - 1))
    w = _planes(probs[..., 1:])[..., None]
    return (samples * w).sum(dim=1).reshape(B, H, W, C)


def texture_warp_topk(tex: torch.Tensor, uv: torch.Tensor, probs: torch.Tensor,
                      k: int = 4, eps: float = 0.0) -> torch.Tensor:
    """Sample only each pixel's top-k parts: exactly k parts by iterative
    argmax (first index wins a tie), weights below eps dropped. k == P
    reproduces texture_warp_reference. (The kernels' selection instead
    keeps every part tied with the k-th largest: see texture_warp_kernel.)
    """
    B, P, Ht, Wt, C = tex.shape
    H, W = uv.shape[1], uv.shape[2]
    fg = _planes(probs[..., 1:])
    u = _planes(uv[..., 0])
    v = _planes(uv[..., 1])
    remaining = fg
    idx_list, w_list = [], []
    for _ in range(k):
        a = torch.argmax(remaining, dim=1, keepdim=True)          # (B,1,N)
        idx_list.append(a)
        w_list.append(torch.gather(remaining, 1, a).clamp(min=0.0))
        remaining = remaining.scatter(1, a, float("-inf"))
    part_idx = torch.cat(idx_list, dim=1)                         # (B,k,N)
    wk = torch.cat(w_list, dim=1)
    if eps > 0.0:
        wk = torch.where(wk >= eps, wk, 0.0)
    tex_k = tex.expand(B, *tex.shape[1:])
    x = torch.gather(u, 1, part_idx) * (Wt - 1)
    y = torch.gather(v, 1, part_idx) * (Ht - 1)
    # sample slot j of pixel n from part part_idx[b, j, n]: gather the taps
    # from a flattened (B, P*Ht*Wt, C) atlas
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0f)[..., None], (y - y0f)[..., None]
    xi, yi = x0f.long(), y0f.long()
    x0, x1 = xi.clamp(0, Wt - 1), (xi + 1).clamp(0, Wt - 1)
    y0, y1 = yi.clamp(0, Ht - 1), (yi + 1).clamp(0, Ht - 1)
    flat = tex_k.reshape(B, P * Ht * Wt, C)
    base = part_idx * (Ht * Wt)

    def tap(ix, iy):
        idx = (base + iy * Wt + ix).reshape(B, -1, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(B, k, -1, C)

    top = tap(x0, y0) * (1 - wx) + tap(x1, y0) * wx
    bot = tap(x0, y1) * (1 - wx) + tap(x1, y1) * wx
    samp = top * (1 - wy) + bot * wy                              # (B,k,N,C)
    return (samp * wk[..., None]).sum(dim=1).reshape(B, H, W, C)
