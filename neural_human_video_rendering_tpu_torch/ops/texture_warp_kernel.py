"""The texture warp's two kernels: top-k part selection and the forward.

Port of the JAX package's ``ops/pallas_warp2.py`` serving half. The CUDA
sources are ``csrc/texture_warp.cu`` (its header note gives the TPU kernel
each one replaces, the memory bound on the H100 and what the design does
about it); they are built by ``ops/build.py`` and called through ctypes.

Each kernel has, in this module:
  * a plain PyTorch version (``topk_select_plain``, ``texture_warp_fwd_plain``)
    computing the same function. The CPU tests use it, and the chip smoke
    test holds the kernel against it on the card;
  * a wrapper (``topk_select``, ``texture_warp_fwd``) that takes the plain
    version only for tensors on the CPU, and for CUDA tensors launches the
    kernel or raises: there is no fallback;
  * a launch counter, ``<wrapper>.launches``, which the wrapper bumps
    where it launches the kernel and nowhere else.

Layout is planes: fg / u / v / w (B, P, N) with N = H*W, texture
(B, P, C, T, T), output (B, C, N). fg, u and v may be strided views (a
batch stride, and for u / v a part stride) whose pixel axis is contiguous.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

CAP_BLOCK = 1024    # pixels per block of the lossy block_parts cap
MAX_PARTS = 32      # the selection kernel holds a pixel's parts in registers
MAX_CHANNELS = 4


# ----------------------------------------------------------------------
# plain PyTorch versions
# ----------------------------------------------------------------------

def _keep_top(values: torch.Tensor, k: int) -> torch.Tensor:
    """Mask of values >= the k-th largest along dim 1: a max/mask loop,
    so ties at the threshold widen the set (never exact-k argmax)."""
    remaining = values
    for _ in range(k - 1):
        m = remaining.amax(dim=1, keepdim=True)
        remaining = torch.where(remaining >= m, float("-inf"), remaining)
    return values >= remaining.amax(dim=1, keepdim=True)


def topk_select_plain(fg: torch.Tensor, k: int, block_parts: int = 0,
                      eps: float = 0.0) -> torch.Tensor:
    """fg (B, P, N) -> w (B, P, N): fg where it is among the pixel's top k
    (ties widen), then 0 below eps; block_parts > 0 also zeroes, per
    (batch, 1024-pixel block), the parts outside the block_parts largest
    summed weights (lossy; N must be a multiple of 1024)."""
    B, P, N = fg.shape
    w = fg
    if k < P:
        w = torch.where(_keep_top(fg, k), fg, 0.0)
    if eps > 0.0:
        w = torch.where(w >= eps, w, 0.0)
    if 0 < block_parts < P:
        blk = w.reshape(B, P, N // CAP_BLOCK, CAP_BLOCK)
        keep = _keep_top(blk.sum(dim=3), block_parts)          # (B, P, NB)
        w = torch.where(keep[..., None], blk, 0.0).reshape(B, P, N)
    return w.contiguous()


def texture_warp_fwd_plain(tex: torch.Tensor, u: torch.Tensor,
                           v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[b, c, n] = sum_p w[b, p, n] * bilinear(tex[b, p, c], u, v) with
    the align_corners mapping x = u * (T - 1), taps clamped to [0, T - 1].
    tex (B or 1, P, C, T, T); u, v, w (B, P, N) -> (B, C, N), parts summed
    in ascending order."""
    B, P, N = w.shape
    C, T = tex.shape[2], tex.shape[3]
    tex = tex.expand(B, *tex.shape[1:])
    out = torch.zeros((B, C, N), dtype=torch.float32, device=w.device)
    for p in range(P):
        x = u[:, p] * (T - 1)
        y = v[:, p] * (T - 1)
        x0f = torch.floor(x)
        y0f = torch.floor(y)
        wx = (x - x0f)[:, None]
        wy = (y - y0f)[:, None]
        xi = x0f.long()
        yi = y0f.long()
        x0, x1 = xi.clamp(0, T - 1), (xi + 1).clamp(0, T - 1)
        y0, y1 = yi.clamp(0, T - 1), (yi + 1).clamp(0, T - 1)
        planes = tex[:, p].reshape(B, C, T * T)

        def tap(ix, iy):
            return torch.gather(planes, 2, (iy * T + ix)[:, None].expand(B, C, N))

        top = tap(x0, y0) * (1 - wx) + tap(x1, y0) * wx
        bot = tap(x0, y1) * (1 - wx) + tap(x1, y1) * wx
        out = out + (top * (1 - wy) + bot * wy) * w[:, p, None]
    return out


# ----------------------------------------------------------------------
# CUDA wrappers
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("texture_warp")
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    lib.nhvr_topk_select.argtypes = [p, i64, p, i32, i32, i32, i32, f32,
                                     i32, p]
    lib.nhvr_topk_select.restype = i32
    lib.nhvr_texture_warp_fwd.argtypes = [p, i64, p, p, i64, i64, p, p,
                                          i32, i32, i32, i32, i32, p]
    lib.nhvr_texture_warp_fwd.restype = i32
    return lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _check_planes(name: str, t: torch.Tensor, B: int, P: int, N: int) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != (B, P, N):
        raise ValueError(f"{name}: expected float32 {(B, P, N)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.stride(2) != 1 or t.stride(1) < N:
        raise ValueError(f"{name}: the pixel axis must be contiguous, "
                         f"got strides {t.stride()}")


def topk_select(fg: torch.Tensor, k: int, block_parts: int = 0,
                eps: float = 0.0) -> torch.Tensor:
    """Top-k part selection (see topk_select_plain). fg (B, P, N) float32
    with a contiguous pixel axis; 1 <= k <= P."""
    B, P, N = fg.shape
    if not 1 <= k <= P:
        raise ValueError(f"k={k} outside [1, P={P}]")
    if 0 < block_parts < P and N % CAP_BLOCK:
        raise ValueError(f"block_parts needs N % {CAP_BLOCK} == 0, N={N}")
    if fg.device.type == "cpu":
        return topk_select_plain(fg.float(), k, block_parts, eps)
    if fg.device.type != "cuda":
        raise ValueError(f"topk_select: unsupported device {fg.device}")
    _check_planes("fg", fg, B, P, N)
    if fg.stride(1) != N:
        raise ValueError(f"fg: parts must be N apart, strides {fg.stride()}")
    if P > MAX_PARTS:
        raise ValueError(f"topk_select kernel takes P <= {MAX_PARTS}, P={P}")
    w = torch.empty((B, P, N), dtype=torch.float32, device=fg.device)
    if w.numel() == 0:
        return w
    stream = torch.cuda.current_stream(fg.device).cuda_stream
    err = _lib().nhvr_topk_select(fg.data_ptr(), fg.stride(0), w.data_ptr(),
                                  B, P, N, k, float(eps), block_parts, stream)
    topk_select.launches += 1
    _check(err, "topk_select")
    return w


topk_select.launches = 0


def texture_warp_fwd(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """Blended bilinear texture warp (see texture_warp_fwd_plain).
    tex (B or 1, P, C, T, T) float32, each sample contiguous; u, v (B, P, N)
    float32 with one stride layout; w (B, P, N) contiguous. -> (B, C, N)."""
    B, P, N = w.shape
    C, T = tex.shape[2], tex.shape[3]
    if tex.dim() != 5 or tex.shape[0] not in (1, B) or tex.shape[1] != P \
            or tex.shape[4] != T or T < 2:
        raise ValueError(f"tex: expected (B|1, {P}, C, T, T), got "
                         f"{tuple(tex.shape)}")
    if w.device.type == "cpu":
        return texture_warp_fwd_plain(tex.float(), u.float(), v.float(),
                                      w.float())
    if w.device.type != "cuda":
        raise ValueError(f"texture_warp_fwd: unsupported device {w.device}")
    for name, t in (("u", u), ("v", v), ("w", w)):
        _check_planes(name, t, B, P, N)
        if t.device != w.device:
            raise ValueError(f"{name} on {t.device}, w on {w.device}")
    if u.stride() != v.stride():
        raise ValueError(f"u and v strides differ: {u.stride()} {v.stride()}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    if tex.dtype != torch.float32 or tex.device != w.device \
            or not tex[0].is_contiguous():
        raise ValueError("tex must be float32 on w's device with each "
                         "sample contiguous")
    if C > MAX_CHANNELS:
        raise ValueError(f"texture_warp_fwd kernel takes C <= {MAX_CHANNELS}")
    out = torch.empty((B, C, N), dtype=torch.float32, device=w.device)
    if out.numel() == 0:
        return out
    tex_bstride = tex.stride(0) if tex.shape[0] == B and B > 1 else 0
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = _lib().nhvr_texture_warp_fwd(
        tex.data_ptr(), tex_bstride, u.data_ptr(), v.data_ptr(), u.stride(0),
        u.stride(1), w.data_ptr(), out.data_ptr(), B, P, C, T, N, stream)
    texture_warp_fwd.launches += 1
    _check(err, "texture_warp_fwd")
    return out


texture_warp_fwd.launches = 0


def reset_launch_counts() -> None:
    topk_select.launches = 0
    texture_warp_fwd.launches = 0
