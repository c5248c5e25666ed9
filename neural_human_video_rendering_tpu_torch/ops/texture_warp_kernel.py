"""The texture warp's kernels: top-k part selection, the forward (with w
given, or with the selection fused in) and the backward.

Port of the JAX package's ``ops/pallas_warp2.py``. The CUDA sources are
``csrc/texture_warp.cu`` (its header note gives the TPU kernel each one
replaces, the memory bound on the H100 and what the design does about
it); they are built by ``ops/build.py`` and called through ctypes from
the CUDA kernels of torch operators.

Each kernel has, in this module:
  * a plain PyTorch version (``topk_select_plain``, ``texture_warp_fwd_plain``,
    ``texture_warp_bwd_plain``; the fused forward is the first two in a
    row) computing the same function. The CPU tests use it, and the chip
    smoke test holds the kernel against it on the card;
  * an operator of the ``nhvr_torch`` namespace (``torch.ops.nhvr_torch.
    topk_select``, ``texture_warp_fwd``, ``texture_warp_topk_fwd``,
    ``texture_warp_bwd``) whose CPU kernel is the plain version and whose
    CUDA kernel launches the kernel or raises: there is no fallback. The
    operators trace (torch.export, fake tensors) to one node each;
  * a wrapper of the operator's name that checks its arguments and calls
    it;
  * a launch counter, ``<wrapper>.launches``, which the CUDA kernel bumps
    where it launches and nowhere else (never while tracing).

Layout is planes: fg / u / v / w (B, P, N) with N = H*W, texture
(B, P, C, T, T), output (B, C, N). fg, u and v may be strided views (a
batch stride, and for u / v a part stride) whose pixel axis is contiguous.
The backward returns the layouts of the renderer's tensors: duv
(B, P, 2, N) and dprobs (B, P+1, N) with a zero background channel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

CAP_BLOCK = 1024    # pixels per block of the lossy block_parts cap
MAX_PARTS = 32      # the selection kernel holds a pixel's parts in registers
MAX_CHANNELS = 4

# The backward's launch (csrc/texture_warp.cu, texture_warp_bwd_kernel,
# whose kBwdThreads / kWarpWindow these mirror; launch_bwd refuses a plan
# whose shared bytes do not hold that layout): 512 threads a CTA, each
# warp on windows of 128 pixels, shared memory a CTA at most 227 KB on an
# H100, clusters of at most 8 CTAs (the portable size).
BWD_THREADS = 512
BWD_WARP_WINDOW = 128
SMEM_PER_CTA = 232_448
MAX_CLUSTER = 8


class BwdPlan(NamedTuple):
    """How texture_warp_bwd is launched: one cluster of `cluster` CTAs per
    group (a (part, batch), or a part for a batch-1 texture, whose CTAs
    then walk every batch); rank r of a cluster takes the pixels
    [r * chunk, min((r + 1) * chunk, N)) of its group."""
    per_sample: bool    # dtex has the batch axis of w
    groups: int         # clusters
    cluster: int        # CTAs per cluster
    chunk: int          # pixels per CTA, a multiple of 4
    smem: int           # dynamic shared bytes per CTA


@functools.lru_cache(maxsize=None)
def bwd_launch_plan(B: int, tex_batch: int, P: int, C: int, T: int,
                    N: int) -> BwdPlan:
    """The backward's launch plan. Shared memory a CTA: the C x T x T dtex
    tile (rounded up to 4 floats), then for each warp three planes of its
    window and the window's queue. Clusters of 8 CTAs, the portable most,
    unless a group has fewer pixels than 8 CTAs' warps take in one window
    each (then the largest power of two that has them). A group's time is
    its selected pixels over its CTAs, and parts differ in their selected
    pixels by several times, so the clusters are made as wide as the
    portable size allows; the card holds fewer than all of them at once,
    and a waiting cluster starts as soon as one finishes, which takes up
    the slack of the light parts (PERF.md). Raises ValueError where
    the tile does not fit one CTA (C=4 at T=128)."""
    tile4 = -(-C * T * T // 4) * 4
    smem = 4 * (tile4 + (BWD_THREADS // 32) * 4 * BWD_WARP_WINDOW)
    if smem > SMEM_PER_CTA:
        raise ValueError(f"texture_warp_bwd: the C={C} x T={T} dtex tile "
                         f"needs {smem} bytes of shared memory a CTA, "
                         f"more than {SMEM_PER_CTA}")
    per_sample = tex_batch == B and B > 1
    groups = P * (B if per_sample else 1)
    fit = min(MAX_CLUSTER, N // (BWD_THREADS // 32 * BWD_WARP_WINDOW))
    cluster = 1
    while cluster * 2 <= fit:
        cluster *= 2
    chunk = -(-N // cluster)
    chunk = -(-chunk // 4) * 4
    return BwdPlan(per_sample, groups, cluster, chunk, smem)


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


def texture_warp_bwd_plain(tex: torch.Tensor, u: torch.Tensor,
                           v: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """VJP of texture_warp_fwd_plain for the cotangent g (B, C, N), with w
    held constant (the selection is stop-gradient) -> duv (B, P, 2, N),
    dprobs (B, P+1, N) and dtex shaped like tex.

    The formulas of the TPU kernel (pallas_warp2.py:414-436), per part:
    du = sum_c g*w*((v01-v00)(1-wy) + (v11-v10)wy)*(T-1), dv = sum_c
    g*w*(bot-top)*(T-1), dw = sum_c g*samp where w > 0 (else 0), and dtex
    gets g*w times each bilinear weight at the four clamped taps. dprobs
    is dw behind a zero background channel; a batch-1 texture gets the
    sum over the batch."""
    B, P, N = w.shape
    Bt, C, T = tex.shape[0], tex.shape[2], tex.shape[3]
    texb = tex.expand(B, *tex.shape[1:])
    duv = torch.zeros((B, P, 2, N), dtype=torch.float32, device=w.device)
    dprobs = torch.zeros((B, P + 1, N), dtype=torch.float32, device=w.device)
    dtex = torch.zeros((B, P, C, T * T), dtype=torch.float32, device=w.device)
    ext1 = float(T - 1)
    for p in range(P):
        wp = w[:, p, None]
        x = u[:, p] * ext1
        y = v[:, p] * ext1
        x0f = torch.floor(x)
        y0f = torch.floor(y)
        wx = (x - x0f)[:, None]
        wy = (y - y0f)[:, None]
        xi = x0f.long()
        yi = y0f.long()
        x0, x1 = xi.clamp(0, T - 1), (xi + 1).clamp(0, T - 1)
        y0, y1 = yi.clamp(0, T - 1), (yi + 1).clamp(0, T - 1)
        planes = texb[:, p].reshape(B, C, T * T)
        idx = [(iy * T + ix)[:, None].expand(B, C, N)
               for iy, ix in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
        v00, v01, v10, v11 = (torch.gather(planes, 2, i) for i in idx)
        top = v00 * (1 - wx) + v01 * wx
        bot = v10 * (1 - wx) + v11 * wx
        samp = top * (1 - wy) + bot * wy
        gw = g * wp
        duv[:, p, 0] = (gw * ((v01 - v00) * (1 - wy) + (v11 - v10) * wy)
                        * ext1).sum(1)
        duv[:, p, 1] = (gw * (bot - top) * ext1).sum(1)
        dprobs[:, p + 1] = torch.where(w[:, p] > 0, (g * samp).sum(1), 0.0)
        coefs = (gw * (1 - wx) * (1 - wy), gw * wx * (1 - wy),
                 gw * (1 - wx) * wy, gw * wx * wy)
        for i, c in zip(idx, coefs):
            dtex[:, p].scatter_add_(2, i, c)
    dtex = dtex.view(B, P, C, T, T)
    if Bt != B:
        dtex = dtex.sum(0, keepdim=True)
    return duv, dprobs, dtex


# ----------------------------------------------------------------------
# the kernels as torch operators
# ----------------------------------------------------------------------
#
# Each kernel is an operator of the ``nhvr_torch`` namespace
# (torch.library.custom_op): its CPU kernel is the plain version, its CUDA
# kernel the launch below, and a fake kernel gives the output shapes to
# torch.export and the other tracers (a traced or exported program holds
# the operator, and a program loaded from disk needs this module imported
# before it runs). No other device has a kernel. Outputs are fresh
# tensors, never views of the inputs.

NAMESPACE = "nhvr_torch"


def _fresh(t: torch.Tensor, *inputs: torch.Tensor) -> torch.Tensor:
    """t, copied where it shares storage with an input."""
    ptr = t.untyped_storage().data_ptr()
    if any(ptr == i.untyped_storage().data_ptr() for i in inputs):
        return t.clone()
    return t


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("texture_warp")
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    lib.nhvr_topk_select.argtypes = [p, i64, p, i32, i32, i32, i32, f32,
                                     i32, p]
    lib.nhvr_topk_select.restype = i32
    lib.nhvr_texture_warp_fwd.argtypes = [p, i64, p, p, i64, i64, p, p, p,
                                          i32, i32, i32, i32, i32, p]
    lib.nhvr_texture_warp_fwd.restype = i32
    lib.nhvr_texture_warp_topk_fwd.argtypes = [p, i64, p, p, i64, i64, p, i64,
                                               p, p, p, i32, i32, i32, i32,
                                               i32, i32, f32, p]
    lib.nhvr_texture_warp_topk_fwd.restype = i32
    lib.nhvr_texture_warp_bwd.argtypes = [p, i64, p, p, i64, i64, p, p, p, p,
                                          i64, i64, p, i64, p, p, i64, p,
                                          i32, i32, i32, i32, i32, i32, i32,
                                          i32, i32, i32, p]
    lib.nhvr_texture_warp_bwd.restype = i32
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


def _check_device(name: str, t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def _check_tex(tex: torch.Tensor, B: int, P: int):
    """-> (C, T) of a (B or 1, P, C, T, T) texture."""
    if tex.dim() != 5 or tex.shape[0] not in (1, B) or tex.shape[1] != P \
            or tex.shape[4] != tex.shape[3] or tex.shape[3] < 2:
        raise ValueError(f"tex: expected (B|1, {P}, C, T, T), got "
                         f"{tuple(tex.shape)}")
    return tex.shape[2], tex.shape[3]


def _check_cuda_warp(name: str, tex, u, v, w, sel: str = "w") -> None:
    """What the forward and backward kernels take on the card. w is the
    selection (contiguous) or, for sel="fg", the fg view (parts N apart)."""
    B, P, N = w.shape
    for tname, t in (("u", u), ("v", v), (sel, w)):
        _check_planes(tname, t, B, P, N)
        if t.device != w.device:
            raise ValueError(f"{tname} on {t.device}, {sel} on {w.device}")
    if u.stride() != v.stride():
        raise ValueError(f"u and v strides differ: {u.stride()} {v.stride()}")
    if sel == "w" and not w.is_contiguous():
        raise ValueError("w must be contiguous")
    if w.stride(1) != N:
        raise ValueError(f"{sel}: parts must be N apart, strides {w.stride()}")
    if tex.dtype != torch.float32 or tex.device != w.device \
            or not tex[0].is_contiguous():
        raise ValueError(f"tex must be float32 on {sel}'s device with each "
                         "sample contiguous")
    if tex.shape[2] > MAX_CHANNELS:
        raise ValueError(f"{name} kernel takes C <= {MAX_CHANNELS}")


def _fwd_texture(tex: torch.Tensor, B: int):
    """-> (tex_bstride, tex4): the texture's batch stride for the forward
    kernels (0 for one texture shared by every batch) and the scratch of
    its texel-major copy, (B or 1, P, T*T, 4) float32."""
    P, T = tex.shape[1], tex.shape[3]
    tex_bstride = tex.stride(0) if tex.shape[0] == B and B > 1 else 0
    groups = B if tex_bstride else 1
    tex4 = torch.empty((groups, P, T * T, 4), dtype=torch.float32,
                       device=tex.device)
    return tex_bstride, tex4


# ---- topk_select

@torch.library.custom_op(
    f"{NAMESPACE}::topk_select", mutates_args=(), device_types="cpu",
    schema="(Tensor fg, int k, int block_parts, float eps) -> Tensor")
def _topk_select_op(fg, k, block_parts, eps):
    return _fresh(topk_select_plain(fg, k, block_parts, eps), fg)


@_topk_select_op.register_kernel("cuda")
def _topk_select_cuda(fg, k, block_parts, eps):
    B, P, N = fg.shape
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


@_topk_select_op.register_fake
def _(fg, k, block_parts, eps):
    return fg.new_empty(fg.shape, dtype=torch.float32)


def topk_select(fg: torch.Tensor, k: int, block_parts: int = 0,
                eps: float = 0.0) -> torch.Tensor:
    """Top-k part selection (see topk_select_plain), the operator
    ``nhvr_torch::topk_select``. fg (B, P, N) float32 with a contiguous
    pixel axis (on the card: parts N apart, P <= 32); 1 <= k <= P."""
    B, P, N = fg.shape
    if not 1 <= k <= P:
        raise ValueError(f"k={k} outside [1, P={P}]")
    if 0 < block_parts < P and N % CAP_BLOCK:
        raise ValueError(f"block_parts needs N % {CAP_BLOCK} == 0, N={N}")
    _check_device("topk_select", fg)
    if fg.device.type == "cpu":
        fg = fg.float()
    return _topk_select_op(fg, k, block_parts, float(eps))


topk_select.launches = 0


# ---- texture_warp_fwd (w given)

@torch.library.custom_op(
    f"{NAMESPACE}::texture_warp_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor tex, Tensor u, Tensor v, Tensor w) -> Tensor")
def _texture_warp_fwd_op(tex, u, v, w):
    return texture_warp_fwd_plain(tex, u, v, w)


@_texture_warp_fwd_op.register_kernel("cuda")
def _texture_warp_fwd_cuda(tex, u, v, w):
    B, P, N = w.shape
    C, T = tex.shape[2], tex.shape[3]
    _check_cuda_warp("texture_warp_fwd", tex, u, v, w)
    if P > MAX_PARTS:
        raise ValueError(f"texture_warp_fwd kernel takes P <= {MAX_PARTS}")
    out = torch.empty((B, C, N), dtype=torch.float32, device=w.device)
    if out.numel() == 0:
        return out
    tex_bstride, tex4 = _fwd_texture(tex, B)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = _lib().nhvr_texture_warp_fwd(
        tex.data_ptr(), tex_bstride, u.data_ptr(), v.data_ptr(), u.stride(0),
        u.stride(1), w.data_ptr(), out.data_ptr(), tex4.data_ptr(), B, P, C,
        T, N, stream)
    texture_warp_fwd.launches += 1
    _check(err, "texture_warp_fwd")
    return out


@_texture_warp_fwd_op.register_fake
def _(tex, u, v, w):
    return w.new_empty((w.shape[0], tex.shape[2], w.shape[2]),
                       dtype=torch.float32)


def texture_warp_fwd(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """Blended bilinear texture warp (see texture_warp_fwd_plain), the
    operator ``nhvr_torch::texture_warp_fwd``. tex (B or 1, P, C, T, T)
    float32, each sample contiguous; u, v (B, P, N) float32 with one stride
    layout; w (B, P, N) contiguous. -> (B, C, N). The kernel takes P <= 32,
    C <= 4. It is the block_parts route's forward: the others select
    inside texture_warp_topk_fwd."""
    B, P, N = w.shape
    _check_tex(tex, B, P)
    _check_device("texture_warp_fwd", w)
    if w.device.type == "cpu":
        tex, u, v, w = tex.float(), u.float(), v.float(), w.float()
    return _texture_warp_fwd_op(tex, u, v, w)


texture_warp_fwd.launches = 0


# ---- texture_warp_topk_fwd (the selection fused in)

@torch.library.custom_op(
    f"{NAMESPACE}::texture_warp_topk_fwd", mutates_args=(),
    device_types="cpu",
    schema="(Tensor tex, Tensor fg, Tensor u, Tensor v, int k, float eps, "
           "bool return_w) -> (Tensor, Tensor)")
def _texture_warp_topk_fwd_op(tex, fg, u, v, k, eps, return_w):
    w = topk_select_plain(fg, k, 0, eps)
    out = texture_warp_fwd_plain(tex, u, v, w)
    w = _fresh(w, fg) if return_w else fg.new_empty((0,))
    return out, w


@_texture_warp_topk_fwd_op.register_kernel("cuda")
def _texture_warp_topk_fwd_cuda(tex, fg, u, v, k, eps, return_w):
    B, P, N = fg.shape
    C, T = tex.shape[2], tex.shape[3]
    _check_cuda_warp("texture_warp_topk_fwd", tex, u, v, fg, sel="fg")
    out = torch.empty((B, C, N), dtype=torch.float32, device=fg.device)
    w = torch.empty((B, P, N) if return_w else (0,), dtype=torch.float32,
                    device=fg.device)
    if out.numel() == 0:
        return out, w
    tex_bstride, tex4 = _fwd_texture(tex, B)
    stream = torch.cuda.current_stream(fg.device).cuda_stream
    err = _lib().nhvr_texture_warp_topk_fwd(
        tex.data_ptr(), tex_bstride, u.data_ptr(), v.data_ptr(), u.stride(0),
        u.stride(1), fg.data_ptr(), fg.stride(0),
        w.data_ptr() if return_w else None, out.data_ptr(), tex4.data_ptr(),
        B, P, C, T, N, k, float(eps), stream)
    texture_warp_topk_fwd.launches += 1
    _check(err, "texture_warp_topk_fwd")
    return out, w


@_texture_warp_topk_fwd_op.register_fake
def _(tex, fg, u, v, k, eps, return_w):
    B, P, N = fg.shape
    return (fg.new_empty((B, tex.shape[2], N), dtype=torch.float32),
            fg.new_empty((B, P, N) if return_w else (0,),
                         dtype=torch.float32))


def texture_warp_topk_fwd(tex: torch.Tensor, fg: torch.Tensor,
                          u: torch.Tensor, v: torch.Tensor, k: int,
                          eps: float = 0.0, return_w: bool = False):
    """The selection fused into the forward: texture_warp_fwd(tex, u, v,
    topk_select(fg, k, 0, eps)) in one launch that keeps w in registers;
    the operator ``nhvr_torch::texture_warp_topk_fwd``, which returns
    (out, w) with an empty w unless return_w. fg (B, P, N) float32 with
    parts N apart and a contiguous pixel axis (the view probs[:, 1:]); the
    rest as texture_warp_fwd's. -> out (B, C, N); with return_w, (out, w),
    w written by the same launch and bit-identical to topk_select's.
    1 <= k <= P <= 32 and C <= 4 on every device (the kernel's limits)."""
    B, P, N = fg.shape
    C, T = _check_tex(tex, B, P)
    if not 1 <= k <= P:
        raise ValueError(f"k={k} outside [1, P={P}]")
    if P > MAX_PARTS or C > MAX_CHANNELS:
        raise ValueError(f"texture_warp_topk_fwd takes P <= {MAX_PARTS} and "
                         f"C <= {MAX_CHANNELS}, got P={P}, C={C}")
    _check_device("texture_warp_topk_fwd", fg)
    if fg.device.type == "cpu":
        tex, fg, u, v = tex.float(), fg.float(), u.float(), v.float()
    out, w = _texture_warp_topk_fwd_op(tex, fg, u, v, k, float(eps),
                                       bool(return_w))
    return (out, w) if return_w else out


texture_warp_topk_fwd.launches = 0


# ---- texture_warp_bwd

@torch.library.custom_op(
    f"{NAMESPACE}::texture_warp_bwd", mutates_args=(), device_types="cpu",
    schema="(Tensor tex, Tensor u, Tensor v, Tensor w, Tensor g) "
           "-> (Tensor, Tensor, Tensor)")
def _texture_warp_bwd_op(tex, u, v, w, g):
    return texture_warp_bwd_plain(tex, u, v, w, g)


@_texture_warp_bwd_op.register_kernel("cuda")
def _texture_warp_bwd_cuda(tex, u, v, w, g):
    B, P, N = w.shape
    C, T = tex.shape[2], tex.shape[3]
    _check_cuda_warp("texture_warp_bwd", tex, u, v, w)
    if g.dtype != torch.float32 or g.device != w.device \
            or not g.is_contiguous():
        raise ValueError("g must be float32 and contiguous on w's device")
    duv = torch.empty((B, P, 2, N), dtype=torch.float32, device=w.device)
    dprobs = torch.empty((B, P + 1, N), dtype=torch.float32, device=w.device)
    dtex = torch.empty(tex.shape, dtype=torch.float32, device=w.device)
    if w.numel() == 0:
        return duv, dprobs, dtex
    plan = bwd_launch_plan(B, tex.shape[0], P, C, T, N)
    tex4 = torch.empty((plan.groups, T * T, 4), dtype=torch.float32,
                       device=w.device)
    tex_bstride = tex.stride(0) if plan.per_sample else 0
    dtex_bstride = dtex.stride(0) if plan.per_sample else 0
    vec = (N % 4 == 0 and u.stride(0) % 4 == 0 and u.stride(1) % 4 == 0
           and all(t.data_ptr() % 16 == 0 for t in (w, u, v)))
    duv_p, dprobs_p = duv.data_ptr(), dprobs.data_ptr()
    err = _lib().nhvr_texture_warp_bwd(
        tex.data_ptr(), tex_bstride, u.data_ptr(), v.data_ptr(), u.stride(0),
        u.stride(1), w.data_ptr(), g.data_ptr(), duv_p, duv_p + 4 * N,
        2 * P * N, 2 * N, dprobs_p + 4 * N, (P + 1) * N, dprobs_p,
        dtex.data_ptr(), dtex_bstride, tex4.data_ptr(), B, P, C, T, N,
        plan.cluster,
        plan.chunk, plan.smem, plan.per_sample, vec,
        torch.cuda.current_stream(w.device).cuda_stream)
    texture_warp_bwd.launches += 1
    _check(err, "texture_warp_bwd")
    return duv, dprobs, dtex


@_texture_warp_bwd_op.register_fake
def _(tex, u, v, w, g):
    B, P, N = w.shape
    return (w.new_empty((B, P, 2, N), dtype=torch.float32),
            w.new_empty((B, P + 1, N), dtype=torch.float32),
            tex.new_empty(tex.shape, dtype=torch.float32))


def texture_warp_bwd(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, g: torch.Tensor):
    """Backward of the blended warp (see texture_warp_bwd_plain), the
    operator ``nhvr_torch::texture_warp_bwd``. Inputs as
    texture_warp_fwd's, g (B, C, N) float32 contiguous -> duv (B, P, 2, N),
    dprobs (B, P+1, N) and dtex shaped like tex, all fresh and contiguous.
    On the card the kernel writes every element of the three (no memset),
    in one launch planned by bwd_launch_plan; dtex is summed with shared
    float atomics, so its last bits vary from run to run."""
    B, P, N = w.shape
    C, T = _check_tex(tex, B, P)
    if tuple(g.shape) != (B, C, N):
        raise ValueError(f"g: expected {(B, C, N)}, got {tuple(g.shape)}")
    _check_device("texture_warp_bwd", w)
    if w.device.type == "cpu":
        tex, u, v, w, g = tex.float(), u.float(), v.float(), w.float(), \
            g.float()
    return _texture_warp_bwd_op(tex, u, v, w, g)


texture_warp_bwd.launches = 0


def reset_launch_counts() -> None:
    topk_select.launches = 0
    texture_warp_fwd.launches = 0
    texture_warp_topk_fwd.launches = 0
    texture_warp_bwd.launches = 0
