"""The flow warp's kernel: whole-image bilinear warp by a flow field.

Port of the JAX package's ``ops/pallas_flow_warp.py``. The CUDA source is
``csrc/flow_warp.cu`` (its header note gives the TPU kernel it replaces,
the memory bound on the H100 and what the design does about it); it is
built by ``ops/build.py`` and called through ctypes from the CUDA kernel
of a torch operator.

As for every kernel of the port, this module holds:
  * the plain PyTorch version, ``flow_warp_fwd_plain`` (``grid_sample.
    flow_warp``): the CPU tests use it, and the chip smoke test holds the
    kernel against it on the card;
  * the operator ``torch.ops.nhvr_torch.flow_warp_fwd``: its CPU kernel is
    the plain version, its CUDA kernel launches the kernel or raises, and
    a fake kernel gives its shape to tracers;
  * the wrapper ``flow_warp_fwd``, which checks its arguments and calls
    the operator;
  * the launch counter ``flow_warp_fwd.launches``, bumped where the CUDA
    kernel launches and nowhere else.

``FlowWarp`` is the differentiable op: its forward is the wrapper, its
backward the VJP of the plain version, recomputed (the JAX package has no
backward kernel either: pallas_flow_warp.py:177-181).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .grid_sample import flow_warp as flow_warp_fwd_plain
from .texture_warp_kernel import NAMESPACE


MAX_CHANNELS = 8     # the kernel is instantiated for C = 1..8


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, its argument types set (looked up once)."""
    fn = build.load("flow_warp").nhvr_flow_warp_fwd
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, i64, i64, i64, p, i64, i64, i64, p, i32, i32, i32, i32,
                   p]
    fn.restype = i32
    return fn


@torch.library.custom_op(
    f"{NAMESPACE}::flow_warp_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor img, Tensor flow) -> Tensor")
def _flow_warp_fwd_op(img, flow):
    return flow_warp_fwd_plain(img, flow).contiguous()


@_flow_warp_fwd_op.register_kernel("cuda")
def _flow_warp_fwd_cuda(img, flow):
    B, C, H, W = img.shape
    if flow.device != img.device:
        raise ValueError(f"flow_warp_fwd: img on {img.device}, flow on "
                         f"{flow.device}")
    if img.dtype != torch.float32 or flow.dtype != torch.float32:
        raise ValueError(f"img and flow must be float32, got {img.dtype} "
                         f"{flow.dtype}")
    if img.stride(3) != 1 or flow.stride(3) != 1:
        raise ValueError(f"rows must be contiguous, strides {img.stride()} "
                         f"{flow.stride()}")
    if C > MAX_CHANNELS or B * H * W >= 2 ** 31:
        raise ValueError(f"flow_warp_fwd kernel takes C <= {MAX_CHANNELS} "
                         f"and B*H*W < 2^31, got {tuple(img.shape)}")
    out = torch.empty((B, C, H, W), dtype=torch.float32, device=img.device)
    if out.numel() == 0:
        return out
    ist, fst = img.stride(), flow.stride()
    err = _kernel()(img.data_ptr(), ist[0], ist[1], ist[2], flow.data_ptr(),
                    fst[0], fst[1], fst[2], out.data_ptr(), B, C, H, W,
                    torch.cuda.current_stream(img.device).cuda_stream)
    flow_warp_fwd.launches += 1
    if err != 0:
        raise RuntimeError(f"flow_warp_fwd launch failed: CUDA error {err}")
    return out


@_flow_warp_fwd_op.register_fake
def _(img, flow):
    return img.new_empty(img.shape, dtype=torch.float32)


def flow_warp_fwd(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """out(p) = bilinear img(p + flow(p)), zero outside the image (see
    grid_sample.flow_warp), the operator ``nhvr_torch::flow_warp_fwd``.
    img (B, C, H, W) and flow (B, 2, H, W) float32, each image row
    contiguous (any batch / channel / row strides) -> (B, C, H, W)
    contiguous."""
    if img.dim() != 4 or flow.dim() != 4 \
            or flow.shape != (img.shape[0], 2, *img.shape[2:]):
        raise ValueError(f"flow_warp_fwd: img (B, C, H, W) and flow "
                         f"(B, 2, H, W), got {tuple(img.shape)} "
                         f"{tuple(flow.shape)}")
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flow_warp_fwd: unsupported device {img.device}")
    if img.device.type == "cpu":
        img, flow = img.float(), flow.float()
    return _flow_warp_fwd_op(img, flow)


flow_warp_fwd.launches = 0


def reset_launch_counts() -> None:
    flow_warp_fwd.launches = 0


class FlowWarp(torch.autograd.Function):
    """Differentiable flow warp: the kernel forward, the plain version's
    VJP recomputed for the backward (as the JAX package takes the XLA VJP
    of its reference: it has no backward kernel). In the flagship train
    step the backward never runs (the t-1 frame and the flow are data, or
    a detached render); the symmetric temporal mode
    (--no_temporal_detach_prev) runs it, for the t-1 render's gradient."""

    @staticmethod
    def forward(ctx, img, flow):
        ctx.save_for_backward(img, flow)
        return flow_warp_fwd(img, flow)

    @staticmethod
    def backward(ctx, g):
        img, flow = ctx.saved_tensors
        with torch.enable_grad():
            img_ = img.detach().float().requires_grad_(ctx.needs_input_grad[0])
            flow_ = flow.detach().float().requires_grad_(
                ctx.needs_input_grad[1])
            out = flow_warp_fwd_plain(img_, flow_)
            inputs = [t for t in (img_, flow_) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, inputs, g))
        return (next(grads).to(img.dtype) if ctx.needs_input_grad[0] else None,
                next(grads).to(flow.dtype) if ctx.needs_input_grad[1] else None)


def flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The flow warp the losses call: FlowWarp over flow_warp_fwd."""
    return FlowWarp.apply(img, flow)
