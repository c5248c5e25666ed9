"""One optimizer's Adam update in one pass, with the EMA of the parameters
folded in where it is given.

The CUDA source is ``csrc/adam_ema.cu`` (its header note: it replaces no
TPU kernel, what bounds it on the H100 and its design); it is built by
``ops/build.py`` and launched through ctypes. This module holds:
  * the plain PyTorch version, ``adam_ema_plain``: torch's capturable
    foreach Adam written out, then the EMA's card form; the CPU tests use
    it and the chip smoke test holds the kernel against it on the card;
  * the wrapper ``adam_ema``, which runs the plain version for CPU tensors
    and, for CUDA tensors, checks its arguments and launches the kernel or
    raises;
  * the launch counter ``adam_ema.launches``, bumped where the kernel
    launches and nowhere else.

``train/state.py``'s ``ScheduledAdam`` calls the wrapper on the card, once
a parameter group, with the EMA's tensors for G's optimizer.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Union

import torch

from . import build

MAX_TENSORS = 224      # csrc/adam_ema.cu's kMaxTensors: tensors a launch

Number = Union[float, torch.Tensor]


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, its argument types set (looked up once)."""
    fn = build.load("adam_ema").nhvr_adam_ema
    p, f = ctypes.c_void_p, ctypes.c_float
    fn.argtypes = [ctypes.c_int, p, p, p, p, p, p, p, p, p, f, f, f, f, f, p]
    fn.restype = ctypes.c_int
    return fn


def adam_ema_plain(params: Sequence[torch.Tensor],
                   grads: Sequence[torch.Tensor],
                   exp_avgs: Sequence[torch.Tensor],
                   exp_avg_sqs: Sequence[torch.Tensor],
                   steps: Sequence[torch.Tensor], lr: Number, beta1: float,
                   beta2: float, eps: float,
                   ema: Optional[Sequence[torch.Tensor]] = None,
                   decay: Optional[Number] = None) -> None:
    """The kernel's arithmetic in PyTorch, in place: each step count + 1,
    torch's capturable foreach Adam (torch/optim/adam.py
    ``_multi_tensor_adam`` without weight decay, amsgrad or maximize) on
    params, then with ``ema`` e = e * decay + p * (1 - decay), each product
    rounded before the sum (``blend_ema``'s card form)."""
    params, steps = list(params), list(steps)
    torch._foreach_add_(steps, 1)
    torch._foreach_lerp_(list(exp_avgs), list(grads), 1 - beta1)
    torch._foreach_mul_(list(exp_avg_sqs), beta2)
    torch._foreach_addcmul_(list(exp_avg_sqs), list(grads), list(grads),
                            1 - beta2)
    step_size = torch._foreach_pow(beta1, steps)
    bc2 = torch._foreach_pow(beta2, steps)
    torch._foreach_sub_(step_size, 1)
    torch._foreach_sub_(bc2, 1)
    torch._foreach_neg_(bc2)
    torch._foreach_div_(step_size, lr)
    torch._foreach_reciprocal_(step_size)
    torch._foreach_sqrt_(bc2)
    denom = torch._foreach_sqrt(list(exp_avg_sqs))
    torch._foreach_div_(denom, bc2)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(denom, step_size)
    torch._foreach_addcdiv_(params, list(exp_avgs), denom)
    if ema is not None:
        ema = list(ema)
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - decay))


def _dense(t: torch.Tensor) -> bool:
    """Every element at its own offset, no gaps: the memory is one run of
    numel floats in some order of the dimensions."""
    want = 1
    for size, stride in sorted(zip(t.shape, t.stride()), key=lambda s: s[1]):
        if size != 1:
            if stride != want:
                return False
            want *= size
    return True


def _check(params, grads, exp_avgs, exp_avg_sqs, steps, lr, ema, decay):
    """What the kernel takes, or a ValueError."""
    dev = params[0].device
    scalars = [("lr", lr)] + ([("decay", decay)] if ema is not None else [])
    for name, s in scalars + [("step", s) for s in steps]:
        if not torch.is_tensor(s) or s.numel() != 1 or s.device != dev \
                or s.dtype != torch.float32:
            raise ValueError(f"adam_ema: {name} must be a float32 scalar "
                             f"tensor on {dev}, got "
                             f"{s.dtype if torch.is_tensor(s) else type(s)} "
                             f"{getattr(s, 'device', '')}")
    for i, p in enumerate(params):
        if not _dense(p):
            raise ValueError(f"adam_ema: parameter {i} is not dense "
                             f"(strides {p.stride()})")
        group = [("param", p), ("grad", grads[i]), ("exp_avg", exp_avgs[i]),
                 ("exp_avg_sq", exp_avg_sqs[i])]
        if ema is not None:
            group.append(("ema", ema[i]))
        for name, t in group:
            if t.device != dev or t.dtype != torch.float32:
                raise ValueError(f"adam_ema: tensor {i}'s {name} must be "
                                 f"float32 on {dev}, got {t.dtype} on "
                                 f"{t.device}")
            if t.shape != p.shape or t.stride() != p.stride():
                raise ValueError(
                    f"adam_ema: tensor {i}'s {name} has shape "
                    f"{tuple(t.shape)} strides {t.stride()}, its parameter "
                    f"{tuple(p.shape)} {p.stride()}")
            if t.data_ptr() % 16:
                raise ValueError(f"adam_ema: tensor {i}'s {name} is not "
                                 f"16-byte aligned")


def adam_ema(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             exp_avgs: Sequence[torch.Tensor],
             exp_avg_sqs: Sequence[torch.Tensor],
             steps: Sequence[torch.Tensor], lr: Number, beta1: float,
             beta2: float, eps: float,
             ema: Optional[Sequence[torch.Tensor]] = None,
             decay: Optional[Number] = None) -> None:
    """Adam's update of ``params`` in place (their ``grads``, torch Adam's
    state tensors ``exp_avgs``, ``exp_avg_sqs`` and ``steps``, each step
    count advanced), then, where ``ema`` (one tensor a parameter) and
    ``decay`` are given, each EMA tensor blended toward its new parameter;
    ``adam_ema_plain`` says what it computes.

    CPU tensors run the plain version. CUDA tensors launch the kernel, one
    launch per ``MAX_TENSORS`` tensors, after one foreach add of the step
    counts: every tensor float32 on one device, a parameter's gradient,
    moments and EMA of its shape and strides, dense and 16-byte aligned;
    ``lr``, ``decay`` and each step count float32 scalar tensors on that
    device (a captured update reads them there). Anything else raises."""
    n = len(params)
    if any(len(x) != n for x in (grads, exp_avgs, exp_avg_sqs, steps)) \
            or (ema is not None and len(ema) != n):
        raise ValueError("adam_ema: one grad, moment pair, step count (and "
                         "EMA tensor) per parameter")
    if (ema is None) != (decay is None):
        raise ValueError("adam_ema: the EMA's tensors and its decay go "
                         "together")
    if n == 0:
        return
    if params[0].device.type == "cpu":
        adam_ema_plain(params, grads, exp_avgs, exp_avg_sqs, steps, lr,
                       beta1, beta2, eps, ema, decay)
        return
    if params[0].device.type != "cuda":
        raise ValueError(f"adam_ema: unsupported device {params[0].device}")
    _check(params, grads, exp_avgs, exp_avg_sqs, steps, lr, ema, decay)
    torch._foreach_add_(list(steps), 1)
    stream = torch.cuda.current_stream(params[0].device).cuda_stream
    for lo in range(0, n, MAX_TENSORS):
        hi = min(lo + MAX_TENSORS, n)

        def table(ts):
            return (ctypes.c_void_p * (hi - lo))(
                *[t.data_ptr() for t in ts[lo:hi]])

        err = _kernel()(
            hi - lo, table(params), table(grads), table(exp_avgs),
            table(exp_avg_sqs), None if ema is None else table(ema),
            table(steps),
            (ctypes.c_longlong * (hi - lo))(*[p.numel()
                                              for p in params[lo:hi]]),
            lr.data_ptr(), None if ema is None else decay.data_ptr(),
            beta1, beta2, 1 - beta1, 1 - beta2, eps, stream)
        adam_ema.launches += 1
        if err != 0:
            raise RuntimeError(f"adam_ema launch failed: CUDA error {err}")


adam_ema.launches = 0


def reset_launch_counts() -> None:
    adam_ema.launches = 0
