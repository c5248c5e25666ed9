"""Train state of the stage-2 step: the port of the JAX package's
``train/state.py``.

The JAX package threads one immutable pytree through a jitted step; the
port keeps the same pieces in a mutable ``TrainState`` that the step
updates in place: the step count, the renderer (G) and the multiscale
discriminator (D) as modules, their two optimizers, the frozen VGG of the
perceptual loss, the EMA copy of G's parameters, the per-identity assets
(static atlas, background, texel mask) and the image pool of --pool_size
(``train/image_pool.py``) with its generator.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..models.discriminator import discriminator_from_options
from ..models.renderer import init_params, renderer_from_options
from ..ops.adam_ema_kernel import adam_ema
from ..parallel.mesh import DataParallel, module_tensors, optimizer_tensors


@dataclasses.dataclass
class TrainState:
    step: int
    renderer: torch.nn.Module
    disc: torch.nn.Module
    vgg: Optional[torch.nn.Module]
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    static_tex: torch.Tensor                 # (P, 3, T, T)
    bg: torch.Tensor                         # (3, S, S)
    tex_mask: Optional[torch.Tensor]         # (P, 1, T, T) or None
    # EMA of G's parameters by name (--ema_decay > 0), else None
    g_ema: Optional[Dict[str, torch.Tensor]] = None
    # wall seconds of each step the loop ran (synchronised on the card)
    step_seconds: List[float] = dataclasses.field(default_factory=list)
    # the last step's losses (float32 scalars on the device)
    metrics: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    # the epoch this run started at (> 1 after a --continue_train resume)
    start_epoch: int = 1
    # the image pool (--pool_size > 0): (K + 1, pose_nc + 3, S, S) history
    # and sink row, the () int64 count of valid entries, its generator
    pool_buf: Optional[torch.Tensor] = None
    pool_n: Optional[torch.Tensor] = None
    pool_gen: Optional[torch.Generator] = None
    # the step count on the device (() int64, the EMA's decay reads it
    # there) and the host step it was last set to or advanced to
    step_t: Optional[torch.Tensor] = None
    step_t_at: int = -1

    @property
    def device(self) -> torch.device:
        return self.static_tex.device

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor of the state that a step updates: G's and D's
        parameters and buffers, both optimizers' tensors, the EMA and the
        pool. The data-parallel ranks hold them bit-equal (``dp.check``);
        a capture's warm-up saves and restores them (``train/steps.py``)."""
        out = (module_tensors(self.renderer) + module_tensors(self.disc)
               + optimizer_tensors(self.g_opt) + optimizer_tensors(self.d_opt))
        if self.g_ema is not None:
            out += list(self.g_ema.values())
        if self.pool_buf is not None:
            out += [self.pool_buf, self.pool_n]
        return out


@dataclasses.dataclass
class PretrainState:
    """What a pretrain step updates in place: one generator (TransG or
    TexG) and its optimizer."""
    step: int
    net: torch.nn.Module
    optimizer: torch.optim.Optimizer
    device: torch.device
    step_seconds: List[float] = dataclasses.field(default_factory=list)
    metrics: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def lr_schedule(opt, steps_per_epoch: int = 0) -> Callable[[int], float]:
    """pix2pixHD's schedule as a multiplier of --lr by update count:
    constant for niter epochs, then linear to 0 over niter_decay epochs
    (optax.join_schedules of constant and linear, as the JAX package's
    make_optimizer); constant with --no_decay or an unknown epoch length."""
    if opt.no_decay or steps_per_epoch <= 0:
        return lambda t: 1.0
    flat = opt.niter * steps_per_epoch
    decay = max(opt.niter_decay * steps_per_epoch, 1)
    return lambda t: 1.0 if t < flat else 1.0 - min(t - flat, decay) / decay


@torch.no_grad()
def blend_ema(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              d) -> None:
    """e = d e + (1 - d) p in place, for each (parameter p, EMA tensor e)
    of ``pairs``; ``d`` the effective decay (``train/steps.ema_decay``): a
    () float32 tensor or a number, float32 as there."""
    p, e = [v.detach() for v, _ in pairs], [v for _, v in pairs]
    if torch.is_tensor(d) and d.is_cuda:
        # a captured step reads d on the device, and add's alpha must be a
        # host number: e * d, then + p * (1 - d), the product rounded
        # before the sum. On the CPU the step is a host number and the
        # update keeps add's alpha form (e * d + (1 - d) * p, fused where
        # the CPU fuses it), the arithmetic the CPU tests (the JAX parity
        # cases, the data-parallel evaluation's 1e-6 bound) were set on;
        # the two differ by one rounding an element. The card's step folds
        # this form into Adam's kernel (ScheduledAdam.update).
        torch._foreach_mul_(e, d)
        torch._foreach_add_(e, torch._foreach_mul(p, 1.0 - d))
        return
    d = np.float32(d.item() if torch.is_tensor(d) else d)
    torch._foreach_mul_(e, float(d))
    torch._foreach_add_(e, p, alpha=float(np.float32(1.0) - np.float32(d)))


# the optimizers' parameter tensors offered to an update, and those of them
# that the one-pass kernel updated, as Python runs the updates (eagerly, or
# once while a program is captured: a replay runs no Python)
_UPDATES = {"tensors": 0, "kernel": 0}


def adam_counts() -> Tuple[int, int]:
    """(parameter tensors the kernel updated, parameter tensors offered) of
    every ScheduledAdam update so far in this process."""
    return _UPDATES["kernel"], _UPDATES["tensors"]


class ScheduledAdam(torch.optim.Adam):
    """torch.optim.Adam (eps 1e-8 added to the bias-corrected sqrt(v), as
    optax.adam) whose learning rate follows ``schedule`` of its own update
    count, the schedule living in the optimizer as it does in an optax
    transformation.

    ``frozen`` parameters get zero gradients for the first
    ``frozen_steps`` updates (the JAX package's freeze_scope_until ahead
    of Adam): zero, not None, so their Adam step counts advance with the
    others as optax's one shared count does, their moments stay 0 and
    they do not move; the bias correction after the unfreeze is optax's.
    The gate reads its own update count, ``freeze_count`` (optax keeps
    the freeze's count apart from the schedule's), which a resume restores
    (or fast-forwards to the saved step: utils/checkpoint), so it is the
    train state's step. ``scheduled`` says whether the JAX package's
    optimizer of the same flags holds a schedule state (the LR decays);
    a resume from a JAX run reads optax's layout by it.

    On the card the update can be captured in a CUDA graph: Adam runs
    ``capturable`` (its step counts on the device) with the learning rate
    a device tensor that ``prepare`` fills from the schedule before each
    update. ``step()`` is ``prepare(); update(); advance()``: a captured
    step runs ``update`` in the graph and the other two on the host
    around each replay (the freeze's Python branch is part of the graph's
    signature: ``freezing``). There ``update`` is one pass of the port's
    kernel a parameter group (``ops/adam_ema_kernel.py``) over torch
    Adam's own state (``step``, ``exp_avg``, ``exp_avg_sq``), which takes
    the EMA into the same pass where it is handed one. On the CPU the
    learning rate stays a number and Adam runs as torch runs it by
    default."""

    def __init__(self, params, lr: float, betas, schedule: Callable,
                 frozen=(), frozen_steps: int = 0, scheduled: bool = False):
        params = list(params)
        card = next((p.device for p in params if p.is_cuda), None)
        self.lr_t = (None if card is None else
                     torch.full((), float(lr), dtype=torch.float32,
                                device=card))
        super().__init__(params, lr=lr if card is None else self.lr_t,
                         betas=betas, eps=1e-8, capturable=card is not None)
        self.base_lr = lr
        self.lr_now = float(lr)
        self.schedule = schedule
        self.scheduled = scheduled
        self.count = 0
        self.freeze_count = 0
        self.frozen = list(frozen)
        self.frozen_steps = frozen_steps

    @property
    def freezing(self) -> bool:
        return self.freeze_count < self.frozen_steps

    def prepare(self) -> None:
        """The learning rate of this update from the schedule (on the card:
        the device tensor filled where the value changes)."""
        lr = self.base_lr * self.schedule(self.count)
        if self.lr_t is None:
            for group in self.param_groups:
                group["lr"] = lr
        elif lr != self.lr_now:
            self.lr_t.fill_(lr)
        self.lr_now = lr

    def update(self, ema: Optional[Tuple[Sequence[Tuple[torch.Tensor,
                                                        torch.Tensor]],
                                         object]] = None) -> None:
        """The frozen gradients zeroed (while freezing), then Adam, then,
        with ``ema`` = ((parameter, EMA tensor) pairs, the decay d), each
        EMA tensor blended toward its new parameter, e = d e + (1 - d) p
        (``blend_ema``): no Python state changes. On the card (a device
        learning rate) Adam and the blend are one pass of the kernel a
        parameter group; on the CPU torch's Adam, then ``blend_ema``."""
        if self.freezing:
            for p in self.frozen:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                else:
                    p.grad.zero_()
        _UPDATES["tensors"] += sum(len(g["params"])
                                   for g in self.param_groups)
        if self.lr_t is None:
            super().step()
            if ema is not None:
                blend_ema(*ema)
            return
        self._one_pass(ema)

    @torch.no_grad()
    def _one_pass(self, ema) -> None:
        """Adam (and the EMA) through ``adam_ema``, over the parameters
        with a gradient as torch's Adam takes them (its state made as torch
        makes it); the EMA of a parameter without one blends on its own."""
        rest = dict(ema[0]) if ema is not None else {}
        for group in self.param_groups:
            if group["weight_decay"] or group["amsgrad"] \
                    or group["maximize"]:
                raise ValueError("ScheduledAdam's kernel takes no weight "
                                 "decay, amsgrad or maximize")
            params, grads, m, v, steps = [], [], [], [], []
            self._init_group(group, params, grads, m, v, [], steps)
            e = None
            if ema is not None:
                e = [rest.pop(p) for p in params]
            adam_ema(params, grads, m, v, steps, group["lr"],
                     *group["betas"], group["eps"], e,
                     None if e is None else ema[1])
            if params and params[0].is_cuda:
                _UPDATES["kernel"] += len(params)
        if rest:
            blend_ema(list(rest.items()), ema[1])

    def advance(self) -> None:
        self.count += 1
        self.freeze_count += 1

    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ScheduledAdam.step takes no closure")
        self.prepare()
        self.update()
        self.advance()

    def state_dict(self):
        """torch's Adam state plus the update counts the schedule and the
        freeze read; the learning rate a number and capturable off, as a
        CPU optimizer saves them (a device run's file loads anywhere)."""
        sd = super().state_dict()
        for group in sd["param_groups"]:
            group["lr"] = float(self.lr_now)
            group["capturable"] = False
        sd["count"] = self.count
        sd["freeze_count"] = self.freeze_count
        return sd

    def load_state_dict(self, state_dict) -> None:
        state_dict = dict(state_dict)
        count = int(state_dict.pop("count", 0))
        freeze_count = int(state_dict.pop("freeze_count", count))
        # this optimizer's own device settings (the step counts on the
        # card when capturable), whatever the file's optimizer ran with
        state_dict["param_groups"] = [
            dict(g, capturable=self.lr_t is not None)
            for g in state_dict["param_groups"]]
        super().load_state_dict(state_dict)
        # each moment in its parameter's layout (a file may hold another:
        # one saved before the convs' weights went channels_last), so the
        # foreach update keeps its fused route
        for p, st in self.state.items():
            for k, v in st.items():
                if (torch.is_tensor(v) and v.shape == p.shape
                        and v.stride() != p.stride()):
                    st[k] = torch.empty_like(p, dtype=v.dtype).copy_(v)
        if self.lr_t is not None:
            for group in self.param_groups:
                group["lr"] = self.lr_t
        self.count = count
        self.freeze_count = freeze_count
        self.lr_now = float("nan")       # prepare() sets it anew


FREEZE_SCOPE = "global_trunk"


def make_optimizer(opt, params, steps_per_epoch: int = 0) -> ScheduledAdam:
    """Adam(lr, beta1, beta2) with pix2pixHD's LR schedule. ``params``:
    parameters, or (name, parameter) pairs (``named_parameters()``); with
    names, --netG local, --niter_fix_global > 0 and a known epoch length,
    every parameter with a name component equal to ``global_trunk`` (an
    exact component, not a substring) is frozen for niter_fix_global
    epochs (pix2pixHD trains only the enhancer branches first)."""
    params = list(params)
    frozen, steps = [], 0
    if params and isinstance(params[0], tuple):
        if (opt.niter_fix_global > 0 and opt.netG == "local"
                and steps_per_epoch > 0):
            frozen = [p for n, p in params if FREEZE_SCOPE in n.split(".")]
            steps = opt.niter_fix_global * steps_per_epoch
        params = [p for _, p in params]
    return ScheduledAdam(params, opt.lr, (opt.beta1, opt.beta2),
                         lr_schedule(opt, steps_per_epoch), frozen, steps,
                         scheduled=not opt.no_decay and steps_per_epoch > 0)


def to_nchw(a: Optional[np.ndarray], device) -> Optional[torch.Tensor]:
    """A (..., H, W, C) numpy asset -> a float32 (..., C, H, W) tensor on
    `device` (None stays None)."""
    return None if a is None else torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a, np.float32), -1, -3))).to(device)


def create_train_state(opt, static_tex: np.ndarray, bg: np.ndarray,
                       tex_mask: Optional[np.ndarray] = None,
                       steps_per_epoch: int = 0,
                       device: Optional[torch.device] = None,
                       dp: Optional[DataParallel] = None) -> TrainState:
    """Random-init G and D (flax's default init, seeded from --seed), the
    VGG of the perceptual loss (bf16, unless --no_vgg_loss), two Adam
    optimizers with the schedule, the EMA copy (with --instance_feat the
    encoder E is part of G: of its parameters, its EMA and its Adam
    state, as in the JAX package), and the assets: static_tex
    (P, T, T, 3) and bg (S, S, 3) in [-1, 1], tex_mask (P, T, T, 1), as the
    JAX package's create_train_state takes them. With --pool_size the
    empty image pool and its generator (seeded from --seed) on the
    device. ``device`` defaults to --gpu_ids. Under data parallel (``dp``)
    rank 0's initial G, D and VGG are broadcast to the other ranks (a
    seed alone is not trusted to give the same weights on two devices)."""
    dev = device if device is not None else resolve_device(opt.gpu_ids)
    renderer = init_params(renderer_from_options(opt), opt.seed).to(dev)
    disc = init_params(discriminator_from_options(opt), opt.seed + 1).to(dev)
    vgg = None
    if not opt.no_vgg_loss:
        from ..models.vgg import build_vgg
        vgg = build_vgg(opt.seed + 2, dtype=torch.bfloat16).to(dev)
    if dp is not None:
        dp.replicate(module_tensors(renderer) + module_tensors(disc)
                     + (module_tensors(vgg) if vgg is not None else []))

    g_ema = None
    if opt.ema_decay > 0:
        g_ema = {k: v.detach().clone()
                 for k, v in renderer.named_parameters()}
    pool = {}
    if opt.pool_size > 0:
        S = opt.train_size
        pool = dict(
            pool_buf=torch.zeros((opt.pool_size + 1, opt.pose_nc + 3, S, S),
                                 dtype=torch.float32, device=dev),
            pool_n=torch.zeros((), dtype=torch.int64, device=dev),
            pool_gen=torch.Generator(device=dev).manual_seed(opt.seed + 3))
    return TrainState(
        step=0, renderer=renderer.train(), disc=disc.train(), vgg=vgg,
        g_opt=make_optimizer(opt, renderer.named_parameters(),
                             steps_per_epoch),
        d_opt=make_optimizer(opt, disc.named_parameters(), steps_per_epoch),
        static_tex=to_nchw(static_tex, dev), bg=to_nchw(bg, dev),
        tex_mask=to_nchw(tex_mask, dev),
        g_ema=g_ema, **pool)
