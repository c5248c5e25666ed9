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
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..models.discriminator import discriminator_from_options
from ..models.renderer import init_params, renderer_from_options


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

    @property
    def device(self) -> torch.device:
        return self.static_tex.device


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
    The gate reads the update count, which a resume restores (or
    fast-forwards to the saved step: utils/checkpoint), so it is the
    train state's step."""

    def __init__(self, params, lr: float, betas, schedule: Callable,
                 frozen=(), frozen_steps: int = 0):
        super().__init__(params, lr=lr, betas=betas, eps=1e-8)
        self.base_lr = lr
        self.schedule = schedule
        self.count = 0
        self.frozen = list(frozen)
        self.frozen_steps = frozen_steps

    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] = self.base_lr * self.schedule(self.count)
        if self.count < self.frozen_steps:
            for p in self.frozen:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                else:
                    p.grad.zero_()
        loss = super().step(closure)
        self.count += 1
        return loss

    def state_dict(self):
        """torch's Adam state plus the update count the schedule reads."""
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict) -> None:
        state_dict = dict(state_dict)
        count = int(state_dict.pop("count", 0))
        super().load_state_dict(state_dict)
        self.count = count


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
                         lr_schedule(opt, steps_per_epoch), frozen, steps)


def to_nchw(a: Optional[np.ndarray], device) -> Optional[torch.Tensor]:
    """A (..., H, W, C) numpy asset -> a float32 (..., C, H, W) tensor on
    `device` (None stays None)."""
    return None if a is None else torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a, np.float32), -1, -3))).to(device)


def create_train_state(opt, static_tex: np.ndarray, bg: np.ndarray,
                       tex_mask: Optional[np.ndarray] = None,
                       steps_per_epoch: int = 0,
                       device: Optional[torch.device] = None) -> TrainState:
    """Random-init G and D (flax's default init, seeded from --seed), the
    VGG of the perceptual loss (bf16, unless --no_vgg_loss), two Adam
    optimizers with the schedule, the EMA copy (with --instance_feat the
    encoder E is part of G: of its parameters, its EMA and its Adam
    state, as in the JAX package), and the assets: static_tex
    (P, T, T, 3) and bg (S, S, 3) in [-1, 1], tex_mask (P, T, T, 1), as the
    JAX package's create_train_state takes them. With --pool_size the
    empty image pool and its generator (seeded from --seed) on the
    device. ``device`` defaults to --gpu_ids."""
    dev = device if device is not None else resolve_device(opt.gpu_ids)
    renderer = init_params(renderer_from_options(opt), opt.seed).to(dev)
    disc = init_params(discriminator_from_options(opt), opt.seed + 1).to(dev)
    vgg = None
    if not opt.no_vgg_loss:
        from ..models.vgg import build_vgg
        vgg = build_vgg(opt.seed + 2, dtype=torch.bfloat16).to(dev)

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
