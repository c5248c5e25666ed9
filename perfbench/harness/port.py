"""The system under test, built from the port's own parts with the
benchmark's weights and assets.

``train_state`` follows the port's ``create_train_state`` but loads the
weights the benchmark drew on the card instead of the port's host-side
seeded init, so set-up time is the program's and not a second init's.
"""

from __future__ import annotations

from typing import Dict

import torch

PORT = "neural_human_video_rendering_tpu_torch"


def options(flags: dict, train: bool):
    from neural_human_video_rendering_tpu_torch.config import Options
    opt = Options(**flags)
    opt.isTrain = train
    return opt


def _load(module: torch.nn.Module, weights: Dict[str, torch.Tensor],
          device) -> torch.nn.Module:
    module = module.to_empty(device=device)
    module.load_state_dict(weights, strict=True)
    return module


def renderer(opt, weights, device) -> torch.nn.Module:
    from neural_human_video_rendering_tpu_torch.models.renderer import \
        renderer_from_options
    return _load(renderer_from_options(opt), weights, device)


def train_state(opt, weights: Dict[str, Dict[str, torch.Tensor]],
                static_tex: torch.Tensor, bg: torch.Tensor, device):
    from neural_human_video_rendering_tpu_torch.models.discriminator import \
        discriminator_from_options
    from neural_human_video_rendering_tpu_torch.models.vgg import \
        VGG19Features
    from neural_human_video_rendering_tpu_torch.train.state import (
        TrainState, make_optimizer)
    g = renderer(opt, weights["G"], device)
    d = _load(discriminator_from_options(opt), weights["D"], device)
    vgg = None
    if not opt.no_vgg_loss:
        with torch.device("meta"):
            vgg = VGG19Features(dtype=torch.bfloat16)
        vgg = _load(vgg, weights["VGG"], device).requires_grad_(False)
    g_ema = None
    if opt.ema_decay > 0:
        g_ema = {k: v.detach().clone() for k, v in g.named_parameters()}
    return TrainState(
        step=0, renderer=g.train(), disc=d.train(), vgg=vgg,
        g_opt=make_optimizer(opt, g.named_parameters()),
        d_opt=make_optimizer(opt, d.named_parameters()),
        static_tex=static_tex, bg=bg, tex_mask=None, g_ema=g_ema)


def train_step(opt, state):
    from neural_human_video_rendering_tpu_torch.train.steps import \
        make_train_step
    return make_train_step(opt, state.renderer, state.disc, state.vgg,
                           state.g_opt, state.d_opt)


def forward_fn(opt, g):
    from neural_human_video_rendering_tpu_torch.train.steps import \
        make_forward_fn
    return make_forward_fn(opt, g)
