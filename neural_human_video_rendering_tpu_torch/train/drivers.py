"""The stage-2 trainer of the port: the body behind the JAX package's
train.py (``train/drivers.py:run_train``).

    python -m neural_human_video_rendering_tpu_torch.train.drivers \\
        <train.py flags> [--gpu_ids -1 for the CPU]

Builds the synthetic dataset (``FrameDataset`` is not ported yet, so real
data directories are refused), the assets, the train state and the step,
then runs the epoch loop, printing loss lines at --print_freq. It writes
no checkpoint yet (--continue_train and the --load_pretrain* flags are
refused); it does write opt.txt and recipe.json to the run directory, as
the JAX trainer does.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np
import torch

from ..config import TrainOptions, resolve_device
from ..data import dataset as dsm
from ..data.wire import pack_batch
from .loop import run_training
from .state import check_train_options, create_train_state
from .steps import make_train_step


def _assets(opt, ds):
    """(static_tex (P, T, T, 3), bg (S, S, 3)) from files or synthetic."""
    if opt.texture_path and os.path.isfile(opt.texture_path):
        tex = dsm.load_texture_atlas(opt.texture_path, opt.tex_tile,
                                     opt.tex_rows, opt.tex_cols)
    else:
        tex = ds.texture_atlas()
    if opt.bg_path and os.path.isfile(opt.bg_path):
        bg = dsm.load_image(opt.bg_path, opt.train_size)
    else:
        bg = ds.background()
    return tex, bg


def _tex_mask(opt, tex: np.ndarray) -> Optional[np.ndarray]:
    """(P, T, T, 1) mask of the atlas texels the unfold filled
    (--use_mask_texture), else None."""
    if not opt.use_mask_texture:
        return None
    return (np.abs(tex + 1.0).sum(-1, keepdims=True) > 0.05).astype(np.float32)


def run_train(opt, epochs: Optional[int] = None,
              max_steps: Optional[int] = None):
    """Stage-2 end-to-end training on --gpu_ids (the card unless -1) for
    niter (+ niter_decay) epochs, or ``epochs``, or ``max_steps`` steps.
    Returns the TrainState."""
    check_train_options(opt)
    device = resolve_device(opt.gpu_ids)
    torch.manual_seed(opt.seed)
    print("[data] no real dataset dirs -> SyntheticDataset", flush=True)
    ds = dsm.SyntheticDataset(opt, length=max(opt.batchSize * 4, 16),
                              seed=opt.seed)
    loader = dsm.BatchLoader(ds, opt.batchSize,
                             shuffle=not opt.serial_batches, seed=opt.seed,
                             transform=pack_batch if opt.wire_pack else None)
    tex, bg = _assets(opt, ds)
    state = create_train_state(opt, tex, bg, tex_mask=_tex_mask(opt, tex),
                               steps_per_epoch=len(loader), device=device)
    step = make_train_step(opt, state.renderer, state.disc, state.vgg,
                           state.g_opt, state.d_opt)
    n_epochs = epochs if epochs is not None else (
        opt.niter if opt.no_decay else opt.niter + opt.niter_decay)
    return run_training(opt, loader, step, state, n_epochs,
                        max_steps=max_steps)


def main(argv=None) -> int:
    opt = TrainOptions().parse(argv)
    run_train(opt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
