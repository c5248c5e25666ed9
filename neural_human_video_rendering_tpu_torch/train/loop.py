"""The epoch / iteration training loop of all three stages: the port of
the JAX package's ``train/loop.py``.

Epoch loop -> prefetched host batches -> the train step -> a loss line at
--print_freq, the HTML gallery at --display_freq, an iteration 'latest'
checkpoint at --save_latest_freq; after each epoch the held-out eval and,
at --save_epoch_freq and the final epoch, the epoch checkpoint.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ..utils.visualizer import Visualizer


def run_training(opt, loader, step_fn: Callable, state, epochs: int,
                 save_fn: Optional[Callable] = None,
                 visuals_fn: Optional[Callable] = None,
                 eval_fn: Optional[Callable] = None,
                 start_epoch: int = 1, max_steps: Optional[int] = None):
    """step_fn(state, batch) -> metrics, updating state in place, for
    epochs start_epoch..epochs, or until ``max_steps`` steps of this run
    (an epoch cut short is neither evaluated nor saved).

    save_fn(state, epoch, completed=None): epoch is a number or 'latest'
    (then ``completed`` is the last completed epoch); eval_fn(state,
    epoch) -> metrics dict; visuals_fn(state, batch) -> {name: image}.
    Each step's wall time goes to state.step_seconds and its losses to
    state.metrics; on the card the loop synchronises once per step to
    take the time (the loader's thread prepares the next batch
    meanwhile)."""
    cuda = state.device.type == "cuda"
    vis = Visualizer(opt)
    total = 0
    try:
        for epoch in range(start_epoch, epochs + 1):
            t_epoch = time.time()
            cut = False
            batches = iter(loader)
            try:
                for it, batch in enumerate(batches):
                    if max_steps is not None and total >= max_steps:
                        cut = True
                        break
                    t0 = time.perf_counter()
                    metrics = step_fn(state, batch)
                    if cuda:
                        torch.cuda.synchronize(state.device)
                    state.step_seconds.append(time.perf_counter() - t0)
                    state.metrics = metrics
                    total += 1
                    if total % opt.print_freq == 0:
                        vis.log_losses(epoch, it, metrics, state.step)
                    if visuals_fn is not None and total % opt.display_freq == 0:
                        vis.display_results(visuals_fn(state, batch), epoch,
                                            state.step)
                    if (save_fn is not None and opt.save_latest_freq > 0
                            and total % opt.save_latest_freq == 0):
                        # the last COMPLETED epoch rides along, so a resume
                        # knows where the save sits in the schedule
                        save_fn(state, "latest", epoch - 1)
            finally:
                batches.close()
            if cut:
                break
            print(f"End of epoch {epoch} / {epochs} "
                  f"({time.time() - t_epoch:.1f}s)", flush=True)
            if eval_fn is not None:
                ev = eval_fn(state, epoch)
                if ev:
                    vis.log_losses(epoch, -1, ev, state.step)
            if save_fn is not None and (epoch % opt.save_epoch_freq == 0
                                        or epoch == epochs):
                save_fn(state, epoch)
            if max_steps is not None and total >= max_steps:
                break
    finally:
        vis.close()
    return state
