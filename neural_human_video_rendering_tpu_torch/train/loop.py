"""The epoch / iteration training loop: the port of the JAX package's
``train/loop.py`` for the stage-2 trainer.

Epoch loop -> prefetched host batches -> the train step -> a loss line at
--print_freq. Checkpoints, the HTML gallery, TensorBoard and held-out
evaluation are not ported yet; the loop writes nothing to disk.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch


def log_losses(epoch: int, it: int, losses: Dict[str, torch.Tensor],
               dt: float) -> None:
    """The JAX package's Visualizer.log_losses console line."""
    msg = " ".join(f"{k}: {float(v):.4f}" for k, v in sorted(losses.items()))
    print(f"(epoch: {epoch}, iters: {it}, time: {dt:.3f}) {msg}", flush=True)


def run_training(opt, loader, step_fn: Callable, state, epochs: int,
                 max_steps: Optional[int] = None, start_epoch: int = 1):
    """step_fn(state, batch) -> metrics, updating state in place, for
    ``epochs`` epochs or until ``max_steps`` steps. Each step's wall time
    goes to state.step_seconds and its losses to state.metrics; on the
    card the loop synchronises once per step to take the time (the
    loader's thread prepares the next batch meanwhile)."""
    cuda = state.static_tex.device.type == "cuda"
    total = 0
    last = time.time()
    for epoch in range(start_epoch, epochs + 1):
        t_epoch = time.time()
        batches = iter(loader)
        try:
            for it, batch in enumerate(batches):
                t0 = time.perf_counter()
                metrics = step_fn(state, batch)
                if cuda:
                    torch.cuda.synchronize(state.static_tex.device)
                state.step_seconds.append(time.perf_counter() - t0)
                state.metrics = metrics
                total += 1
                if total % opt.print_freq == 0:
                    now = time.time()
                    log_losses(epoch, it, metrics, now - last)
                    last = now
                if max_steps is not None and total >= max_steps:
                    break
        finally:
            batches.close()
        print(f"End of epoch {epoch} / {epochs} "
              f"({time.time() - t_epoch:.1f}s)", flush=True)
        if max_steps is not None and total >= max_steps:
            break
    return state
