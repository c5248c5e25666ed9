"""The epoch / iteration training loop of all three stages: the port of
the JAX package's ``train/loop.py``.

Epoch loop -> prefetched host batches -> the train step -> a loss line at
--print_freq, the HTML gallery at --display_freq, an iteration 'latest'
checkpoint at --save_latest_freq; after each epoch the held-out eval and,
at --save_epoch_freq and the final epoch, the epoch checkpoint.

Two debugging flags act here, for every stage:
  * --profile_dir: a torch.profiler window over this run's steps
    [profile_start, profile_start + profile_steps), written as a Chrome
    trace under --profile_dir (the JAX loop writes a jax.profiler trace of
    the same window). Besides the profiler's own events it carries the
    port's spans (``utils/spans.py``): those of this thread as the
    profiler's annotations (``loop.next_batch``, the wait for the
    loader; ``step.prepare``; a captured program's ``<name>.copy_in``,
    ``.replay`` and ``.clone_out``), those of other threads (the
    loader's ``data.batch``) as events of category ``span`` on their own
    thread's row;
  * --debug_nans: every step's losses are checked for NaN / inf (one
    device sync a step, so only with the flag); a non-finite loss raises
    FloatingPointError naming it.

Under data parallel every rank steps and evaluates, and only the lead
(rank 0) logs, displays and saves; every rank waits at a barrier after
each save, so that none reads a half-written file (the JAX loop's rule
for its processes).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, Optional

import torch

from ..parallel.mesh import DataParallel
from ..utils import spans
from ..utils.visualizer import Visualizer

_END = object()


def check_finite(metrics: Dict[str, torch.Tensor], step: int) -> None:
    """--debug_nans: raise FloatingPointError naming every non-finite loss
    of a step (one sync for all of them)."""
    names = list(metrics)
    ok = torch.isfinite(torch.stack([metrics[k].detach().float().reshape(())
                                     for k in names])).tolist()
    bad = [k for k, good in zip(names, ok) if not good]
    if bad:
        vals = ", ".join(f"{k}={float(metrics[k])}" for k in bad)
        raise FloatingPointError(f"--debug_nans: non-finite loss at step "
                                 f"{step}: {vals}")


class ProfileWindow:
    """A torch.profiler trace of the steps [start, start + steps) of a run
    (counted from 0), CPU and, on the card, CUDA activity, with Python
    stacks (``profile_step --analyze`` reads them), exported as
    {profile_dir}/steps_{first}-{last}{tag}.trace.json (tag: _rank{r} on
    each rank of a data-parallel run). The spans that other threads
    recorded during the window are added to it (``spans.chrome_events``):
    the profiler records annotations only on the thread that started
    it."""

    def __init__(self, opt, cuda: bool, tag: str = ""):
        self.dir = opt.profile_dir
        self.start = opt.profile_start
        self.stop_at = opt.profile_start + max(1, opt.profile_steps)
        self.cuda = cuda
        self.tag = tag
        self.prof = None

    def before_step(self, total: int) -> None:
        if self.dir and self.prof is None and total == self.start:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts, with_stack=True)
            self.prof.start()
            self.first = total
            self.since_ns = time.perf_counter_ns()
            self.tid = threading.get_native_id()

    def after_step(self, total: int) -> None:
        if self.prof is not None and total >= self.stop_at:
            self.close(total)

    def close(self, total: int) -> None:
        if self.prof is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(
            self.dir, f"steps_{self.first}-{total - 1}{self.tag}.trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        self._add_spans(path)
        print(f"[profile] trace of steps {self.first}-{total - 1} written "
              f"-> {path}", flush=True)

    def _add_spans(self, path: str) -> None:
        """Write the window's spans of other threads into the trace."""
        recs = [r for r in spans.records()
                if r.start_ns >= self.since_ns and r.tid != self.tid]
        if not recs:
            return
        with open(path) as f:
            trace = json.load(f)
        trace["traceEvents"].extend(spans.chrome_events(
            int(trace.get("baseTimeNanoseconds", 0)), recs))
        with open(path, "w") as f:
            json.dump(trace, f)


def run_training(opt, loader, step_fn: Callable, state, epochs: int,
                 save_fn: Optional[Callable] = None,
                 visuals_fn: Optional[Callable] = None,
                 eval_fn: Optional[Callable] = None,
                 start_epoch: int = 1, max_steps: Optional[int] = None,
                 dp: Optional[DataParallel] = None):
    """step_fn(state, batch) -> metrics, updating state in place, for
    epochs start_epoch..epochs, or until ``max_steps`` steps of this run
    (an epoch cut short is neither evaluated nor saved).

    save_fn(state, epoch, completed=None): epoch is a number or 'latest'
    (then ``completed`` is the last completed epoch); eval_fn(state,
    epoch) -> metrics dict; visuals_fn(state, batch) -> {name: image}.
    Each step's wall time goes to state.step_seconds and its losses to
    state.metrics; on the card the loop synchronises once per step to
    take the time (the loader's thread prepares the next batch
    meanwhile). ``dp``: this rank of a data-parallel run (the module
    docstring); None for a lone rank."""
    dp = dp if dp is not None else DataParallel()
    lead = dp.is_lead
    cuda = state.device.type == "cuda"
    vis = Visualizer(opt) if lead else None
    window = ProfileWindow(opt, cuda, f"_rank{dp.rank}" if dp.parallel
                           else "")
    total = 0

    def save(*args):
        if lead:
            save_fn(state, *args)
        dp.barrier()

    try:
        for epoch in range(start_epoch, epochs + 1):
            t_epoch = time.time()
            cut = False
            batches = iter(loader)
            try:
                for it in itertools.count():
                    with spans.span("loop.next_batch"):
                        batch = next(batches, _END)
                    if batch is _END:
                        break
                    if max_steps is not None and total >= max_steps:
                        cut = True
                        break
                    window.before_step(total)
                    t0 = time.perf_counter()
                    metrics = step_fn(state, batch)
                    if cuda:
                        torch.cuda.synchronize(state.device)
                    state.step_seconds.append(time.perf_counter() - t0)
                    state.metrics = metrics
                    total += 1
                    window.after_step(total)
                    if opt.debug_nans:
                        check_finite(metrics, state.step)
                    if lead and total % opt.print_freq == 0:
                        vis.log_losses(epoch, it, metrics, state.step)
                    if (lead and visuals_fn is not None
                            and total % opt.display_freq == 0):
                        vis.display_results(visuals_fn(state, batch), epoch,
                                            state.step)
                    if (save_fn is not None and opt.save_latest_freq > 0
                            and total % opt.save_latest_freq == 0):
                        # the last COMPLETED epoch rides along, so a resume
                        # knows where the save sits in the schedule
                        save("latest", epoch - 1)
            finally:
                if hasattr(batches, "close"):      # BatchLoader's generator
                    batches.close()
            if cut:
                break
            if lead:
                print(f"End of epoch {epoch} / {epochs} "
                      f"({time.time() - t_epoch:.1f}s)", flush=True)
            if eval_fn is not None:
                ev = eval_fn(state, epoch)
                if lead and ev:
                    vis.log_losses(epoch, -1, ev, state.step)
            if save_fn is not None and (epoch % opt.save_epoch_freq == 0
                                        or epoch == epochs):
                save(epoch)
            if max_steps is not None and total >= max_steps:
                break
    finally:
        window.close(total)
        if vis is not None:
            vis.close()
    return state
