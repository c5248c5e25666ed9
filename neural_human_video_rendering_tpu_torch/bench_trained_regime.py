"""The stage-2 step's rate while the part head sharpens: the port of the
JAX package's tools/bench_trained_regime.py (the same flags and output
lines, plus --gpu_ids).

It trains the bench's exact operating point (``bench.bench_options``:
512 px, batch 2, tile 128, bf16, the reference sizing) on its one
synthetic batch and prints the steps/s and G_Prob of each window of
--window_steps steps, as the part probabilities converge under the
supervised CE loss. On the TPU the warp kernel skipped (block, part)
pairs whose top-k mass is zero, so the rate rose as the head sharpened.
The CUDA kernels have no such skip, and the warp kernels are under 1% of
the step's device time, so on the card this measures the step's rate on
converging inputs, expected flat.

    python -m neural_human_video_rendering_tpu_torch.bench_trained_regime \\
        [--windows 12 --window_steps 100] [--gpu_ids -1]

Each window is fenced by torch.cuda.synchronize() and the fetch of its
last G_Prob. One JSON line a window, then
{"metric": "trained_regime_speedup_512px_bs2", "first_window_sps",
"last_window_sps", "speedup"}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Optional

import torch

from . import bench
from .config import resolve_device
from .data import dataset as dsm
from .data.wire import pack_batch
from .train.state import create_train_state
from .train.steps import make_train_step

METRIC = "trained_regime_speedup_512px_bs2"


def run(opt, device: torch.device, windows: int, window_steps: int,
        on_window: Optional[Callable] = None) -> dict:
    """Train ``windows`` x ``window_steps`` steps on the bench's batch; each
    window's line is printed and ``on_window(index, state, batch)`` called
    after it (outside its timing). Returns (the summary line, the windows'
    lines)."""
    ds = dsm.SyntheticDataset(opt, length=opt.batchSize)
    batch = pack_batch(dsm.collate([ds[i] for i in range(opt.batchSize)]))
    state = create_train_state(opt, ds.texture_atlas(), ds.background(),
                               device=device)
    step = make_train_step(opt, state.renderer, state.disc, state.vgg,
                           state.g_opt, state.d_opt)
    t0 = time.perf_counter()
    metrics = step(state, batch)
    _ = float(metrics["G_total"])
    print(f"# first step: {time.perf_counter() - t0:.1f}s  device: {device}",
          file=sys.stderr, flush=True)
    first = last = None
    lines = []
    for wi in range(windows):
        bench._sync(device)
        t0 = time.perf_counter()
        for _ in range(window_steps):
            metrics = step(state, batch)
        bench._sync(device)
        prob = float(metrics["G_Prob"])          # the fetch ends the window
        sps = window_steps / (time.perf_counter() - t0)
        first = sps if first is None else first
        last = sps
        lines.append({"window": wi, "steps_per_sec": round(sps, 4),
                      "G_Prob": round(prob, 4)})
        print(json.dumps(lines[-1]), flush=True)
        if on_window is not None:
            on_window(wi, state, batch)
    summary = {"metric": METRIC, "first_window_sps": round(first, 4),
               "last_window_sps": round(last, 4),
               "speedup": round(last / first, 3)}
    print(json.dumps(summary), flush=True)
    return summary, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=12)
    ap.add_argument("--window_steps", type=int, default=100)
    ap.add_argument("--gpu_ids", default="0",
                    help="the CUDA device index; -1 for the CPU")
    ns = ap.parse_args(argv)
    device = resolve_device(ns.gpu_ids)
    opt = bench.bench_options(128, "bfloat16", ns.gpu_ids)
    run(opt, device, ns.windows, ns.window_steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
