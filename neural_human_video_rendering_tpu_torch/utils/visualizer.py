"""Training observability: the port of the JAX package's
``utils/visualizer.py``.

  * the console loss line every --print_freq steps;
  * every logged scalar appended to {run_dir}/metrics.jsonl;
  * the HTML gallery {run_dir}/web/index.html every --display_freq steps
    (unless --no_html);
  * TensorBoard scalars and images under {run_dir}/logs with --tf_log,
    which is refused where torch.utils.tensorboard does not import.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping

import numpy as np

from .html import HTMLGallery
from .image import save_image, to_uint8


def prune_metrics_after(run_dir: str, last_kept_epoch: int) -> int:
    """Drop metrics.jsonl records of the epochs a --continue_train resume
    is about to re-run (epoch > last_kept_epoch; records without an epoch
    stay). Atomic rewrite; returns the number of records dropped."""
    mpath = os.path.join(run_dir, "metrics.jsonl")
    if not os.path.exists(mpath):
        return 0
    kept, dropped = [], 0
    with open(mpath) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                kept.append(line)
                continue
            if rec.get("epoch", 0) <= last_kept_epoch:
                kept.append(line)
            else:
                dropped += 1
    if dropped:
        with open(mpath + ".tmp", "w") as f:
            f.writelines(kept)
        os.replace(mpath + ".tmp", mpath)
        print(f"[metrics] pruned {dropped} record(s) past epoch "
              f"{last_kept_epoch} (re-running them after resume)", flush=True)
    return dropped


class Visualizer:
    def __init__(self, opt):
        self.run_dir = opt.run_dir
        os.makedirs(self.run_dir, exist_ok=True)
        self.gallery = None
        if not opt.no_html:
            self.gallery = HTMLGallery(os.path.join(self.run_dir, "web"),
                                       f"Experiment {opt.name}",
                                       refresh=30 if opt.isTrain else 0)
        self.tb = None
        if opt.tf_log:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise NotImplementedError(
                    "--tf_log needs torch.utils.tensorboard (the tensorboard "
                    "package), which does not import here; drop --tf_log "
                    "(metrics.jsonl records every scalar)") from e
            self.tb = SummaryWriter(os.path.join(self.run_dir, "logs"))
        self.metrics_jsonl = open(os.path.join(self.run_dir, "metrics.jsonl"),
                                  "a")
        self._last_print = time.time()

    def log_losses(self, epoch: int, it: int, losses: Mapping[str, float],
                   step: int) -> None:
        losses = {k: float(v) for k, v in losses.items()}
        now = time.time()
        dt = now - self._last_print
        self._last_print = now
        msg = " ".join(f"{k}: {v:.4f}" for k, v in sorted(losses.items()))
        print(f"(epoch: {epoch}, iters: {it}, time: {dt:.3f}) {msg}", flush=True)
        if self.tb is not None:
            for k, v in losses.items():
                self.tb.add_scalar(f"loss/{k}", v, step)
        self.metrics_jsonl.write(json.dumps(
            {"epoch": epoch, "it": it, "step": step, **losses}) + "\n")
        self.metrics_jsonl.flush()

    def display_results(self, visuals: Mapping[str, np.ndarray], epoch: int,
                        step: int) -> None:
        """visuals: name -> (H, W, C) float image in [-1, 1]."""
        if self.gallery is None:
            return
        files = []
        for name, img in visuals.items():
            fname = f"epoch{epoch:03d}_step{step}_{name}.png"
            save_image(os.path.join(self.gallery.img_dir, fname), img)
            files.append((name, fname))
            if self.tb is not None:
                self.tb.add_image(f"img/{name}", to_uint8(img), step,
                                  dataformats="HWC")
        self.gallery.add_images(f"epoch {epoch}, step {step}", files)
        self.gallery.save()

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()
        self.metrics_jsonl.close()
