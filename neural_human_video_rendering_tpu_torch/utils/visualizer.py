"""Training observability: the port of the JAX package's
``utils/visualizer.py``.

  * the console loss line every --print_freq steps;
  * every logged scalar appended to {run_dir}/metrics.jsonl;
  * the HTML gallery {run_dir}/web/index.html every --display_freq steps
    (unless --no_html);
  * TensorBoard scalars and images under {run_dir}/logs with --tf_log,
    or, where torch.utils.tensorboard does not import or its writer fails,
    one {"step": s, **losses} line per log_losses call in
    logs/scalars.jsonl.
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


def dedup_metrics(run_dir: str) -> int:
    """Apply the resume-prune rule retroactively to a whole metrics.jsonl:
    a record whose epoch is below the largest kept one, or equal to it
    with its step counter reset, marks a restart that superseded every
    kept record from that epoch on; those are dropped. Lines that are not
    records, and records without an epoch, stay. Not for a run dir with a
    live trainer (the atomic replace orphans its append handle). Returns
    the number of records dropped."""
    mpath = os.path.join(run_dir, "metrics.jsonl")
    if not os.path.exists(mpath):
        return 0
    kept, dropped = [], 0
    max_kept, last_step = 0, -1
    with open(mpath) as f:
        lines = f.readlines()
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            kept.append((None, line))
            continue
        ep = rec.get("epoch")
        if ep is None:
            kept.append((None, line))
            continue
        step = rec.get("step")
        if ep < max_kept or (ep == max_kept and step is not None
                             and step < last_step):
            n = len(kept)
            kept = [(e, l) for e, l in kept if e is None or e < ep]
            dropped += n - len(kept)
            max_kept = ep
        else:
            max_kept = max(max_kept, ep)
        if step is not None:
            last_step = step
        kept.append((ep, line))
    if dropped:
        with open(mpath + ".tmp", "w") as f:
            f.writelines(l for _, l in kept)
        os.replace(mpath + ".tmp", mpath)
        print(f"[metrics] dedup: dropped {dropped} superseded record(s) "
              f"from {mpath}", flush=True)
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
        self.jsonl = None
        if opt.tf_log:
            log_dir = os.path.join(self.run_dir, "logs")
            os.makedirs(log_dir, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(log_dir)
            except Exception:
                self.jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        mpath = os.path.join(self.run_dir, "metrics.jsonl")
        try:
            # a run dir forked with `cp -al` shares this inode with its
            # parent: rewrite a private copy so appends leave the parent's
            # curve alone
            if os.path.exists(mpath) and os.stat(mpath).st_nlink > 1:
                with open(mpath, "rb") as src:
                    data = src.read()
                with open(mpath + ".tmp", "wb") as dst:
                    dst.write(data)
                os.replace(mpath + ".tmp", mpath)
        except OSError:
            pass
        self.metrics_jsonl = open(mpath, "a")
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
        elif self.jsonl is not None:
            self.jsonl.write(json.dumps({"step": step, **losses}) + "\n")
            self.jsonl.flush()
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
        if self.jsonl is not None:
            self.jsonl.close()
        self.metrics_jsonl.close()
