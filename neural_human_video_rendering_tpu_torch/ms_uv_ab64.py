"""64 px A/B gate for --ms_uv multi-scale deep UV supervision: the port of
the JAX package's tools/round5/ms_uv_ab64.py (the same flags and JSON
keys, plus --keypoints and --gpu_ids).

Two arms on the same clean corpus, the same seed and schedule:
  base:  stage 1 + stage 2 as they are;
  msuv:  the same plus --ms_uv 2 --lambda_MS 0.3 (aux IUV heads at S/4
         and S/2).
Both arms are trained first (subprocesses of the port's pre_train and
train), then both are scored on the held-out split (``score``): render
PSNR / SSIM, the UV L1 at the GT part and the foreground part accuracy.

    python -m neural_human_video_rendering_tpu_torch.ms_uv_ab64 \\
        --out ms_uv_64px.json --keypoints KEYPOINT_DIR [--gpu_ids -1]

--work (default: beside --out) holds the corpus (built once, with
noisy_gt_ab's sentinel), the arms' run dirs and run.log; an arm whose
stage 2 saved --epochs completed epochs is not trained again.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from . import noisy_gt_ab as nab
from .quality_run import run

# 64 px sizing with a 3-level encoder so ms_uv=2 gets two taps of distinct
# resolution (S/4, S/2): the ladder shape the 512 px reference sizing has
SIZES = dict(ngf=16, ngf_global=16, ndf=16,
             n_blocks_translate=4, n_downsample_translate=3,
             n_blocks_global=2, n_downsample_global=1,
             n_blocks_bg=1, n_downsample_bg=1, dtype="float32")


def train_arm(a, data, ckpt, log, extra):
    """Stage 1 and stage 2 of one arm from scratch, ``extra`` appended to
    both stages' flags."""
    import shutil
    shutil.rmtree(ckpt, ignore_errors=True)
    size_flags = nab.flags(SIZES) + ["--loadSize", str(a.size),
                                     "--tex_tile", str(a.tile),
                                     f"--gpu_ids={a.gpu_ids}"]
    run("pre_train", [
        "--name", "uv", "--checkpoints_dir", ckpt,
        "--batchSize", "6", "--pose_path", f"{data}/openpose_json",
        "--mask_path", f"{data}/mask",
        "--densepose_path", f"{data}/densepose",
        "--no_flip", "--resize_or_crop", "resize", "--data_ratio", "0.9",
        "--niter", str(a.pre_epochs), "--no_decay", "--seed", str(a.seed),
        "--save_epoch_freq", "2", "--print_freq", "50"]
        + size_flags + list(extra), log)
    run("train", [
        "--name", "e2e", "--checkpoints_dir", ckpt, "--batchSize", "2",
        "--pose_path", f"{data}/openpose_json",
        "--mask_path", f"{data}/mask", "--img_path", f"{data}/frames",
        "--densepose_path", f"{data}/densepose",
        "--bg_path", f"{data}/bg.jpg", "--texture_path", f"{data}/texture.png",
        "--flow_path", f"{data}/flow", "--flow_inv_path", f"{data}/flow_inv",
        "--no_flip", "--resize_or_crop", "resize",
        "--load_pretrain_TransG", f"{ckpt}/uv", "--which_epoch_TransG",
        "latest",
        "--lambda_L2", "500", "--lambda_UV", "1000", "--lambda_Prob", "10",
        "--lambda_Temp", "500", "--use_densepose_loss", "--no_vgg_loss",
        "--data_ratio", "0.9", "--niter", str(a.epochs), "--no_decay",
        "--seed", str(a.seed),
        "--save_epoch_freq", str(a.epochs), "--print_freq", "100",
        "--display_freq", "100000"] + size_flags + list(extra), log)


def score(a, data, ckpt, extra_kw):
    """Held-out render PSNR / SSIM, the masked UV L1 and the foreground
    part accuracy of the arm's latest G."""
    import torch

    from . import losses as L
    from .config import Options
    from .data import dataset as dsm
    from .utils import metrics as M

    opt = Options(loadSize=a.size, tex_tile=a.tile, batchSize=1,
                  pose_path=f"{data}/openpose_json", mask_path=f"{data}/mask",
                  img_path=f"{data}/frames",
                  densepose_path=f"{data}/densepose",
                  bg_path=f"{data}/bg.jpg",
                  texture_path=f"{data}/texture.png",
                  no_flip=True, serial_batches=True, data_ratio=0.9,
                  checkpoints_dir=ckpt, name="e2e", nThreads=1,
                  gpu_ids=a.gpu_ids, **SIZES, **extra_kw)
    ds = dsm.FrameDataset(opt, "test")
    n = min(len(ds), a.how_many)
    fwd, assets, _ = nab.load_model(opt)
    dev = assets[0].device

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)[None]

    psnr_v, ssim_v, uv_v, acc_v = [], [], [], []
    with torch.no_grad():
        for i in range(n):
            s = ds[i]
            outs = fwd(assets, nab.joints_of(s, dev))
            real = t(s["image"].transpose(2, 0, 1))
            psnr_v.append(float(M.psnr(outs["fake"], real)[0]))
            ssim_v.append(float(M.ssim(outs["fake"], real)[0]))
            parts = t(s["dp_parts"], torch.int64)
            uv_v.append(float(L.uv_loss(outs["uv"],
                                        t(s["dp_uv"].transpose(2, 0, 1)),
                                        parts)))
            pred = outs["probs"].argmax(1)
            fg = parts > 0
            acc = ((pred == parts) & fg).sum() / torch.clamp(fg.sum(), min=1)
            acc_v.append(float(acc))
    return {"held_out_frames": n,
            "render_PSNR": float(np.mean(psnr_v)),
            "render_SSIM": float(np.mean(ssim_v)),
            "uv_L1_at_gt_part": float(np.mean(uv_v)),
            "part_accuracy_fg": float(np.mean(acc_v))}


def run_arms(a, arms, summary, log, data) -> dict:
    """Train every arm that needs it, then score every arm (so a killed run
    leaves no arm scored before the other was trained); arms: name ->
    (training flags, scoring Options overrides). Adds each arm's scores
    and saved epoch to ``summary``."""
    for arm, (extra, _) in arms.items():
        ckpt = os.path.join(a.work, f"ckpt_{arm}")
        if nab.needs_training(ckpt, a.epochs):
            train_arm(a, data, ckpt, log, extra)
    for arm, (_, kw) in arms.items():
        ckpt = os.path.join(a.work, f"ckpt_{arm}")
        summary[arm] = score(a, data, ckpt, kw)
        summary[arm]["anchor_epoch"] = nab.arm_epoch(ckpt)
        print(f"[{arm}] {json.dumps(summary[arm])}", flush=True)
    return summary


def add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--out", required=True, help="summary json path")
    p.add_argument("--keypoints", required=True,
                   help="driving OpenPose JSON dir, passed to make_demo_data")
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--tile", type=int, default=32)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--pre_epochs", type=int, default=4)
    p.add_argument("--how_many", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gpu_ids", default="0",
                   help="the card of every stage; -1 for the CPU")


def finish(a, summary, lever: str) -> dict:
    summary["delta_PSNR"] = (summary[lever]["render_PSNR"]
                             - summary["base"]["render_PSNR"])
    summary["delta_uv_L1"] = (summary[lever]["uv_L1_at_gt_part"]
                              - summary["base"]["uv_L1_at_gt_part"])
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"summary -> {a.out}")
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common(p)
    p.add_argument("--work", default=None,
                   help="work dir (default: ms64 beside --out)")
    a = p.parse_args(argv)
    a.work = a.work or os.path.join(
        os.path.dirname(os.path.abspath(a.out)), "ms64")

    os.makedirs(a.work, exist_ok=True)
    log = os.path.join(a.work, "run.log")
    data = os.path.join(a.work, "data")
    nab.build_corpus(data, a.size, a.tile, a.keypoints, log)

    arms = {"base": ([], {}),
            "msuv": (["--ms_uv", "2", "--lambda_MS", "0.3"], {"ms_uv": 2})}
    summary = {"config": {"size": a.size, "epochs": a.epochs,
                          "pre_epochs": a.pre_epochs, "seed": a.seed,
                          "sizes": SIZES}}
    run_arms(a, arms, summary, log, data)
    finish(a, summary, "msuv")
    return 0


if __name__ == "__main__":
    sys.exit(main())
