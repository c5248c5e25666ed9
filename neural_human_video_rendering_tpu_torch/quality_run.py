"""The port's quality run: from keypoints to a quality number, through the
port's own entry points (the port of the JAX package's
tools/quality_run.py, the same five stages and flags).

  1. make_demo_data: a learnable corpus from a keypoint sequence (frames
     that are exactly the renderer's equation, ``data/synthetic_video.py``);
  2. pre_train: stage-1 UV pretrain of TransG on pose + mask + DensePose;
  3. train: stage 2 with the TransG handoff, every loss but VGG, and a
     held-out --data_ratio 0.9 split scored (PSNR / SSIM) after each epoch;
  4. infer.test_driver: the trained checkpoint driven by the same
     keypoints (self-reenactment);
  5. evaluate: the renders against the true frames (PSNR, SSIM, flicker).

Each stage is a subprocess (``python -m neural_human_video_rendering_tpu_torch.<stage>``),
its output appended to {out}/run.log. Outputs: {out}/data (the corpus),
{out}/ckpt, {out}/renders and {out}/quality_run.json (the config, the
per-epoch val curve, the final parity metrics of all frames, and each
stage's wall seconds).

    python -m neural_human_video_rendering_tpu_torch.quality_run \\
        --out OUT --keypoints KEYPOINT_DIR            # reference sizing
    python -m neural_human_video_rendering_tpu_torch.quality_run \\
        --out OUT --keypoints KEYPOINT_DIR --small --size 32 --tile 16 \\
        --epochs 1 --pre_epochs 1 --extra "--gpu_ids -1"   # CPU smoke

--extra is appended to the model stages' flags; evaluate takes only the
--gpu_ids found there.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys
import time

PKG = "neural_human_video_rendering_tpu_torch"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL_FLAGS = ["--ngf", "16", "--ngf_global", "16", "--ndf", "16",
               "--n_blocks_translate", "2", "--n_downsample_translate", "2",
               "--n_blocks_global", "2", "--n_downsample_global", "1",
               "--n_blocks_bg", "1", "--n_downsample_bg", "1",
               "--dtype", "float32"]

# reference-launcher sizing (pretrain_start.sh / start.sh)
FULL_FLAGS = ["--ngf", "64", "--n_blocks_translate", "9",
              "--n_downsample_translate", "4",
              "--ngf_global", "48", "--n_blocks_global", "10",
              "--n_downsample_global", "2",
              "--n_blocks_bg", "2", "--n_downsample_bg", "2"]


def run(module, args, log_path) -> float:
    """python -m PKG.module args, its output appended to log_path; raises
    SystemExit with the log's tail when it fails. Returns its seconds."""
    cmd = [sys.executable, "-m", f"{PKG}.{module}"] + list(args)
    print("+", " ".join(cmd), flush=True)
    t0 = time.perf_counter()
    with open(log_path, "a") as log:
        log.write("\n+ " + " ".join(cmd) + "\n")
        log.flush()
        r = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                           cwd=REPO)
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        with open(log_path) as f:
            print(f.read()[-4000:])
        raise SystemExit(f"FAILED ({r.returncode}): {' '.join(cmd)}")
    print(f"  {module}: {secs:.1f} s", flush=True)
    return secs


def read_val_curve(run_dir):
    path = os.path.join(run_dir, "metrics.jsonl")
    curve = []
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if "val_PSNR" in rec:
                    curve.append({"epoch": rec["epoch"],
                                  "val_PSNR": rec["val_PSNR"],
                                  "val_SSIM": rec["val_SSIM"]})
    return curve


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--keypoints", required=True,
                   help="driving OpenPose JSON dir, passed to make_demo_data")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--tile", type=int, default=64)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--pre_epochs", type=int, default=6)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--small", action="store_true",
                   help="tiny model (CPU smoke) instead of reference sizing")
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--extra", default="",
                   help="extra flags appended to the model stages (e.g. "
                        "'--gpu_ids -1' for the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = parse(argv)
    os.makedirs(a.out, exist_ok=True)
    log = os.path.join(a.out, "run.log")
    data = os.path.join(a.out, "data")
    ckpt = os.path.join(a.out, "ckpt")
    renders = os.path.join(a.out, "renders")
    extra = shlex.split(a.extra)
    size_flags = (SMALL_FLAGS if a.small else FULL_FLAGS) + [
        "--loadSize", str(a.size), "--tex_tile", str(a.tile)] + extra
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--gpu_ids", default="0")
    gpu_ids = dev.parse_known_args(extra)[0].gpu_ids
    secs = {}

    # 1. the corpus
    secs["make_demo_data"] = run("make_demo_data", [
        "--out", data, "--size", str(a.size), "--tile", str(a.tile),
        "--repeat", str(a.repeat), "--keypoints", a.keypoints], log)

    # 2. stage 1: UV pretrain (pretrainTrans.sh's inputs: pose, mask, IUV)
    secs["pre_train"] = run("pre_train", [
        "--name", "uv", "--checkpoints_dir", ckpt,
        "--batchSize", "6", "--pose_path", f"{data}/openpose_json",
        "--mask_path", f"{data}/mask", "--densepose_path", f"{data}/densepose",
        "--no_flip", "--resize_or_crop", "resize",
        "--niter", str(a.pre_epochs), "--no_decay",
        "--save_epoch_freq", "2", "--print_freq", "10"] + size_flags, log)

    # 3. stage 2: end to end (pretrain_start.sh's losses, no VGG)
    secs["train"] = run("train", [
        "--name", "e2e", "--checkpoints_dir", ckpt,
        "--batchSize", str(a.batch),
        "--pose_path", f"{data}/openpose_json",
        "--mask_path", f"{data}/mask", "--img_path", f"{data}/frames",
        "--densepose_path", f"{data}/densepose",
        "--bg_path", f"{data}/bg.jpg", "--texture_path", f"{data}/texture.png",
        "--flow_path", f"{data}/flow", "--flow_inv_path", f"{data}/flow_inv",
        "--no_flip", "--resize_or_crop", "resize",
        "--load_pretrain_TransG", f"{ckpt}/uv",
        "--which_epoch_TransG", "latest",
        "--lambda_L2", "500", "--lambda_UV", "1000", "--lambda_Prob", "10",
        "--lambda_Temp", "500", "--use_densepose_loss", "--no_vgg_loss",
        "--data_ratio", "0.9", "--niter", str(a.epochs), "--no_decay",
        "--save_epoch_freq", "10", "--print_freq", "20",
        "--display_freq", "100"] + size_flags, log)

    # 4. serving: the same keypoints through the trained checkpoint
    secs["test_driver"] = run("infer.test_driver", [
        "--name", "e2e", "--checkpoints_dir", ckpt,
        "--pose_path", f"{data}/openpose_json",
        "--bg_path", f"{data}/bg.jpg", "--texture_path", f"{data}/texture.png",
        "--results_dir", renders, "--which_epoch", "latest",
        "--target_shape", f"{a.size},{a.size}",
        "--phase", "test"] + size_flags, log)

    # 5. parity: the renders against the true frames
    metrics_path = os.path.join(a.out, "parity.json")
    secs["evaluate"] = run("evaluate", [
        "--results_dir", f"{renders}/images", "--gt_dir", f"{data}/frames",
        "--loadSize", str(a.size), "--no_vgg", "--metric", "temporal",
        "--out", metrics_path, "--gpu_ids", gpu_ids], log)

    curve = read_val_curve(os.path.join(ckpt, "e2e"))
    with open(metrics_path) as f:
        parity = json.load(f)
    n_total = len(os.listdir(f"{data}/frames"))
    summary = {
        "config": {"size": a.size, "tile": a.tile, "epochs": a.epochs,
                   "pre_epochs": a.pre_epochs, "batch": a.batch,
                   "model": "small" if a.small else "reference-sizing",
                   "frames": n_total,
                   "train_frames": int(round(n_total * 0.9))},
        "val_curve": curve,
        "final_parity_all_frames": parity,
        "stage_seconds": secs,
    }
    out_json = os.path.join(a.out, "quality_run.json")
    with open(out_json, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"val_curve_points": len(curve),
                      "first": curve[0] if curve else None,
                      "last": curve[-1] if curve else None,
                      "parity": parity, "stage_seconds": secs}, indent=1))
    print(f"summary -> {out_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
