"""Noisy pseudo-GT robustness A/B: the port of the JAX package's
tools/noisy_gt_ab.py (the same flags and JSON keys, plus --keypoints and
--gpu_ids).

  arm clean: stage 1 + stage 2 on noise-free pseudo-GT;
  arm noisy: the same frames, with the mask, the DensePose IUV and bg.jpg
             corrupted at --corrupt strength (make_demo_data --corrupt).

Both arms are scored on the held-out split against the TRUE frames, and
the noisy arm's refinement against the supervision it trained on:
  * mask IoU: the predicted soft mask vs the true silhouette, beside the
    corrupted supervision's own IoU;
  * bg PSNR: BGNet's refined background vs the true background, beside
    the corrupted inpainting estimate it started from;
  * render PSNR / SSIM against the true frames.

    python -m neural_human_video_rendering_tpu_torch.noisy_gt_ab \\
        --out OUT --keypoints KEYPOINT_DIR                 # the card
    python -m neural_human_video_rendering_tpu_torch.noisy_gt_ab \\
        --out OUT --keypoints KEYPOINT_DIR --small --size 64 --tile 32 \\
        --epochs 4 --pre_epochs 2 --how_many 6 --gpu_ids -1   # the CPU

Every stage is a subprocess of the port's entry points (make_demo_data,
pre_train, train); the arms are trained first, then a --skip_train
subprocess scores both. A corpus counts as built only when make_demo_data
has exited 0 and left the sentinel CORPUS_DONE; an arm counts as trained
only when its stage-2 save records --epochs completed epochs, else it is
trained again from scratch. The summary records each arm's saved epoch
(``anchor_epoch``). Output: {out}/noisy_gt_ab.json and {out}/run.log.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import Optional

import numpy as np

from .quality_run import run

SIZES_SMALL = dict(ngf=16, ngf_global=16, ndf=16,
                   n_blocks_translate=2, n_downsample_translate=2,
                   n_blocks_global=2, n_downsample_global=1,
                   n_blocks_bg=1, n_downsample_bg=1, dtype="float32")
# reference-launcher sizing (pretrain_start.sh / start.sh)
SIZES_FULL = dict(ngf=64, n_blocks_translate=9, n_downsample_translate=4,
                  ngf_global=48, n_blocks_global=10, n_downsample_global=2,
                  n_blocks_bg=2, n_downsample_bg=2)
CORPUS_DONE = "CORPUS_DONE"


def flags(d):
    out = []
    for k, v in d.items():
        out += [f"--{k}", str(v)]
    return out


def build_corpus(data: str, size: int, tile: int, keypoints: str, log: str,
                 extra=()) -> bool:
    """make_demo_data into ``data`` unless its sentinel is there (a
    directory without it, from a killed build, is removed and rebuilt);
    the sentinel is written after make_demo_data exits 0. Returns whether
    it built."""
    if os.path.exists(os.path.join(data, CORPUS_DONE)):
        return False
    shutil.rmtree(data, ignore_errors=True)
    run("make_demo_data", ["--out", data, "--size", str(size), "--tile",
                           str(tile), "--keypoints", keypoints] + list(extra),
        log)
    with open(os.path.join(data, CORPUS_DONE), "w") as f:
        f.write("make_demo_data exited 0\n")
    return True


def arm_epoch(ckpt: str) -> Optional[int]:
    """The epoch an arm's stage-2 run dir ({ckpt}/e2e) has saved as
    completed, None without a latest G."""
    from .utils import checkpoint as ck
    run_dir = os.path.join(ckpt, "e2e")
    if not os.path.exists(os.path.join(run_dir, "latest_net_G" + ck.EXT)):
        return None
    return ck.saved_epoch(run_dir)


def needs_training(ckpt: str, epochs: int) -> bool:
    """True unless the arm's stage 2 saved --epochs completed epochs."""
    ep = arm_epoch(ckpt)
    return ep is None or ep < epochs


def train_arm(a, data, ckpt, log, size_kw):
    """Stage-1 UV pretrain + stage-2 e2e on one corpus dir, from scratch."""
    shutil.rmtree(ckpt, ignore_errors=True)
    size_flags = flags(size_kw) + ["--loadSize", str(a.size),
                                   "--tex_tile", str(a.tile),
                                   f"--gpu_ids={a.gpu_ids}"]
    run("pre_train", [
        "--name", "uv", "--checkpoints_dir", ckpt,
        "--batchSize", "6", "--pose_path", f"{data}/openpose_json",
        "--mask_path", f"{data}/mask",
        "--densepose_path", f"{data}/densepose",
        "--no_flip", "--resize_or_crop", "resize",
        # stage 2's split: the UV pretrain must not see the frames that
        # refinement_metrics scores as held-out
        "--data_ratio", "0.9",
        "--niter", str(a.pre_epochs), "--no_decay", "--seed", str(a.seed),
        "--save_epoch_freq", "2", "--print_freq", "20"] + size_flags, log)
    run("train", [
        "--name", "e2e", "--checkpoints_dir", ckpt,
        "--batchSize", str(a.batch),
        "--pose_path", f"{data}/openpose_json",
        "--mask_path", f"{data}/mask", "--img_path", f"{data}/frames",
        "--densepose_path", f"{data}/densepose",
        "--bg_path", f"{data}/bg.jpg",
        "--texture_path", f"{data}/texture.png",
        "--flow_path", f"{data}/flow", "--flow_inv_path", f"{data}/flow_inv",
        "--no_flip", "--resize_or_crop", "resize",
        "--load_pretrain_TransG", f"{ckpt}/uv",
        "--which_epoch_TransG", "latest",
        "--lambda_L2", "500", "--lambda_UV", "1000", "--lambda_Prob", "10",
        "--lambda_Temp", "500", "--use_densepose_loss", "--no_vgg_loss",
        "--data_ratio", "0.9", "--niter", str(a.epochs), "--no_decay",
        "--seed", str(a.seed),
        "--save_epoch_freq", "10", "--print_freq", "50",
        "--display_freq", "10000"] + size_flags, log)


def _opt_for(a, data, ckpt, size_kw):
    from .config import Options
    return Options(loadSize=a.size, tex_tile=a.tile, batchSize=1,
                   pose_path=f"{data}/openpose_json",
                   mask_path=f"{data}/mask", img_path=f"{data}/frames",
                   densepose_path=f"{data}/densepose",
                   bg_path=f"{data}/bg.jpg",
                   texture_path=f"{data}/texture.png",
                   no_flip=True, serial_batches=True, data_ratio=0.9,
                   checkpoints_dir=ckpt, name="e2e", nThreads=1,
                   gpu_ids=a.gpu_ids, **size_kw)


def load_model(opt, epoch="latest"):
    """(the forward of make_forward_fn, its assets, the renderer) of the
    run dir's G at ``epoch`` (.pth, or the JAX package's .msgpack), on
    --gpu_ids's device."""
    from .config import resolve_device
    from .data import dataset as dsm
    from .infer.test_driver import assets_to_device
    from .models.renderer import init_params, renderer_from_options
    from .train.steps import make_forward_fn
    from .utils import checkpoint as ck
    dev = resolve_device(opt.gpu_ids)
    renderer = init_params(renderer_from_options(opt), opt.seed)
    ck.load_net_into(renderer, opt.run_dir, "G", epoch)
    renderer = renderer.to(dev).eval()
    tex = dsm.load_texture_atlas(opt.texture_path, opt.tex_tile,
                                 opt.tex_rows, opt.tex_cols)
    bg = dsm.load_image(opt.bg_path, opt.train_size)
    return (make_forward_fn(opt, renderer),
            assets_to_device(opt, tex, bg, dev), renderer)


def joints_of(sample, device):
    import torch
    return torch.from_numpy(sample["joints"][None]).to(device)


def hwc(t) -> np.ndarray:
    """(C, H, W) tensor -> (H, W, C) float32 numpy."""
    return t.permute(1, 2, 0).float().cpu().numpy()


def nhwc_psnr(x: np.ndarray, y: np.ndarray) -> float:
    """PSNR of two (H, W, C) images in [-1, 1] (utils.metrics.psnr)."""
    import torch

    from .utils import metrics as M
    return float(M.psnr(torch.from_numpy(np.asarray(x, np.float32))[None],
                        torch.from_numpy(np.asarray(y, np.float32))[None])[0])


def iou(p, t):
    p, t = p > 0.5, t > 0.5
    inter = float(np.sum(p & t))
    union = float(np.sum(p | t))
    return inter / union if union else 1.0


def plane(m: np.ndarray) -> np.ndarray:
    """A mask (H, W, 1) or (H, W) -> (H, W)."""
    return m[..., 0] if m.ndim == 3 else m


def refinement_metrics(a, arm_data, clean_data, ckpt, size_kw, n_eval):
    """Held-out forward through the arm's latest G: render quality against
    the TRUE frames, and the refined mask / background against the truth
    and against the (possibly corrupted) supervision the arm trained on."""
    import torch

    from .data import dataset as dsm
    from .utils import metrics as M

    opt = _opt_for(a, arm_data, ckpt, size_kw)
    opt_truth = _opt_for(a, clean_data, ckpt, size_kw)
    ds = dsm.FrameDataset(opt, "test")              # trained-on supervision
    ds_truth = dsm.FrameDataset(opt_truth, "test")  # noise-free truth
    n = min(len(ds), n_eval)
    assert n > 0
    fwd, assets, _ = load_model(opt)
    dev = assets[0].device
    true_bg = dsm.load_image(opt_truth.bg_path, opt.train_size)
    sup_bg = dsm.load_image(opt.bg_path, opt.train_size)

    psnr_v, ssim_v, iou_pred, iou_sup = [], [], [], []
    bg_ref = None
    with torch.no_grad():
        for i in range(n):
            s, st = ds[i], ds_truth[i]
            outs = fwd(assets, joints_of(s, dev))
            real = torch.from_numpy(np.ascontiguousarray(
                st["image"].transpose(2, 0, 1)))[None].to(dev)
            psnr_v.append(float(M.psnr(outs["fake"], real)[0]))
            ssim_v.append(float(M.ssim(outs["fake"], real)[0]))
            pred_mask = outs["mask"][0, 0].float().cpu().numpy()
            iou_pred.append(iou(pred_mask, plane(st["mask"])))
            iou_sup.append(iou(plane(s["mask"]), plane(st["mask"])))
            if bg_ref is None:
                bg_ref = hwc(outs["bg_refined"][0])
    return {
        "held_out_frames": n,
        "render_PSNR": float(np.mean(psnr_v)),
        "render_SSIM": float(np.mean(ssim_v)),
        "mask_IoU_refined_vs_true": float(np.mean(iou_pred)),
        "mask_IoU_supervision_vs_true": float(np.mean(iou_sup)),
        "bg_PSNR_refined_vs_true": nhwc_psnr(bg_ref, true_bg),
        "bg_PSNR_supervision_vs_true": nhwc_psnr(sup_bg, true_bg),
    }


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--keypoints", required=True,
                   help="driving OpenPose JSON dir, passed to make_demo_data")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--tile", type=int, default=64)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--pre_epochs", type=int, default=4)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--corrupt", type=float, default=0.6)
    p.add_argument("--how_many", type=int, default=10,
                   help="held-out frames to score")
    p.add_argument("--small", action="store_true")
    p.add_argument("--seed", type=int, default=0,
                   help="training init seed for both arms (seed-noise "
                        "replicas of the A/B)")
    p.add_argument("--skip_train", action="store_true",
                   help="re-score existing checkpoints only")
    p.add_argument("--gpu_ids", default="0",
                   help="the card of every stage; -1 for the CPU")
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = parse(argv)
    os.makedirs(a.out, exist_ok=True)
    log = os.path.join(a.out, "run.log")
    size_kw = SIZES_SMALL if a.small else SIZES_FULL

    arms = {"clean": os.path.join(a.out, "clean"),
            "noisy": os.path.join(a.out, "noisy")}
    for arm, data in arms.items():
        build_corpus(data, a.size, a.tile, a.keypoints, log,
                     ["--corrupt", str(a.corrupt)] if arm == "noisy" else [])

    summary = {"config": {"size": a.size, "tile": a.tile,
                          "epochs": a.epochs, "pre_epochs": a.pre_epochs,
                          "corrupt": a.corrupt,
                          "model": "small" if a.small else
                          "reference-sizing"}}
    if not a.skip_train:
        # both arms first, then the scoring in a fresh --skip_train process
        for arm, data in arms.items():
            ckpt = os.path.join(a.out, f"ckpt_{arm}")
            if needs_training(ckpt, a.epochs):
                train_arm(a, data, ckpt, log, size_kw)
        args = ["--out", a.out, "--keypoints", a.keypoints,
                "--size", str(a.size), "--tile", str(a.tile),
                "--epochs", str(a.epochs), "--pre_epochs", str(a.pre_epochs),
                "--batch", str(a.batch), "--corrupt", str(a.corrupt),
                "--how_many", str(a.how_many), "--seed", str(a.seed),
                f"--gpu_ids={a.gpu_ids}", "--skip_train"]
        if a.small:
            args.append("--small")
        run("noisy_gt_ab", args, log)
        return 0
    for arm, data in arms.items():
        ckpt = os.path.join(a.out, f"ckpt_{arm}")
        summary[arm] = refinement_metrics(a, data, arms["clean"], ckpt,
                                          size_kw, a.how_many)
        summary[arm]["anchor_epoch"] = arm_epoch(ckpt)
        print(f"[{arm}] {json.dumps(summary[arm])}", flush=True)

    out_json = os.path.join(a.out, "noisy_gt_ab.json")
    with open(out_json, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"summary -> {out_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
