"""Anatomy of a finished noisy_gt_ab output dir: the port of the JAX
package's tools/round4/noisyab_anatomy.py (the same flags and JSON keys,
plus --gpu_ids).

 1. background drift per saved epoch: BGNet's refined background against
    the true one, in the person-OCCLUDED region (the union of the true
    train masks, where the composite never shows the background) and in
    the VISIBLE region;
 2. mask quality per saved epoch on TRAIN and HELD-OUT frames: IoU
    against the true silhouette, and the soft mask's sharpness
    mean |2p - 1|;
 3. the SSIM map of the held-out renders at the latest epoch, split into
    the person interior (the true mask eroded twice), the boundary band
    and the background; PSNR by the same zones.

    python -m neural_human_video_rendering_tpu_torch.noisyab_anatomy \\
        --ab AB_DIR --small --size 64 --tile 32 --out anatomy.json \\
        [--gpu_ids -1]

Each saved epoch's G is read from the arm's run dir (the port's .pth, or
the JAX package's .msgpack).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from . import noisy_gt_ab as nab


def ssim_map(a, b) -> np.ndarray:
    """Per-pixel SSIM map (H-10, W-10), averaged over the channels, of two
    (H, W, C) images in [-1, 1] (utils.metrics.ssim before its mean)."""
    import torch

    from .utils.metrics import _filter, _gaussian_taps

    def nchw(x):
        x = torch.from_numpy(np.asarray(x, np.float32))
        return (x.permute(2, 0, 1)[None] + 1) / 2

    a, b = nchw(a), nchw(b)
    taps = _gaussian_taps()
    mu_a, mu_b = _filter(a, taps), _filter(b, taps)
    var_a = _filter(a * a, taps) - mu_a ** 2
    var_b = _filter(b * b, taps) - mu_b ** 2
    cov = _filter(a * b, taps) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return s[0].mean(0).numpy()


def region_psnr(x, y, region):
    d = (np.asarray(x, np.float32) - np.asarray(y, np.float32)) ** 2
    if d.ndim == 3:
        region = region[..., None]
    mse = float((d * region).sum() / max(region.sum() * d.shape[-1], 1))
    return 10.0 * np.log10(4.0 / max(mse, 1e-10))


def saved_epochs(run_dir: str):
    """The epochs with a saved G (.pth or .msgpack), numeric ones first,
    'latest' last."""
    from .utils import checkpoint as ck
    eps = {f.split("_")[0] for f in os.listdir(run_dir)
           if f.endswith("_net_G" + ck.EXT) or f.endswith("_net_G" + ck.JAX_EXT)}
    return sorted(eps, key=lambda e: (e == "latest", e.zfill(4)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", required=True, help="noisy_gt_ab --out dir")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--tile", type=int, default=32)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--n_eval", type=int, default=10)
    ap.add_argument("--out", default="")
    ap.add_argument("--gpu_ids", default="0",
                    help="the card of the forwards; -1 for the CPU")
    ns = ap.parse_args(argv)

    import scipy.ndimage as ndi
    import torch

    from .data import dataset as dsm
    from .utils import checkpoint as ck

    class A:   # the slice of noisy_gt_ab's namespace that _opt_for uses
        size, tile, gpu_ids = ns.size, ns.tile, ns.gpu_ids
    size_kw = nab.SIZES_SMALL if ns.small else nab.SIZES_FULL

    clean_data = os.path.join(ns.ab, "clean")
    true_bg = dsm.load_image(os.path.join(clean_data, "bg.jpg"), ns.size)

    report = {}
    for arm in ("clean", "noisy"):
        arm_data = os.path.join(ns.ab, arm)
        ckpt = os.path.join(ns.ab, f"ckpt_{arm}")
        opt = nab._opt_for(A, arm_data, ckpt, size_kw)
        opt_truth = nab._opt_for(A, clean_data, ckpt, size_kw)
        ds_tr = dsm.FrameDataset(opt_truth, "train")    # truth-scored
        ds_te = dsm.FrameDataset(opt_truth, "test")
        run_dir = opt.run_dir
        fwd, assets, renderer = nab.load_model(opt)
        dev = assets[0].device

        def forward(sample, epoch_fwd=fwd):
            with torch.no_grad():
                return epoch_fwd(assets, nab.joints_of(sample, dev))

        # the person-occluded region: the union of the TRUE train masks
        occl = np.zeros((ns.size, ns.size), bool)
        for i in range(len(ds_tr)):
            occl |= nab.plane(ds_tr[i]["mask"]) > 0.5
        occl_f = occl.astype(np.float32)
        vis_f = 1.0 - occl_f

        arm_rep = {"epochs": {}}
        for ep in saved_epochs(run_dir):
            ck.load_net_into(renderer, run_dir, "G", ep)
            bgr = nab.hwc(forward(ds_tr[0])["bg_refined"][0])
            rep = {
                "bg_PSNR_occluded": region_psnr(bgr, true_bg, occl_f),
                "bg_PSNR_visible": region_psnr(bgr, true_bg, vis_f),
            }
            for split, ds in (("train", ds_tr), ("holdout", ds_te)):
                ious, sharp = [], []
                for i in range(min(len(ds), ns.n_eval)):
                    s = ds[i]
                    pm = forward(s)["mask"][0, 0].float().cpu().numpy()
                    ious.append(nab.iou(pm, nab.plane(s["mask"])))
                    sharp.append(float(np.mean(np.abs(2 * pm - 1))))
                rep[f"mask_IoU_{split}"] = float(np.mean(ious))
                rep[f"mask_sharpness_{split}"] = float(np.mean(sharp))
            arm_rep["epochs"][ep] = rep
            print(f"[{arm}] epoch {ep}: {json.dumps(rep)}", flush=True)

        # 3. the SSIM decomposition at latest, held-out split
        ck.load_net_into(renderer, run_dir, "G", "latest")
        zones = {"interior": [], "edge": [], "background": []}
        psnr_zones = {"interior": [], "edge": [], "background": []}
        for i in range(min(len(ds_te), ns.n_eval)):
            s = ds_te[i]
            fake = nab.hwc(forward(s)["fake"][0])
            real = s["image"]
            smap = ssim_map(fake, real)
            tm = nab.plane(s["mask"]) > 0.5
            inner = ndi.binary_erosion(tm, iterations=2)
            outer = ndi.binary_dilation(tm, iterations=2)
            crop = (slice(5, -5), slice(5, -5))
            for zone, zm in (("interior", inner), ("edge", outer & ~inner),
                             ("background", ~outer)):
                zc = zm[crop]
                if zc.sum():
                    zones[zone].append(float(smap[zc].mean()))
                psnr_zones[zone].append(
                    region_psnr(fake, real, zm.astype(np.float32)))
        arm_rep["ssim_zones_latest"] = {k: float(np.mean(v))
                                        for k, v in zones.items()}
        arm_rep["psnr_zones_latest"] = {k: float(np.mean(v))
                                        for k, v in psnr_zones.items()}
        print(f"[{arm}] zones: {json.dumps(arm_rep['ssim_zones_latest'])}",
              flush=True)
        report[arm] = arm_rep

    if ns.out:
        with open(ns.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"-> {ns.out}")
    else:
        print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
