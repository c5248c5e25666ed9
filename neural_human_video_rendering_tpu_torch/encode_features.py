"""Per-part appearance codes for --instance_feat inference, the port's
tools/encode_features.py (pix2pixHD's encode_features step):

    python -m neural_human_video_rendering_tpu_torch.encode_features \\
        --name RUN --checkpoints_dir CKPTS --img_path FRAMES \\
        --densepose_path IUV --instance_feat --out features.npz \\
        [--n_clusters 10] [--max_frames 500] [--which_epoch N] [<model flags>]

Runs the run's trained encoder E (the FeatE part of its G) over the
training frames, pools its features per DensePose body part with the
same ``region_mean`` the renderer's part_pool uses, and k-means each
part's vectors (plain numpy, RandomState(0)) into n_clusters codes. At
inference, --load_features features.npz --cluster_idx k renders with
cluster k's codes. Output: centers (n_clusters, P+1, feat_num) in a .npz.
"""

import argparse
import sys

import numpy as np
import torch

from .config import TrainOptions, resolve_device
from .data.dataset import FrameDataset, collate
from .models.generators import FeatEncoder, region_mean
from .utils import checkpoint as ckpt


def kmeans(x: np.ndarray, k: int, iters: int = 25, seed: int = 0) -> np.ndarray:
    """Plain numpy k-means (n, d) -> (k, d); n <= k repeats the points."""
    rng = np.random.RandomState(seed)
    n = len(x)
    if n == 0:
        return np.zeros((k, x.shape[1] if x.ndim == 2 else 1), np.float32)
    if n <= k:
        reps = np.concatenate([x] * (-(-k // n)))[:k]
        return reps.astype(np.float32)
    centers = x[rng.choice(n, k, replace=False)]
    for _ in range(iters):
        d = ((x[:, None] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for j in range(k):
            sel = x[assign == j]
            if len(sel):
                centers[j] = sel.mean(0)
    return centers.astype(np.float32)


def load_encoder(opt, device: torch.device) -> FeatEncoder:
    """E from the G file of --name's run dir at --which_epoch (.pth or the
    JAX package's .msgpack), in float32 as the JAX tool runs it."""
    g = ckpt.load_net(opt.run_dir, "G", opt.which_epoch)
    sd = {k[len("FeatE."):]: v for k, v in g.items() if k.startswith("FeatE.")}
    if not sd:
        raise KeyError(f"{opt.run_dir}: its G has no encoder E (trained "
                       "without --instance_feat / --label_feat)")
    with torch.device("meta"):
        enc = FeatEncoder(opt.feat_num, opt.nef, opt.n_downsample_E,
                          pad_mode=opt.pad_mode,
                          upsample_mode=opt.upsample_mode)
    enc.to_empty(device="cpu").load_state_dict(sd, strict=True)
    return enc.to(device).eval()


def encode_features(opt, n_clusters: int = 10,
                    max_frames: int = 500) -> np.ndarray:
    """(n_clusters, P+1, feat_num) cluster centers of the run's per-part
    mean E features over the first max_frames training frames; parts a
    frame does not show add no vector, parts no frame shows stay 0."""
    if not (opt.instance_feat or opt.label_feat):
        raise ValueError("pass --instance_feat (or --label_feat) so the "
                         "model has encoder E")
    device = resolve_device(opt.gpu_ids)
    enc = load_encoder(opt, device)
    ds = FrameDataset(opt)
    C = opt.n_parts + 1
    vecs = [[] for _ in range(C)]
    take = min(len(ds), max_frames)
    with torch.inference_mode():
        for i in range(take):
            b = collate([ds[i]])
            img = torch.from_numpy(np.ascontiguousarray(
                b["image"].transpose(0, 3, 1, 2))).to(device)
            parts = torch.from_numpy(b["dp_parts"]).long().to(device)
            onehot = torch.zeros((1, C) + tuple(parts.shape[1:]),
                                 device=device).scatter_(1, parts[:, None], 1.0)
            mean = region_mean(enc(img), onehot)[0].cpu().numpy()  # (C, F)
            present = (onehot.sum((0, 2, 3)) > 0).cpu().numpy()
            for c in range(C):
                if present[c]:
                    vecs[c].append(mean[c])
    print(f"[feat] encoded {take} frames", flush=True)
    centers = np.zeros((n_clusters, C, opt.feat_num), np.float32)
    for c in range(C):
        if vecs[c]:
            centers[:, c] = kmeans(np.stack(vecs[c]), n_clusters)
    return centers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--out", default="features.npz")
    ap.add_argument("--n_clusters", type=int, default=10)
    ap.add_argument("--max_frames", type=int, default=500)
    ns, rest = ap.parse_known_args(argv)
    opt = TrainOptions().parse(rest, save=False)
    centers = encode_features(opt, ns.n_clusters, ns.max_frames)
    np.savez(ns.out, centers=centers)
    print(f"[feat] wrote {ns.out}: centers {centers.shape}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
