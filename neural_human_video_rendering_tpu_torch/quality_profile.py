"""Quality decomposition of a trained run: the port of the JAX package's
tools/quality_profile.py (the same flags and JSON keys).

Each held-out frame is rendered under substitutions that replace one
subsystem's output with ground truth at a time, and each variant is
scored (PSNR / SSIM against the true frame):

  full          the model as trained
  transg_gt     the corpus IUV (one-hot parts, one UV) injected; TexG's
                texture and BGNet's background kept
  texg_static   the dynamic texture replaced by the static atlas
  mask_gt       the predicted soft mask replaced by the true silhouette
  bg_gt         the refined background replaced by the true background
  all_gt_file   every input from the corpus files (codec-quantised IUV,
                the true atlas, mask and background)
  all_gt_exact  every input from the exact rasterisation (no codec): the
                model class's ceiling

plus the model-free tile sweep (--ceiling_tiles) of all_gt_exact with the
true atlas at each tile.

    python -m neural_human_video_rendering_tpu_torch.quality_profile \\
        --data DATA --run_dir RUN_DIR --how_many 6 --out qprof.json \\
        -- --loadSize 512 --tex_tile 64 <the run's model flags>

The flags after ``--`` go to the port's TestOptions (the run's sizing
flags; --gpu_ids -1 for the CPU). G is read from RUN_DIR: the port's .pth
file, else the JAX package's .msgpack. Everything runs under no_grad, so
every warp is the fused forward that writes no w: per frame one in the
model's forward and one in each of transg_gt, texg_static, all_gt_file
and all_gt_exact, then one per frame and tile of the sweep
(``launches_per_frame``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from .config import TestOptions, resolve_device
from .data import dataset as dsm
from .data import synthetic_video as sv
from .models.renderer import init_params, renderer_from_options
from .ops.texture_warp import texture_warp_planes
from .train.steps import make_forward_fn
from .utils import checkpoint as ckpt
from .utils import metrics as M

VARIANT_WARPS = 4       # transg_gt, texg_static, all_gt_file, all_gt_exact

Warp = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int, float],
                torch.Tensor]


def launches_per_frame(n_tiles: int) -> int:
    """Fused no-w warp launches a frame: the model's forward, the variants'
    warps and one a tile of the sweep (without --warp_block_parts)."""
    return 1 + VARIANT_WARPS + n_tiles


def kernel_warp(tex: torch.Tensor, uv: torch.Tensor, probs: torch.Tensor,
                k: int, eps: float) -> torch.Tensor:
    """The renderer's warp (the fused kernel on the card)."""
    return texture_warp_planes(tex, uv, probs, k=k, eps=eps)


def gt_warp(warp: Warp, tex: torch.Tensor, uv2: torch.Tensor,
            onehot: torch.Tensor, k: int, eps: float) -> torch.Tensor:
    """GT injection: one (B, 2, H, W) UV for every part and one-hot probs.
    The UV is copied to every part (the kernels take parts at least a
    plane apart, not a broadcast of stride 0)."""
    B, _, H, W = uv2.shape
    uv = uv2[:, None].expand(B, tex.shape[1], 2, H, W).contiguous()
    return warp(tex, uv, onehot, k, eps)


def compose(mask: torch.Tensor, fg: torch.Tensor,
            bg: torch.Tensor) -> torch.Tensor:
    return mask * fg + (1.0 - mask) * bg


def one_hot(parts: np.ndarray, n_classes: int,
            device: torch.device) -> torch.Tensor:
    """(H, W) part ids -> (1, n_classes, H, W) float32, background at 0,
    contiguous (the kernels read each class's plane with the pixel axis
    contiguous)."""
    t = torch.from_numpy(np.asarray(parts, np.int64))[None].to(device)
    return torch.nn.functional.one_hot(t, n_classes).permute(
        0, 3, 1, 2).float().contiguous()


def nchw(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """(H, W, C) -> (1, C, H, W) float32 on device."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(2, 0, 1)))[None].to(device)


def atlas_tensor(atlas: np.ndarray, device: torch.device) -> torch.Tensor:
    """(P, T, T, 3) -> (1, P, 3, T, T) float32 on device."""
    return torch.from_numpy(np.ascontiguousarray(
        atlas.transpose(0, 3, 1, 2), np.float32))[None].to(device)


def score(a: torch.Tensor, b: torch.Tensor):
    return float(M.psnr(a, b)[0]), float(M.ssim(a, b)[0])


def exact_gt(joints: np.ndarray, S: int, P: int, device: torch.device):
    """(onehot, mask, uv) of the exact rasterisation of a frame's joints."""
    parts_e, uv_e, _ = sv.rasterize_iuv(np.asarray(joints), S)
    onehot = one_hot(parts_e, P + 1, device)
    return onehot, 1.0 - onehot[:, :1], nchw(uv_e, device)


def tile_ceiling(exact: Sequence, bg: torch.Tensor, tiles: Sequence[int],
                 P: int, k: int, eps: float, warp: Warp = kernel_warp
                 ) -> Dict[int, Dict[str, float]]:
    """The model-free tile sweep: the true atlas at tile T warped by the
    exact IUV of each frame, composited on the true background, scored
    against the frame. exact: [(onehot, mask, uv, real)]."""
    out = {}
    for T in tiles:
        atlas = atlas_tensor(sv.part_texture_atlas(P, tile=T), bg.device)
        acc = [0.0, 0.0]
        for onehot, mask, uv, real in exact:
            fake = compose(mask, gt_warp(warp, atlas, uv, onehot, k, eps), bg)
            p, s = score(fake, real)
            acc[0] += p
            acc[1] += s
        out[T] = {"PSNR": acc[0] / len(exact), "SSIM": acc[1] / len(exact)}
    return out


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True,
                    help="corpus dir (make_demo_data)")
    ap.add_argument("--run_dir", required=True, help="trained run dir")
    ap.add_argument("--which_epoch", default="latest")
    ap.add_argument("--how_many", type=int, default=8)
    ap.add_argument("--data_ratio", type=float, default=0.9,
                    help="train/holdout split: MUST match the training "
                         "run's --data_ratio or the 'held-out' frames are "
                         "training frames (default 0.9, the launcher value)")
    ap.add_argument("--ceiling_tiles", default="32,64,128")
    ap.add_argument("--out", default="")
    my, rest = ap.parse_known_args(argv)
    if rest and rest[0] == "--":
        rest = rest[1:]
    return my, rest


@torch.no_grad()
def main(argv=None, warp: Warp = kernel_warp) -> dict:
    """Profile the run; returns the result (also printed, and written to
    --out). ``warp`` computes the substituted warps (the kernel route by
    default; the model's own forward always runs the renderer's)."""
    my, rest = parse(argv)
    opt = TestOptions().parse(rest, save=False)
    d = my.data
    opt.pose_path = f"{d}/openpose_json"
    opt.img_path = f"{d}/frames"
    opt.mask_path = f"{d}/mask"
    opt.densepose_path = f"{d}/densepose"
    opt.bg_path = f"{d}/bg.jpg"
    opt.texture_path = f"{d}/texture.png"
    opt.no_flip, opt.serial_batches, opt.batchSize = True, True, 1
    opt.use_densepose_loss = True          # the dataset emits dp_parts / uv
    opt.data_ratio = my.data_ratio
    S, P = opt.train_size, opt.n_parts
    k, eps = opt.warp_topk, opt.warp_eps
    dev = resolve_device(opt.gpu_ids)

    ds = dsm.FrameDataset(opt, "test")     # the held-out --data_ratio split
    assert 0 < len(ds) < len(dsm.list_images(opt.img_path)), (
        "test split selected the whole corpus: data_ratio mismatch (an "
        "unset data_ratio evaluates TRAINING frames as 'held-out')")
    n = min(len(ds), my.how_many)
    tex_np = dsm.load_texture_atlas(opt.texture_path, opt.tex_tile,
                                    opt.tex_rows, opt.tex_cols)
    bg_np = dsm.load_image(opt.bg_path, S)
    renderer = init_params(renderer_from_options(opt), opt.seed)
    path = ckpt.load_net_into(renderer, my.run_dir, "G", my.which_epoch)
    renderer = renderer.to(dev).eval()
    fwd = make_forward_fn(opt, renderer)
    tex, bg = atlas_tensor(tex_np, dev), nchw(bg_np, dev)
    tex_mask = None
    if opt.use_mask_texture:
        tex_mask = ((tex[0] + 1.0).abs().sum(1, keepdim=True) > 0.05).float()
    assets = (tex[0], bg[0], tex_mask)
    print(f"[profile] {n} held-out frames @ {S}px, G {path} on {dev}",
          flush=True)

    sums: Dict[str, List[float]] = {}
    exact = []
    for i in range(n):
        s = ds[i]
        joints = torch.from_numpy(s["joints"][None]).to(dev)
        onehot = one_hot(s["dp_parts"], P + 1, dev)
        gt_mask = 1.0 - onehot[:, :1]
        gt_uv = nchw(s["dp_uv"], dev)
        real = nchw(s["image"], dev)
        outs = fwd(assets, joints)
        var = {"full": outs["fake"]}
        fg_gt = gt_warp(warp, outs["texture"], gt_uv, onehot, k, eps)
        var["transg_gt"] = compose(gt_mask, fg_gt, outs["bg_refined"])
        fg_static = warp(tex, outs["uv"], outs["probs"], k, eps)
        var["texg_static"] = compose(outs["mask"], fg_static,
                                     outs["bg_refined"])
        var["mask_gt"] = compose(gt_mask, outs["fg"], outs["bg_refined"])
        var["bg_gt"] = compose(outs["mask"], outs["fg"], bg)
        var["all_gt_file"] = compose(
            gt_mask, gt_warp(warp, tex, gt_uv, onehot, k, eps), bg)
        onehot_e, mask_e, uv_e = exact_gt(s["joints"], S, P, dev)
        exact.append((onehot_e, mask_e, uv_e, real))
        var["all_gt_exact"] = compose(
            mask_e, gt_warp(warp, tex, uv_e, onehot_e, k, eps), bg)
        for name, v in var.items():
            p, ss = score(v, real)
            acc = sums.setdefault(name, [0.0, 0.0])
            acc[0] += p
            acc[1] += ss
        print(f"[profile] frame {i + 1}/{n} done", flush=True)

    table = {name: {"PSNR": v[0] / n, "SSIM": v[1] / n}
             for name, v in sums.items()}
    tiles = tile_ceiling(exact, bg, [int(t) for t in
                                     my.ceiling_tiles.split(",") if t],
                         P, k, eps, warp)
    result = {"config": {"data": my.data, "run_dir": my.run_dir,
                         "which_epoch": my.which_epoch, "frames": n,
                         "size": S, "tex_tile": opt.tex_tile},
              "variants": table, "tile_ceiling": tiles}
    print(json.dumps(result, indent=1))
    if my.out:
        os.makedirs(os.path.dirname(my.out) or ".", exist_ok=True)
        with open(my.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"-> {my.out}")
    return result


if __name__ == "__main__":
    main()
