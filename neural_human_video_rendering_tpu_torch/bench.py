"""Benchmark: stage-2 train steps/s at 512 px, batch 2, and batched
inference frames/s, on the card (the port of the JAX package's bench.py).

    python -m neural_human_video_rendering_tpu_torch.bench [--ckpt auto]

The operating point is that bench's: the reference launchers' model
(TransG ngf 64 / 4 down / 9 blocks, TexG 48 / 2 / 10, BGNet 2 / 2, the
two-scale PatchGAN ndf 64), --tex_tile 128 (or the checkpoint recipe's),
the GAN + feature-matching + VGG + L2 + DensePose + temporal losses
(temporal_prev fake: the t-1 frame rendered again without gradient),
bf16 convs, the warp's texture rounded to bf16 (--warp_dtype), and the
Options defaults otherwise (no pose heatmaps, no coord conv, no EMA): not
chip_smoke's flagship recipe. The step runs on one SyntheticDataset batch,
packed as the trainer's loader packs it and uploaded by the step as its
first op; one warm-up step, then the better of two rounds of 20 steps,
each round between two ``torch.cuda.synchronize()``. Inference: 8 frames
a batch through the state's live G, one warm-up, then 20 forwards between
two synchronises.

--ckpt auto loads a trained G (and D where saved) from checkpoints/flagship
or checkpoints/r4/e2e_base when either holds one (the port's .pth first,
then the JAX package's .msgpack), with the recipe's model-shape flags;
else random init. It prints one JSON line: metric
train_steps_per_sec_512px_bs2, value, unit, inference_fps, regime. (The
JAX bench's vs_baseline, a ratio to a guessed V100 rate, is not carried.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import Options, resolve_device
from .data import dataset as dsm
from .data.wire import pack_batch
from .train.state import create_train_state
from .train.steps import make_forward_fn, make_train_step
from .utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUTO_DIRS = ("checkpoints/flagship", "checkpoints/r4/e2e_base")

# a checkpoint recipe's model-shape flags, applied so its weights load;
# performance knobs and loss weights stay the bench's
_SHAPE_KEYS = (
    "pose_heatmaps", "heatmap_sigma", "coord_conv", "limb_coords",
    "limb_sigma", "n_joints", "use_laplace", "pose_plus_laplace",
    "laplace_nc", "netG", "n_local_enhancers", "n_blocks_local",
    "ngf", "n_downsample_global", "n_blocks_global", "ngf_global",
    "n_blocks_translate", "n_downsample_translate", "uv_refine",
    "uv_refine_ngf", "ms_uv", "n_downsample_bg", "n_blocks_bg", "TexG",
    "use_mask_texture", "instance_feat", "label_feat", "feat_num",
    "nef", "n_downsample_E", "num_D", "n_layers_D", "ndf", "n_parts",
    "tex_rows", "tex_cols", "stem_s2d", "head_s2d", "bg_s2d",
    "pad_mode", "upsample_mode",
)


def resolve_checkpoint(repo: str, ckpt_arg: str) -> Tuple[str, dict, str]:
    """--ckpt -> (run dir, the recipe's config, provenance).

    'auto' takes the first of AUTO_DIRS under `repo` that holds a latest G
    (``utils/checkpoint.find_net``: .pth, then .msgpack); '' forces random
    init. The provenance names what the weights are: the last epoch in the
    dir's metrics.jsonl and its last held-out PSNR ('ep22,val27.2dB'),
    'ep?' without one. File reads only."""
    if ckpt_arg == "auto":
        ckpt_arg = ""
        for cand in AUTO_DIRS:
            d = os.path.join(repo, cand)
            if ckpt.find_net(d, "G", "latest") is not None:
                ckpt_arg = d
                break
    recipe_cfg, prov = {}, ""
    if ckpt_arg:
        try:
            with open(os.path.join(ckpt_arg, "recipe.json")) as f:
                recipe_cfg = json.load(f).get("config", {})
        except (OSError, ValueError):
            pass
        ep, val = None, None
        try:
            with open(os.path.join(ckpt_arg, "metrics.jsonl")) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue          # a torn line
                    if "epoch" in rec:
                        ep = max(ep or 0, int(rec["epoch"]))
                    if "val_PSNR" in rec:
                        val = rec["val_PSNR"]
        except OSError:
            pass
        prov = "ep?" if ep is None else f"ep{ep}"
        if val is not None:
            prov += f",val{val:.1f}dB"
    return ckpt_arg, recipe_cfg, prov


def load_bench_state(ckpt_dir: str, state):
    """Load the run dir's latest G (required) and D (optional) into the
    train state, in place; returns (state, regime suffix). A dir without a
    D keeps the random D and marks the regime '+randD': D barely moves the
    step's time, and a missing file must not stop the bench."""
    ckpt.load_net_into(state.renderer, ckpt_dir, "G", "latest")
    if ckpt.find_net(ckpt_dir, "D", "latest") is not None:
        ckpt.load_net_into(state.disc, ckpt_dir, "D", "latest")
        return state, ""
    print("bench: checkpoint has no D net - keeping random-init D",
          file=sys.stderr, flush=True)
    return state, "+randD"


def bench_options(tex_tile: int, warp_dtype: str, gpu_ids: str = "0",
                  recipe_cfg: Optional[dict] = None) -> Options:
    """The bench's operating point (the reference's test_start/start.sh
    and pretrain_start.sh sizing), then the recipe's shape flags."""
    opt = Options(
        loadSize=512, batchSize=2, tex_tile=tex_tile,
        ngf=64, n_downsample_translate=4, n_blocks_translate=9,
        ngf_global=48, n_downsample_global=2, n_blocks_global=10,
        n_downsample_bg=2, n_blocks_bg=2,
        num_D=2, n_layers_D=3, ndf=64,
        lambda_L2=500, lambda_UV=1000, lambda_Prob=10, lambda_Temp=500,
        use_densepose_loss=True, dtype="bfloat16", warp_dtype=warp_dtype,
        gpu_ids=gpu_ids)
    for k in _SHAPE_KEYS:
        if k in (recipe_cfg or {}):
            setattr(opt, k, recipe_cfg[k])
    return opt


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_steps_per_sec(opt, device: torch.device, ckpt_dir: str = "",
                        iters: int = 20, rounds: int = 2):
    """Train steps/s of the stage-2 step at `opt` on one batch: one
    warm-up step, then the better of `rounds` rounds of `iters` steps,
    each between two synchronises. Returns (steps/s, the TrainState after
    the steps, its metrics the last step's losses, and the regime suffix
    of load_bench_state)."""
    ds = dsm.SyntheticDataset(opt, length=opt.batchSize)
    batch = pack_batch(dsm.collate([ds[i] for i in range(opt.batchSize)]))
    state = create_train_state(opt, ds.texture_atlas(), ds.background(),
                               device=device)
    suffix = ""
    if ckpt_dir:
        state, suffix = load_bench_state(ckpt_dir, state)
    step = make_train_step(opt, state.renderer, state.disc, state.vgg,
                           state.g_opt, state.d_opt)
    t0 = time.perf_counter()
    metrics = step(state, batch)
    _sync(device)
    print(f"# first step: {time.perf_counter() - t0:.1f}s  device: "
          f"{device}", file=sys.stderr, flush=True)
    if not all(np.isfinite(float(v)) for v in metrics.values()):
        raise FloatingPointError(f"bench step: non-finite losses {metrics}")
    best = float("inf")
    for _ in range(rounds):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            state.metrics = step(state, batch)
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    return 1.0 / best, state, suffix


def inference_fps(opt, renderer, assets, device: torch.device,
                  batch: int = 8, iters: int = 20, rounds: int = 1) -> float:
    """Frames/s of the batched inference forward (keypoints -> frame) of
    `renderer` on `assets` ((static_tex, bg, tex_mask) on `device`) at
    `batch` frames: one warm-up forward, then the better of `rounds`
    rounds of `iters` forwards, each between two synchronises."""
    renderer.eval()
    fwd = make_forward_fn(opt, renderer)
    ids = dsm.SyntheticDataset(opt, length=batch)
    joints = torch.from_numpy(np.stack([ids[i]["joints"]
                                        for i in range(batch)])).to(device)
    out = fwd(assets, joints)["fake"]
    _sync(device)
    if not bool(torch.isfinite(out).all()):
        raise FloatingPointError("bench forward: non-finite frames")
    best = float("inf")
    for _ in range(rounds):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fwd(assets, joints)
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    return batch / best


def bench_line(steps_per_sec: float, fps: float, regime: str) -> Dict:
    return {"metric": "train_steps_per_sec_512px_bs2",
            "value": round(steps_per_sec, 4), "unit": "steps/s",
            "inference_fps": round(fps, 2), "regime": regime}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default="auto", help=(
        "run dir of a trained checkpoint (the trained regime: peaked part "
        "probabilities); 'auto' takes the durable flagship under "
        "checkpoints/ where one exists, else random init; '' forces "
        "random init"))
    ap.add_argument("--tex_tile", type=int, default=0, help=(
        "texture tile; 0 = the checkpoint recipe's value, else 128"))
    ap.add_argument("--warp_dtype", default="bfloat16",
                    choices=["float32", "bfloat16"], help=(
                        "bfloat16 rounds the warp's texture to bf16 once "
                        "(the sampling and blend stay float32)"))
    ap.add_argument("--gpu_ids", default="0",
                    help="the CUDA device index; -1 for the CPU")
    ns = ap.parse_args(argv)

    regime = "randinit"
    ckpt_dir, recipe_cfg, prov = resolve_checkpoint(REPO, ns.ckpt)
    if not ckpt_dir:
        print("bench: no durable flagship checkpoint found - measuring "
              "random init", file=sys.stderr, flush=True)
    else:
        regime = f"trained({prov})"
        if ns.tex_tile == 0 and "tex_tile" in recipe_cfg:
            ns.tex_tile = int(recipe_cfg["tex_tile"])
    if ns.tex_tile == 0:
        ns.tex_tile = 128
    regime += {"bfloat16": "+bf16warp", "float32": ""}[ns.warp_dtype]
    print(f"# regime: {regime}  ckpt: {ckpt_dir or '-'}  "
          f"tex_tile: {ns.tex_tile}", file=sys.stderr, flush=True)
    device = resolve_device(ns.gpu_ids)
    opt = bench_options(ns.tex_tile, ns.warp_dtype, ns.gpu_ids, recipe_cfg)
    sps, state, suffix = train_steps_per_sec(opt, device, ckpt_dir)
    regime += suffix
    # the live G and the state's assets after the train steps, as the JAX
    # bench serves them
    fps = inference_fps(opt, state.renderer,
                        (state.static_tex, state.bg, state.tex_mask), device)
    print(json.dumps(bench_line(sps, fps, regime)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
