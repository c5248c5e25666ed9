"""Secondary benchmark: 512 px inference frames/s on the card (the port of
the JAX package's bench_infer.py).

    python -m neural_human_video_rendering_tpu_torch.bench_infer

The full keypoints -> frame forward (pose rasterisation, TransG, TexG, the
fused texture warp, BGNet, the composite) at the reference inference
sizing (test_start/start.sh: tile 128, TransG 64 / 4 / 9, TexG 48 / 2 /
10, bf16) with random weights, no discriminator, batch 8: one warm-up,
then the better of two rounds of 20 forwards, each between two
synchronises. Prints one JSON line: inference_fps_512px, and vs_baseline
= frames/s over 30 (real-time video).
"""

from __future__ import annotations

import argparse
import json
import sys

from .bench import inference_fps
from .config import Options, resolve_device
from .data.dataset import SyntheticDataset
from .infer.test_driver import assets_to_device
from .models.renderer import init_params, renderer_from_options

REALTIME_FPS = 30.0


def infer_options(gpu_ids: str = "0") -> Options:
    """The reference inference sizing (test_start/start.sh) at batch 8."""
    return Options(loadSize=512, batchSize=8, tex_tile=128,
                   ngf=64, n_downsample_translate=4, n_blocks_translate=9,
                   ngf_global=48, n_downsample_global=2, n_blocks_global=10,
                   n_downsample_bg=2, n_blocks_bg=2, dtype="bfloat16",
                   gpu_ids=gpu_ids)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gpu_ids", default="0",
                    help="the CUDA device index; -1 for the CPU")
    ns = ap.parse_args(argv)
    opt = infer_options(ns.gpu_ids)
    batch = opt.batchSize
    device = resolve_device(opt.gpu_ids)
    ds = SyntheticDataset(opt, length=batch)
    renderer = init_params(renderer_from_options(opt), opt.seed).to(device)
    assets = assets_to_device(opt, ds.texture_atlas(), ds.background(),
                              device)
    fps = inference_fps(opt, renderer, assets, device, batch=batch, rounds=2)
    print(json.dumps({"metric": "inference_fps_512px", "value": round(fps, 2),
                      "unit": "frames/s",
                      "vs_baseline": round(fps / REALTIME_FPS, 3)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
