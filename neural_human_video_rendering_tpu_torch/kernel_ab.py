#!/usr/bin/env python3
"""Device time of the train step's flow warp and warp backward kernels of
one checkout of the port, so that two checkouts (a parent commit unpacked
into a git-ignored directory, and this one) are compared on one card:

    python3 neural_human_video_rendering_tpu_torch/kernel_ab.py --tree DIR

DIR is the root of a checkout (default: this one); its package and its
csrc/ are the ones timed, built into DIR/build/kernels. The inputs, the
timing (20 calls in a CUDA graph, replayed between CUDA events) and the
grid_sample yardstick are this checkout's chip_smoke.py's, at the train
step's shapes: the flow warp at B=2, C=5, 512x512 on an i.i.d. noise flow
and on a smooth flow, the backward at B=2, P=24, T=64, k=4, eps 1e-3 on
random uv. Run parent, change, change, parent in one command. Prints one
JSON line; exits non-zero without a CUDA card.
"""

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT, help="root of the checkout timed")
    tree = os.path.abspath(ap.parse_args().tree)
    # the timed checkout's package, not this script's directory
    sys.path[0] = tree
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    from neural_human_video_rendering_tpu_torch.ops import flow_warp_kernel as fk
    from neural_human_video_rendering_tpu_torch.ops import \
        texture_warp_kernel as tk
    if not fk.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {fk.__file__}, not from {tree}")
    dev = torch.device("cuda", 0)
    img, noise = smoke.flow_inputs(torch, 2, 512, 5, dev)
    flows = {"noise": noise, "smooth": smoke.smooth_flow(torch, noise)}
    out = {"tree": os.path.relpath(tree, ROOT)}
    for name, fl in flows.items():
        grid = smoke.flow_grid(torch, fl)
        out[f"flow_{name}_ms"] = smoke.graph_ms(
            torch, lambda: fk.flow_warp_fwd(img, fl))
        out[f"grid_sample_{name}_ms"] = smoke.graph_ms(
            torch, lambda: smoke.flow_library(torch, img, grid))
    tex, uv, probs = smoke.warp_inputs(torch, 2, 24, 512, 512, 64, 4, dev)
    fg, u, v = smoke.planes(uv, probs)
    w = tk.topk_select(fg, 4, 0, 1e-3)
    g = torch.randn((2, 3, fg.shape[2]), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(9))
    out["bwd_ms"] = smoke.graph_ms(
        torch, lambda: tk.texture_warp_bwd(tex, u, v, w, g))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
