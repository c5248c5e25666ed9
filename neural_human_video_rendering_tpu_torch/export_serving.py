"""Export the serving forward (keypoints -> frames) as a torch.export
program: the port of the JAX package's ``tools/export_serving.py``.

The whole forward, on-device pose rasterization, TransG, TexG, the texture
warp, BGNet and the composite, becomes one ``torch.export`` program that a
server loads and calls without the model code (``serve.py``):

    python -m neural_human_video_rendering_tpu_torch.export_serving \\
        --name run --checkpoints_dir ckpts --which_epoch 30 --batch 8 \\
        --out model.pt2 [sizing flags] [--gpu_ids -1 for the CPU]

The program maps joints (B, 18, 3) to frames (B, S, S, 3) in NHWC, the
JAX artifact's layout, quantized to uint8 on the device
(round((clip(x, -1, 1) + 1) * 127.5)) unless --raw_float. The static
texture, the background and the texel mask (--use_mask_texture) are
constants of the program. The texture warp is the port's operator
``nhvr_torch::texture_warp_topk_fwd`` (``nhvr_torch::topk_select`` and
``nhvr_torch::texture_warp_fwd`` under --warp_block_parts), one node of
the graph: whoever loads the program imports
``neural_human_video_rendering_tpu_torch.ops.texture_warp_kernel`` first,
which registers it.

Two weight modes, as the JAX tool's:
  default        the weights are the program's first input, a dict by
                 parameter name (G's state_dict names); they are written
                 to the ``<out>.params`` sidecar with torch.save, in
                 bfloat16 under --dtype bfloat16 (every conv casts its
                 weight to the bfloat16 activations, so the frames are the
                 same), and the server puts them on the card once.
  --bake_weights the weights are constants of the program: one
                 self-contained file.

The weights are G of --name's run dir at --which_epoch where the run dir
holds a numeric-epoch G file (.pth or the JAX package's .msgpack), else a
seeded random init. Like the JAX tool, it serves G, not G_ema. The
program is traced on the device --gpu_ids names (the card unless -1), so
an artifact made on the card serves on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .config import Options, _add_flags, resolve_device
from .data import dataset as dsm
from .infer.test_driver import assets_to_device
from .models.renderer import init_params, renderer_from_options
from .serve import SIDECAR
from .train.steps import build_pose_input
from .utils import checkpoint as ckpt


def quantize(frames: torch.Tensor) -> torch.Tensor:
    """[-1, 1] frames -> uint8 [0, 255]: round((clip + 1) * 127.5)."""
    return torch.round((frames.float().clamp(-1.0, 1.0) + 1.0)
                       * 127.5).to(torch.uint8)


class ServingProgram(nn.Module):
    """joints (B, 18, 3) -> frames (B, S, S, 3): build_pose_input (joints
    only), the renderer on the held assets, the NHWC layout and, with
    out_uint8, the quantization. With weights_as_input the renderer is not
    a submodule (its parameters are no part of the program): forward takes
    the weights by parameter name first, through
    torch.func.functional_call."""

    def __init__(self, opt, renderer: nn.Module, assets,
                 out_uint8: bool = True, weights_as_input: bool = False):
        super().__init__()
        self.opt = opt
        self.out_uint8 = out_uint8
        self.weights_as_input = weights_as_input
        if weights_as_input:
            self.__dict__["renderer"] = renderer      # not registered
        else:
            self.renderer = renderer
        static_tex, bg, tex_mask = assets
        self.register_buffer("static_tex", static_tex)
        self.register_buffer("bg", bg)
        self.register_buffer("tex_mask", tex_mask)

    def _inputs(self, joints: torch.Tensor):
        return (build_pose_input(self.opt, joints), self.bg[None],
                self.static_tex[None], self.tex_mask)

    def _frames(self, fake: torch.Tensor) -> torch.Tensor:
        fake = quantize(fake) if self.out_uint8 else fake.float()
        return fake.permute(0, 2, 3, 1).contiguous()

    def forward(self, *args) -> torch.Tensor:
        if not self.weights_as_input:
            (joints,) = args
            return self._frames(self.renderer(*self._inputs(joints))["fake"])
        params, joints = args
        return self._frames(torch.func.functional_call(
            self.renderer, params, self._inputs(joints), strict=True)["fake"])


def load_weights(opt, renderer: nn.Module) -> nn.Module:
    """G of --name's run dir at --which_epoch into `renderer` where the run
    dir holds a numeric-epoch G file; else the renderer keeps its seeded
    random init. Says which on stderr, as the JAX tool does."""
    run_dir = opt.run_dir
    if os.path.isdir(run_dir) and ckpt.latest_epoch(run_dir, "G"):
        path = ckpt.load_net_into(renderer, run_dir, "G", opt.which_epoch)
        print(f"[export] G epoch {opt.which_epoch} from {path}",
              file=sys.stderr)
    else:
        print("[export] no checkpoint found -> random-init weights",
              file=sys.stderr)
    return renderer


def sidecar_weights(opt, renderer: nn.Module) -> Dict[str, torch.Tensor]:
    """The renderer's parameters by name, bfloat16 under --dtype bfloat16
    (every conv casts its weight to the activations' dtype)."""
    params = {k: v.detach() for k, v in renderer.named_parameters()}
    if opt.dtype == "bfloat16":
        params = {k: v.bfloat16() if v.dtype == torch.float32 else v
                  for k, v in params.items()}
    return params


def build_exported(opt, batch: int, bake_weights: bool = True,
                   out_uint8: bool = False,
                   device: Optional[torch.device] = None):
    """-> (torch.export.ExportedProgram, example joints (B, 18, 3) on the
    device, G's weights by name). bake_weights: the program holds the
    weights, call(joints); else call(weights, joints) and the weights go
    to the sidecar. The assets and the example joints are those of the
    SyntheticDataset of `batch` samples, unless --texture_path / --bg_path
    name files, as in the JAX tool. Traced under torch.no_grad() on
    `device` (default --gpu_ids)."""
    dev = device if device is not None else resolve_device(opt.gpu_ids)
    ds = dsm.SyntheticDataset(opt, length=batch)
    tex = (dsm.load_texture_atlas(opt.texture_path, opt.tex_tile,
                                  opt.tex_rows, opt.tex_cols)
           if opt.texture_path and os.path.isfile(opt.texture_path)
           else ds.texture_atlas())
    bg = (dsm.load_image(opt.bg_path, opt.train_size)
          if opt.bg_path and os.path.isfile(opt.bg_path) else ds.background())
    renderer = load_weights(opt, init_params(renderer_from_options(opt),
                                             opt.seed))
    renderer = renderer.to(dev).eval()
    params = sidecar_weights(opt, renderer)
    program = ServingProgram(opt, renderer,
                             assets_to_device(opt, tex, bg, dev), out_uint8,
                             weights_as_input=not bake_weights)
    joints = torch.from_numpy(np.stack(
        [ds[i]["joints"] for i in range(batch)]).astype(np.float32)).to(dev)
    args = (joints,) if bake_weights else (params, joints)
    with torch.no_grad():
        exported = torch.export.export(program, args, strict=False)
    return exported, joints, params


def save_artifact(opt, batch: int, out_path: str, bake_weights: bool = False,
                  out_uint8: bool = True,
                  device: Optional[torch.device] = None) -> int:
    """Export and write the program (and, without bake_weights, the
    ``<out>.params`` sidecar); returns the bytes written."""
    exported, joints, params = build_exported(opt, batch, bake_weights,
                                              out_uint8, device)
    # the example inputs would carry a copy of the weights into the file
    exported.example_inputs = None
    torch.export.save(exported, out_path)
    total = os.path.getsize(out_path)
    if not bake_weights:
        torch.save({k: v.cpu() for k, v in params.items()},
                   out_path + SIDECAR)
        side = os.path.getsize(out_path + SIDECAR)
        total += side
        print(f"[export] params sidecar {out_path}{SIDECAR} "
              f"({side / 1e6:.1f} MB)", file=sys.stderr)
    S = opt.train_size
    print(f"wrote {out_path} ({os.path.getsize(out_path) / 1e6:.1f} MB), "
          f"input joints{tuple(joints.shape)} -> frame ({batch}, {S}, {S}, 3)"
          f" {'uint8' if out_uint8 else 'float32'}", flush=True)
    return total


def main(argv=None) -> int:
    p = argparse.ArgumentParser(conflict_handler="resolve")
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--bake_weights", action="store_true",
                   help="bake the weights into the program (self-contained, "
                        "big)")
    p.add_argument("--raw_float", action="store_true",
                   help="emit float frames instead of on-device uint8 "
                        "(uint8 moves 4x fewer bytes to the host)")
    _add_flags(p)
    a = p.parse_args(argv)
    opt = Options(**{f.name: getattr(a, f.name)
                     for f in dataclasses.fields(Options)
                     if hasattr(a, f.name)})
    opt.isTrain = False
    save_artifact(opt, a.batch, a.out, bake_weights=a.bake_weights,
                  out_uint8=not a.raw_float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
