"""Convert a pix2pixHD PyTorch subnet checkpoint (.pth or .npz state_dict)
into the port's checkpoint format: the port of the JAX package's
``tools/import_torch_checkpoint.py``.

    python -m neural_human_video_rendering_tpu_torch.import_torch_checkpoint \\
        30_net_TransG.pth --label TransG --epoch 30 --out_dir ckpts/dance15 \\
        --n_blocks_translate 5 [other sizing flags of the checkpoint]

Writes ``{out_dir}/{epoch}_net_{label}.pth`` and the ``latest`` copy, the
state_dict of the port's subnet of that label (TransG, TexG or BGNet),
which --load_pretrain_TransG / --which_epoch_TransG (TransG) load. The
subnet is built with the checkpoint's sizing flags in pix2pixHD's
topology (pad_mode reflect, upsample_mode deconv, s2d 1, whatever the
flags say), as the JAX tool does; its GlobalGenerator takes the converted
weights (``utils/torch_import``).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from .config import Options, _add_flags
from .models.renderer import init_params, renderer_from_options
from .utils import checkpoint as ckpt
from .utils.torch_import import (global_generator_state_dict,
                                 load_torch_state_dict)

LABELS = ("TransG", "TexG", "BGNet")


def parity_options(opt):
    """`opt` in pix2pixHD's topology: reflect padding, transposed-conv
    upsamples, no space-to-depth, one GlobalGenerator (--netG global), no
    refine stack or aux heads."""
    return dataclasses.replace(opt, pad_mode="reflect", upsample_mode="deconv",
                               stem_s2d=1, head_s2d=1, bg_s2d=1,
                               netG="global", uv_refine=0, ms_uv=0)


def import_checkpoint(path: str, label: str, opt):
    """The port's `label` subnet (float32, on the CPU) with the pix2pixHD
    GlobalGenerator of the checkpoint at `path` in its backbone."""
    opt = dataclasses.replace(parity_options(opt), dtype="float32")
    net = init_params(getattr(renderer_from_options(opt), label), opt.seed)
    name = net.backbone_name if hasattr(net, "backbone_name") \
        else "GlobalGenerator_0"
    converted = global_generator_state_dict(
        load_torch_state_dict(path), getattr(net, name), f"{name}.")
    net.load_state_dict({**net.state_dict(), **converted}, strict=True)
    return net


def main(argv=None) -> int:
    p = argparse.ArgumentParser(conflict_handler="resolve")
    p.add_argument("checkpoint", help=".pth or .npz state_dict")
    p.add_argument("--label", default="TransG", choices=LABELS)
    p.add_argument("--epoch", default="latest")
    p.add_argument("--out_dir", required=True)
    _add_flags(p)
    a = p.parse_args(argv)
    opt = Options(**{f.name: getattr(a, f.name)
                     for f in dataclasses.fields(Options)
                     if hasattr(a, f.name)})
    net = import_checkpoint(a.checkpoint, a.label, opt)
    path = ckpt.save_net(a.out_dir, a.label, a.epoch, net.state_dict())
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
