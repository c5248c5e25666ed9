"""Inputs made from the seed: weights, the person's assets, training
batches and driving poses.

Everything is drawn on the device from one ``torch.Generator`` per use, in
a few large calls, then handed to the program and to the reference alike.
Training batches end on the host in the trainer's wire format (uint8
images and masks, uint8 DensePose parts and UV, float16 flows, float32
joints; NHWC), in pageable memory, as the trainer's loader hands them to
the step.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

# OpenPose COCO-18 joints of a standing person on a 512 px canvas
CANONICAL = (
    (256, 90), (256, 140), (216, 140), (200, 210), (196, 270), (296, 140),
    (312, 210), (316, 270), (232, 280), (228, 360), (226, 440), (280, 280),
    (284, 360), (286, 440), (246, 80), (266, 80), (236, 88), (276, 88))

SALT = {"G": 0, "D": 1, "VGG": 2, "assets": 3, "train": 4, "drive": 5}


def generator(seed: int, use: str, device) -> torch.Generator:
    """A generator for one use of one seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 8 + SALT[use]) % (2 ** 63 - 1))
    return g


def make_weights(module: torch.nn.Module, seed: int, device,
                 stream: str) -> Dict[str, torch.Tensor]:
    """Float32 weights for every parameter of `module` (names and shapes
    read from it), drawn from the seed's `stream` ("G", "D" or "VGG"):
    conv kernels a normal of variance 1/fan_in cut at two
    deviations (flax's lecun_normal), biases zero. One draw on the device
    for all the kernels."""
    named = list(module.named_parameters())
    kernels = [(n, p) for n, p in named if p.dim() == 4]
    sizes = [p.numel() for _, p in kernels]
    flat = torch.randn(sum(sizes), generator=generator(seed, stream, device),
                       device=device).clamp_(-2.0, 2.0)
    stds = []
    for n, p in kernels:
        transposed = isinstance(module.get_submodule(n.rsplit(".", 1)[0]),
                                torch.nn.ConvTranspose2d)
        fan_in = (p.shape[0] if transposed else p.shape[1]) * p.shape[2] \
            * p.shape[3]
        stds.append(math.sqrt(1.0 / fan_in) / 0.87962566103423978)
    scale = torch.repeat_interleave(
        torch.tensor(stds, device=device),
        torch.tensor(sizes, device=device))
    flat.mul_(scale)
    out = dict(zip((n for n, _ in kernels),
                   (t.view(p.shape) for t, (_, p) in
                    zip(flat.split(sizes), kernels))))
    for n, p in named:
        if n not in out:
            out[n] = torch.zeros(p.shape, device=device)
    return out


TEXG_HEAD_SCALE = 0.01


def generator_weights(G: torch.nn.Module, seed: int, device
                      ) -> Dict[str, torch.Tensor]:
    """The renderer's weights: ``make_weights``, with the output conv of
    the texture generator drawn at a hundredth of that scale, so the
    texture starts near the static atlas (TexG adds a residual to it).
    A full-scale random residual head makes a texture of texel-sized
    noise, on which rounding's shift of a sample's (u, v) by a fraction
    of a texel changes its colour by as much as the texture's range: the
    frames and losses of any two precisions then differ by about as
    much, and the float8 control by hardly more than the program."""
    w = make_weights(G, seed, device, "G")
    head = G.TexG.backbone.head.Conv_0.weight
    name = next(n for n, p in G.named_parameters() if p is head)
    w[name].mul_(TEXG_HEAD_SCALE)
    return w


def _smooth(g: torch.Generator, n: int, C: int, H: int, W: int, device,
            waves: int = 4, amp: float = 0.35) -> torch.Tensor:
    """(n, C, H, W) sums of `waves` random plane waves a channel."""
    f = torch.rand((n, C, waves, 2), generator=g, device=device) * 6.0 + 1.0
    ph = torch.rand((n, C, waves, 1, 1), generator=g, device=device) * 6.283
    sgn = torch.randint(0, 2, (n, C, waves, 2), generator=g,
                        device=device) * 2 - 1
    f = f * sgn
    yy = torch.linspace(0, 1, H, device=device).view(1, 1, 1, H, 1)
    xx = torch.linspace(0, 1, W, device=device).view(1, 1, 1, 1, W)
    arg = f[..., 0, None, None] * xx + f[..., 1, None, None] * yy + ph
    return torch.sin(arg).sum(2) * (amp / math.sqrt(waves))


def assets(seed: int, size: int, tile: int, parts: int, device):
    """(static_tex (P, 3, T, T), bg (3, S, S)) in [-1, 1]: smooth colour
    fields, the atlas of one person and the static background."""
    g = generator(seed, "assets", device)
    tex = (_smooth(g, parts, 3, tile, tile, device, amp=0.6)
           + torch.rand((parts, 3, 1, 1), generator=g, device=device) * 0.6
           - 0.3).clamp_(-1.0, 1.0)
    bg = (_smooth(g, 1, 3, size, size, device)[0]).clamp_(-1.0, 1.0)
    return tex, bg


def poses(g: torch.Generator, n: int, size: int, device) -> torch.Tensor:
    """(n, 18, 3) joints: the canonical person moved, scaled and bent by
    a random amount each, confidence 1."""
    base = torch.tensor(CANONICAL, dtype=torch.float32, device=device) \
        * (size / 512.0)
    centre = base.mean(0)
    scale = 0.85 + 0.25 * torch.rand((n, 1, 1), generator=g, device=device)
    shift = (torch.rand((n, 1, 2), generator=g, device=device) - 0.5) \
        * (0.16 * size)
    jitter = (torch.rand((n, 18, 2), generator=g, device=device) - 0.5) \
        * (0.05 * size)
    xy = (base - centre) * scale + centre + shift + jitter
    xy = xy.clamp(4.0, size - 4.0)
    return torch.cat([xy, torch.ones((n, 18, 1), device=device)], dim=2)


def _frames(g, joints: torch.Tensor, size: int, device):
    """Frames, masks, DensePose parts and UV of a pose batch."""
    n = joints.shape[0]
    S = size
    ys = torch.arange(S, dtype=torch.float32, device=device).view(1, 1, S, 1)
    xs = torch.arange(S, dtype=torch.float32, device=device).view(1, 1, 1, S)
    d2 = (xs - joints[:, :, 0, None, None]) ** 2 \
        + (ys - joints[:, :, 1, None, None]) ** 2            # (n, 18, S, S)
    best, nearest = d2.min(dim=1)
    mask = best < (0.09 * S) ** 2
    offset = torch.randint(0, 24, (n, 1, 1), generator=g, device=device)
    parts = torch.where(mask, (nearest + offset) % 24 + 1, 0)
    xs2, ys2 = xs[0] / S, ys[0] / S
    uv = torch.stack([torch.remainder(xs2 + 0.1 * nearest, 1.0),
                      torch.remainder(ys2 + 0.07 * nearest, 1.0)], dim=-1)
    uv = torch.where(mask[..., None], uv, 0.0)
    img = _smooth(g, n, 3, S, S, device)
    person = _smooth(g, n, 3, S, S, device, amp=0.5) + 0.3
    img = torch.where(mask[:, None], person, img).clamp_(-1.0, 1.0)
    return img, mask, parts, uv


def _u8_sym(x: torch.Tensor) -> torch.Tensor:
    return torch.round((x + 1.0) * 127.5).to(torch.uint8)


def train_batches(seed: int, count: int, batch: int, size: int, device
                  ) -> List[Dict[str, np.ndarray]]:
    """`count` distinct host wire batches of `batch` rows each."""
    g = generator(seed, "train", device)
    out = []
    for _ in range(count):
        j = poses(g, batch, size, device)
        motion = (torch.rand((batch, 1, 2), generator=g, device=device)
                  - 0.5) * 8.0
        jp = j.clone()
        jp[:, :, :2] = (j[:, :, :2] - motion).clamp(4.0, size - 4.0)
        img, mask, parts, uv = _frames(g, j, size, device)
        img_prev = torch.roll(img, shifts=(-1, -1), dims=(2, 3))
        flow = motion.view(batch, 1, 1, 2).expand(batch, size, size, 2)
        nhwc = {
            "joints": j, "joints_prev": jp,
            "image": _u8_sym(img).permute(0, 2, 3, 1),
            "image_prev": _u8_sym(img_prev).permute(0, 2, 3, 1),
            "mask": (mask[..., None].to(torch.uint8) * 255),
            "dp_parts": parts.to(torch.uint8),
            "dp_uv": torch.round(uv * 255.0).to(torch.uint8),
            "flow": flow.half(), "flow_inv": (-flow).half(),
        }
        out.append({k: v.contiguous().cpu().numpy() for k, v in nhwc.items()})
    return out


def driving_sequence(seed: int, count: int, batch: int, size: int, device
                     ) -> np.ndarray:
    """(count, batch, 18, 3) float32 host joints of a driving sequence."""
    g = generator(seed, "drive", device)
    return poses(g, count * batch, size, device).view(
        count, batch, 18, 3).cpu().numpy()
