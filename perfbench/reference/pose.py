"""The generator's pose input from OpenPose COCO-18 joints, in plain
PyTorch: the skeleton render, the joint heatmaps and the coord-conv
ramps."""

from __future__ import annotations

import torch

LIMBS = (
    (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7),
    (1, 8), (8, 9), (9, 10), (1, 11), (11, 12), (12, 13),
    (1, 0), (0, 14), (14, 16), (0, 15), (15, 17),
)
LIMB_COLORS = (
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
    (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
    (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
    (255, 0, 255), (255, 0, 170),
)
CONF = 0.05


def _grid(joints: torch.Tensor, S: int):
    py = torch.arange(S, dtype=torch.float32, device=joints.device)
    return py.view(1, 1, S), py.view(1, S, 1)


def skeleton(joints: torch.Tensor, S: int, radius: float = 4.0
             ) -> torch.Tensor:
    """(B, 18, 3) -> (B, 3, S, S) in [-1, 1]: each pixel takes the colour
    of its nearest limb within `radius` (ties to the earlier limb)."""
    B = joints.shape[0]
    px, py = _grid(joints, S)
    best = torch.full((B, S, S), float("inf"), device=joints.device)
    colour = torch.zeros((B, 3, S, S), device=joints.device)
    for (a, b), rgb in zip(LIMBS, LIMB_COLORS):
        ax, ay, ac = (joints[:, a, i].view(B, 1, 1) for i in range(3))
        bx, by, bc = (joints[:, b, i].view(B, 1, 1) for i in range(3))
        abx, aby = bx - ax, by - ay
        apx, apy = px - ax, py - ay
        t = torch.clamp((apx * abx + apy * aby)
                        / torch.clamp(abx * abx + aby * aby, min=1e-6),
                        0.0, 1.0)
        d2 = (apx - t * abx) ** 2 + (apy - t * aby) ** 2
        d2 = torch.where((ac > CONF) & (bc > CONF), d2, float("inf"))
        closer = d2 < best
        best = torch.where(closer, d2, best)
        c = torch.tensor(rgb, dtype=torch.float32,
                         device=joints.device).view(1, 3, 1, 1) / 255.0
        colour = torch.where(closer[:, None], c, colour)
    hit = (best <= radius * radius)[:, None]
    return torch.where(hit, colour, 0.0) * 2.0 - 1.0


def heatmaps(joints: torch.Tensor, S: int, sigma: float) -> torch.Tensor:
    """(B, 18, 3) -> (B, 18, S, S) Gaussians in [-1, 1] (-1 where the
    joint's confidence is at or below CONF)."""
    px, py = _grid(joints, S)
    jx, jy, jc = (joints[:, :, i, None, None] for i in range(3))
    hm = torch.exp(-((px[:, None] - jx) ** 2 + (py[:, None] - jy) ** 2)
                   / (2.0 * sigma * sigma))
    return torch.where(jc > CONF, hm, 0.0) * 2.0 - 1.0


def pose_input(cfg, joints: torch.Tensor) -> torch.Tensor:
    S, B = cfg.size, joints.shape[0]
    joints = joints.float()
    chans = [skeleton(joints, S)]
    if cfg.pose_heatmaps:
        chans.append(heatmaps(joints, S, cfg.heatmap_sigma))
    if cfg.coord_conv:
        ramp = torch.linspace(-1.0, 1.0, S, device=joints.device)
        chans.append(ramp.view(1, 1, 1, S).expand(B, 1, S, S))
        chans.append(ramp.view(1, 1, S, 1).expand(B, 1, S, S))
    return torch.cat(chans, dim=1)
