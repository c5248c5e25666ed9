"""Pose-label rasterization as batched tensor ops (NCHW).

The port of the JAX package's ``data/rasterize.py``: OpenPose keypoints ->
a 3-channel skeleton image plus optional Gaussian joint heatmaps and
limb-local coordinate channels, computed on the device as vectorized
distance-to-segment passes over the pixel grid. Elementwise work, left to
PyTorch.
"""

from __future__ import annotations

import torch

from .keypoints import COCO18_LIMBS, LIMB_COLORS

_LIMBS_A = [a for a, _ in COCO18_LIMBS]
_LIMBS_B = [b for _, b in COCO18_LIMBS]


def _point_segment_dist2(px, py, ax, ay, bx, by):
    """Squared distance from the pixel grid to segment a-b (per sample)."""
    abx, aby = bx - ax, by - ay
    apx, apy = px - ax, py - ay
    denom = abx * abx + aby * aby
    t = torch.clamp((apx * abx + apy * aby) / torch.clamp(denom, min=1e-6),
                    0.0, 1.0)
    dx = apx - t * abx
    dy = apy - t * aby
    return dx * dx + dy * dy


# No tensor is made from host data here: a host copy inside a captured
# step (train/graphs.py) breaks its capture, and a constant made while
# torch.export traces the forward becomes a host-to-device copy inside the
# exported program. The limbs' joints are taken by Python index and their
# colours enter as Python numbers.
_COLORS = [[float(c) for c in row] for row in LIMB_COLORS]


def render_skeleton(joints: torch.Tensor, height: int, width: int,
                    radius: float = 4.0,
                    conf_thresh: float = 0.05) -> torch.Tensor:
    """(B, 18, 3) COCO-18 joints (x, y, confidence in canvas pixels) ->
    (B, 3, H, W) skeleton image in [-1, 1].

    Background is -1; limbs carry the OpenPose rainbow color. A running
    minimum over the limbs with a strict ``<`` gives each pixel to its
    nearest limb, ties to the earlier one. Limbs with an endpoint at or
    below ``conf_thresh`` do not draw.
    """
    joints = joints.float()
    B, dev = joints.shape[0], joints.device
    py = torch.arange(height, dtype=torch.float32, device=dev).view(1, height, 1)
    px = torch.arange(width, dtype=torch.float32, device=dev).view(1, 1, width)
    best_d2 = torch.full((B, height, width), float("inf"), device=dev)
    planes = [torch.zeros((B, height, width), device=dev) for _ in range(3)]
    for i, (ja, jb) in enumerate(zip(_LIMBS_A, _LIMBS_B)):
        ai = joints[:, ja].view(B, 3, 1, 1)
        bi = joints[:, jb].view(B, 3, 1, 1)
        d2 = _point_segment_dist2(px, py, ai[:, 0], ai[:, 1], bi[:, 0], bi[:, 1])
        valid = (ai[:, 2] > conf_thresh) & (bi[:, 2] > conf_thresh)
        d2 = torch.where(valid, d2, float("inf"))
        upd = d2 < best_d2
        best_d2 = torch.where(upd, d2, best_d2)
        planes = [torch.where(upd, c, p) for c, p in zip(_COLORS[i], planes)]
    hit = (best_d2 <= radius * radius)[:, None]
    return torch.where(hit, torch.stack(planes, 1), 0.0) * 2.0 - 1.0


def joint_heatmaps(joints: torch.Tensor, height: int, width: int,
                   sigma: float = 6.0) -> torch.Tensor:
    """(B, 18, 3) joints -> (B, 18, H, W) Gaussian heatmaps (0 where the
    joint's confidence is at or below 0.05)."""
    joints = joints.float()
    dev = joints.device
    ys = torch.arange(height, dtype=torch.float32, device=dev).view(1, 1, height, 1)
    xs = torch.arange(width, dtype=torch.float32, device=dev).view(1, 1, 1, width)
    jx = joints[:, :, 0, None, None]
    jy = joints[:, :, 1, None, None]
    conf = joints[:, :, 2, None, None]
    dx = xs - jx
    dy = ys - jy
    hm = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    return torch.where(conf > 0.05, hm, 0.0)


def limb_coord_maps(joints: torch.Tensor, height: int, width: int,
                    sigma: float = 12.0,
                    conf_thresh: float = 0.05) -> torch.Tensor:
    """(B, 18, 3) joints -> (B, 2L, H, W) limb-local coordinate channels
    (--limb_coords), L = 17 limbs.

    Per limb i two channels, both enveloped by a Gaussian w of the
    distance to the segment (so w doubles as a soft limb mask):
      channel 2i:     w * (2t - 1), t the position along the segment in [0, 1];
      channel 2i + 1: w * side * d / sigma, d the distance to the segment's
                      closest point, side the sign of the cross product
                      ab x ap (which side of the limb).
    Limbs with an endpoint at or below ``conf_thresh`` give zeros, as in
    render_skeleton.
    """
    joints = joints.float()
    B, dev = joints.shape[0], joints.device
    py = torch.arange(height, dtype=torch.float32, device=dev).view(1, height, 1)
    px = torch.arange(width, dtype=torch.float32, device=dev).view(1, 1, width)
    chans = []
    for ja, jb in zip(_LIMBS_A, _LIMBS_B):
        ai = joints[:, ja].view(B, 3, 1, 1)
        bi = joints[:, jb].view(B, 3, 1, 1)
        abx, aby = bi[:, 0] - ai[:, 0], bi[:, 1] - ai[:, 1]
        apx, apy = px - ai[:, 0], py - ai[:, 1]
        denom = torch.clamp(abx * abx + aby * aby, min=1e-6)
        t = torch.clamp((apx * abx + apy * aby) / denom, 0.0, 1.0)
        dx = apx - t * abx
        dy = apy - t * aby
        d = torch.sqrt(dx * dx + dy * dy + 1e-12)
        side = torch.sign(abx * apy - aby * apx)
        w = torch.exp(-(d * d) / (2.0 * sigma * sigma))
        valid = (ai[:, 2] > conf_thresh) & (bi[:, 2] > conf_thresh)
        w = torch.where(valid, w, 0.0)
        chans.append(w * (2.0 * t - 1.0))
        chans.append(w * side * (d / sigma))
    return torch.stack(chans, dim=1)
