"""Pose-input assembly and the inference forward.

Port of the serving half of the JAX package's ``train/steps.py``
(``build_pose_input``, ``make_forward_fn``); the train steps come with the
training slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..data.rasterize import joint_heatmaps, render_skeleton


def build_pose_input(opt, joints: torch.Tensor) -> torch.Tensor:
    """(B, 18, 3) joints -> (B, pose_nc, S, S) float32 pose labels.

    Channel order: the 3-channel skeleton render, then (--pose_heatmaps)
    18 joint heatmaps mapped to [-1, 1], then (--coord_conv) the x ramp and
    the y ramp in [-1, 1].
    """
    S = opt.train_size
    B, dev = joints.shape[0], joints.device
    chans = []
    if opt.use_pose_render:
        chans.append(render_skeleton(joints, S, S))
    if opt.pose_heatmaps:
        chans.append(joint_heatmaps(joints, S, S, sigma=opt.heatmap_sigma)
                     * 2.0 - 1.0)
    if opt.coord_conv:
        ramp = torch.linspace(-1.0, 1.0, S, dtype=torch.float32, device=dev)
        chans.append(ramp.view(1, 1, 1, S).expand(B, 1, S, S))
        chans.append(ramp.view(1, 1, S, 1).expand(B, 1, S, S))
    pose = torch.cat(chans, dim=1)
    if pose.shape[1] != opt.pose_nc:
        raise ValueError(f"pose input has {pose.shape[1]} channels, config "
                         f"demands {opt.pose_nc}")
    return pose


def make_forward_fn(opt, renderer) -> Callable[..., Dict[str, torch.Tensor]]:
    """Inference forward: (assets, joints) -> rendered frame dict.

    assets = (static_tex (P, 3, T, T), bg (3, S, S), tex_mask or None) on
    the renderer's device; they enter with batch 1, so BGNet runs once per
    batch and the compositor broadcasts.
    """

    @torch.inference_mode()
    def fwd(assets: Tuple[torch.Tensor, torch.Tensor, object],
            joints: torch.Tensor) -> Dict[str, torch.Tensor]:
        static_tex, bg, tex_mask = assets
        pose = build_pose_input(opt, joints)
        return renderer(pose, bg[None], static_tex[None], tex_mask)

    return fwd
