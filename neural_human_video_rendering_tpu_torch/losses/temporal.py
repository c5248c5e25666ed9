"""Temporal flow-warp loss: the port of the JAX package's
``losses/temporal.py`` (--lambda_Temp).

Warps the t-1 frame to frame t by the flow and penalises the mismatch,
masked by forward-backward flow consistency. NCHW: frames (B, 3, H, W),
flows (B, 2, H, W) in pixels (channel 0 = dx). The warp runs the flow-warp
kernel (``ops/flow_warp_kernel``).
"""

from __future__ import annotations

import torch

from ..ops.flow_warp_kernel import flow_warp
from .recon import CountReducer, masked_mean


def temporal_flow_loss(cur: torch.Tensor, prev: torch.Tensor,
                       flow: torch.Tensor, flow_inv: torch.Tensor,
                       count: CountReducer = None) -> torch.Tensor:
    """Masked L1 between frame t and frame t-1 sampled at p + flow(p).

    prev and flow_inv are warped by the same flow in one launch over 5
    channels, which share the taps and the validity test. The mask keeps
    the pixels where flow(p) + flow_inv(p + flow(p)) is small against the
    flows' magnitudes (forward-backward consistency). ``count``: the
    masked mean's reducer (``recon.masked_mean``)."""
    flow = flow.float()
    warped = flow_warp(torch.cat([prev.float(), flow_inv.float()], dim=1),
                       flow)
    warped_prev, warped_inv = warped[:, :3], warped[:, 3:]
    diff2 = torch.sum((flow + warped_inv) ** 2, dim=1, keepdim=True)
    mag2 = torch.sum(flow ** 2 + warped_inv ** 2, dim=1, keepdim=True)
    mask = (diff2 < 0.01 * mag2 + 0.5).float()
    err = torch.abs(cur.float() - warped_prev)
    return masked_mean((err * mask).sum(), mask.sum() * 3.0, count)
