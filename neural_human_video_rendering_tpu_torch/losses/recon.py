"""Reconstruction and DensePose-supervision losses: the port of the JAX
package's ``losses/recon.py`` (``uv_grad_loss`` and ``ms_iuv_loss`` are
not ported: their options are refused).

NCHW: frames (B, 3, H, W), the renderer's uv (B, P, 2, H, W), logits
(B, P+1, H, W), masks (B, 1, H, W); DensePose pseudo-GT dp_uv (B, 2, H, W)
in [0, 1] and dp_parts (B, H, W) integer, 0 = background. All reductions
in float32.
"""

from __future__ import annotations

from typing import Optional

import torch


def l2_loss(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """Mean squared reconstruction error on the composite frame."""
    return torch.mean((fake.float() - real.float()) ** 2)


def uv_loss(uv_pred: torch.Tensor, dp_uv: torch.Tensor,
            dp_parts: torch.Tensor) -> torch.Tensor:
    """L1 of the predicted UV against the pseudo-GT at each foreground
    pixel's GT part only, averaged over foreground pixels and both
    coordinates."""
    B, P, _, H, W = uv_pred.shape
    idx = (dp_parts.long() - 1).clamp(min=0)
    pred = torch.gather(uv_pred.float(), 1,
                        idx[:, None, None].expand(B, 1, 2, H, W))[:, 0]
    fg = (dp_parts > 0).float()[:, None]
    err = torch.abs(pred - dp_uv.float()) * fg
    return err.sum() / torch.clamp(fg.sum() * 2.0, min=1.0)


def part_ce_loss(logits: torch.Tensor, dp_parts: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax cross-entropy of the part logits against the DensePose part
    index (0 = background); an optional (B, 1, H, W) mask restricts it."""
    logp = torch.log_softmax(logits.float(), dim=1)
    picked = torch.gather(logp, 1, dp_parts.long()[:, None])[:, 0]
    if mask is not None:
        m = mask[:, 0].float()
        return -(picked * m).sum() / torch.clamp(m.sum(), min=1.0)
    return -picked.mean()


def mask_loss(pred_mask: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    """L1 between the predicted soft mask and the segmentation GT."""
    return torch.mean(torch.abs(pred_mask.float() - gt_mask.float()))
