"""Reconstruction and DensePose-supervision losses: the port of the JAX
package's ``losses/recon.py``, with the UV-gradient loss of
--lambda_UVgrad and the deep supervision of --ms_uv.

NCHW: frames (B, 3, H, W), the renderer's uv (B, P, 2, H, W), logits
(B, P+1, H, W), masks (B, 1, H, W); DensePose pseudo-GT dp_uv (B, 2, H, W)
in [0, 1] and dp_parts (B, H, W) integer, 0 = background. All reductions
in float32.

The masked means (UV, UV gradient, masked part CE) divide by a count that
depends on the data. Each takes an optional ``count`` reducer, the
denominator of its local sum (``parallel.mesh.DataParallel.count_share``:
max(global count, 1) / world), so that under data parallel the ranks' mean
gradient is the global batch's; without one, max(count, 1).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

CountReducer = Optional[Callable[[torch.Tensor], torch.Tensor]]


def masked_mean(total: torch.Tensor, count: torch.Tensor,
                reduce: CountReducer = None) -> torch.Tensor:
    """total / max(count, 1), or total / reduce(count)."""
    if reduce is None:
        return total / torch.clamp(count, min=1.0)
    return total / reduce(count)


def l2_loss(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """Mean squared reconstruction error on the composite frame."""
    return torch.mean((fake.float() - real.float()) ** 2)


def _uv_at_gt_part(uv_pred: torch.Tensor,
                   dp_parts: torch.Tensor) -> torch.Tensor:
    """(B, P, 2, H, W) -> (B, 2, H, W): each pixel's UV of its GT part
    (part 1's at the background, which every caller masks out)."""
    B, P, _, H, W = uv_pred.shape
    idx = (dp_parts.long() - 1).clamp(min=0)
    return torch.gather(uv_pred.float(), 1,
                        idx[:, None, None].expand(B, 1, 2, H, W))[:, 0]


def uv_loss(uv_pred: torch.Tensor, dp_uv: torch.Tensor,
            dp_parts: torch.Tensor, count: CountReducer = None
            ) -> torch.Tensor:
    """L1 of the predicted UV against the pseudo-GT at each foreground
    pixel's GT part only, averaged over foreground pixels and both
    coordinates."""
    pred = _uv_at_gt_part(uv_pred, dp_parts)
    fg = (dp_parts > 0).float()[:, None]
    err = torch.abs(pred - dp_uv.float()) * fg
    return masked_mean(err.sum(), fg.sum() * 2.0, count)


def uv_grad_loss(uv_pred: torch.Tensor, dp_uv: torch.Tensor,
                 dp_parts: torch.Tensor, count: CountReducer = None
                 ) -> torch.Tensor:
    """L1 of the predicted UV's finite differences (down and across, at
    the GT part) against the pseudo-GT's, over the pairs of neighbours
    that carry the same nonzero GT part, averaged over those pairs and
    both coordinates (--lambda_UVgrad)."""
    pred = _uv_at_gt_part(uv_pred, dp_parts)
    gt = dp_uv.float()
    total = n_pairs = 0.0
    for axis in (2, 3):
        n = pred.shape[axis] - 1
        lo = dp_parts.narrow(axis - 1, 0, n)
        hi = dp_parts.narrow(axis - 1, 1, n)
        valid = ((lo == hi) & (lo > 0)).float()[:, None]
        err = torch.abs(torch.diff(pred, dim=axis) - torch.diff(gt, dim=axis))
        total = total + (err * valid).sum()
        n_pairs = n_pairs + valid.sum() * 2.0
    return masked_mean(total, n_pairs, count)


def part_ce_loss(logits: torch.Tensor, dp_parts: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 count: CountReducer = None) -> torch.Tensor:
    """Softmax cross-entropy of the part logits against the DensePose part
    index (0 = background); an optional (B, 1, H, W) mask restricts it
    (a masked mean; without the mask a plain one)."""
    logp = torch.log_softmax(logits.float(), dim=1)
    picked = torch.gather(logp, 1, dp_parts.long()[:, None])[:, 0]
    if mask is not None:
        m = mask[:, 0].float()
        return -masked_mean((picked * m).sum(), m.sum(), count)
    return -picked.mean()


def mask_loss(pred_mask: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    """L1 between the predicted soft mask and the segmentation GT."""
    return torch.mean(torch.abs(pred_mask.float() - gt_mask.float()))


def ms_iuv_loss(aux, dp_uv: torch.Tensor, dp_parts: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                count: CountReducer = None):
    """Deep supervision of --ms_uv: for each aux head's (logits_k
    (B, P+1, h, w), uv_k (B, P, 2, h, w)) the UV L1 and the part
    cross-entropy against the full-resolution pseudo-GT (and mask)
    subsampled by the stride H // h, W // w (nearest: part indices stay
    categorical). Returns (uv, ce), each the mean over the scales; two
    zeros without aux heads."""
    if not aux:
        z = dp_uv.new_zeros((), dtype=torch.float32)
        return z, z
    H, W = dp_parts.shape[1], dp_parts.shape[2]
    uv_t = ce_t = 0.0
    for logits_k, uv_k in aux:
        fh, fw = H // logits_k.shape[2], W // logits_k.shape[3]
        parts_k = dp_parts[:, ::fh, ::fw]
        uv_t = uv_t + uv_loss(uv_k, dp_uv[:, :, ::fh, ::fw], parts_k, count)
        ce_t = ce_t + part_ce_loss(
            logits_k, parts_k,
            mask[:, :, ::fh, ::fw] if mask is not None else None, count)
    return uv_t / len(aux), ce_t / len(aux)
