"""VGG perceptual loss: the port of the JAX package's
``losses/perceptual.py`` (pix2pixHD VGGLoss)."""

from __future__ import annotations

import torch

from ..models.vgg import FEATURE_WEIGHTS


def vgg_loss(vgg, fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """Weighted L1 over the five VGG19 tap activations; real is constant.

    ``vgg`` is a models.vgg.VGG19Features; the train step builds it in
    bfloat16 whatever --dtype says, as the JAX package runs it, and the
    taps are compared in float32."""
    f_feats = vgg(fake)
    with torch.no_grad():
        r_feats = vgg(real.detach())
    loss = 0.0
    for w, f, r in zip(FEATURE_WEIGHTS, f_feats, r_feats):
        loss = loss + w * torch.mean(torch.abs(f - r))
    return loss
