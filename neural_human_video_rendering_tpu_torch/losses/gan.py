"""GAN + feature-matching losses: the port of the JAX package's
``losses/gan.py``.

LSGAN (or, with --no_lsgan, sigmoid BCE) over the multiscale PatchGAN
outputs, plus the discriminator feature-matching L1 weighted
4/(n_layers+1) * 1/num_D * lambda_feat as pix2pixHD. ``outs`` is the
discriminator's list (one per scale) of per-layer feature lists whose last
entry is the scale's patch logits. All reductions in float32.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

Outs = List[List[torch.Tensor]]


def _mse_to(outs: Outs, target: float) -> torch.Tensor:
    loss = 0.0
    for feats in outs:
        loss = loss + torch.mean((feats[-1].float() - target) ** 2)
    return loss / len(outs)


def _bce_to(outs: Outs, target: float) -> torch.Tensor:
    """Sigmoid BCE-with-logits against a constant target (vanilla GAN)."""
    loss = 0.0
    for feats in outs:
        z = feats[-1].float()
        # log(1 + e^-|z|) + max(z, 0) - t*z, as the JAX package writes it
        loss = loss + torch.mean(F.softplus(-z.abs()) + z.clamp(min=0.0)
                                 - target * z)
    return loss / len(outs)


def lsgan_loss_g(fake_outs: Outs, use_lsgan: bool = True) -> torch.Tensor:
    """Generator GAN loss: D(fake) -> 1."""
    return (_mse_to if use_lsgan else _bce_to)(fake_outs, 1.0)


def lsgan_loss_d(real_outs: Outs, fake_outs: Outs,
                 use_lsgan: bool = True) -> torch.Tensor:
    """Discriminator GAN loss: D(real) -> 1, D(fake) -> 0 (x0.5 each)."""
    f = _mse_to if use_lsgan else _bce_to
    return 0.5 * (f(real_outs, 1.0) + f(fake_outs, 0.0))


def feature_matching_loss(real_outs: Outs, fake_outs: Outs,
                          lambda_feat: float = 10.0) -> torch.Tensor:
    """L1 between D activations of real (the caller detaches them) and
    fake, every layer but the logits."""
    num_d = len(real_outs)
    loss = 0.0
    for rf, ff in zip(real_outs, fake_outs):
        w = 4.0 / len(rf) / num_d          # len(rf) = n_layers + 1
        for r, f in zip(rf[:-1], ff[:-1]):
            loss = loss + w * torch.mean(torch.abs(f.float() - r.float()))
    return lambda_feat * loss
