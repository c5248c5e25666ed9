"""Quality metrics for held-out evaluation: the port of the JAX package's
``utils/metrics.py`` (PSNR, SSIM and the VGG distance, one value per
sample).

Images are NCHW in [-1, 1]. SSIM's 11-tap Gaussian (sigma 1.5, VALID) is
applied as two separable sums of shifted slices in float32, so no
convolution (and no TF32) touches its E[x^2] - mu^2 cancellation.
"""

from __future__ import annotations

import torch


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) PSNR in dB of images in [-1, 1] (peak-to-peak 2.0)."""
    mse = ((a.float() - b.float()) ** 2).flatten(1).mean(1)
    return 10.0 * torch.log10(4.0 / torch.clamp(mse, min=1e-10))


def _gaussian_taps(size: int = 11, sigma: float = 1.5) -> list:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).tolist()


def _filter(x: torch.Tensor, taps: list) -> torch.Tensor:
    """VALID separable Gaussian of (B, C, H, W)."""
    n = len(taps)
    H, W = x.shape[-2:]
    rows = sum(t * x[..., i:H - n + 1 + i, :] for i, t in enumerate(taps))
    return sum(t * rows[..., i:W - n + 1 + i] for i, t in enumerate(taps))


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) mean SSIM of images (B, C, H, W) in [-1, 1]."""
    a = (a.float() + 1) / 2
    b = (b.float() + 1) / 2
    taps = _gaussian_taps()
    mu_a, mu_b = _filter(a, taps), _filter(b, taps)
    var_a = _filter(a * a, taps) - mu_a ** 2
    var_b = _filter(b * b, taps) - mu_b ** 2
    cov = _filter(a * b, taps) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return s.flatten(1).mean(1)


def vgg_distance_taps(fa, fb) -> torch.Tensor:
    """(B,) sum over the five taps of FEATURE_WEIGHTS[l] * mean |fa_l -
    fb_l|: the VGG distance of two images' taps (``models.vgg``'s
    VGG19Features output, float32)."""
    from ..models.vgg import FEATURE_WEIGHTS
    d = 0.0
    for w, x, y in zip(FEATURE_WEIGHTS, fa, fb):
        d = d + w * (x - y).abs().flatten(1).mean(1)
    return d


def vgg_distance(vgg, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) LPIPS-style perceptual distance of images (B, 3, H, W) in
    [-1, 1] over the VGG's taps (the JAX package's
    ``vgg_distance(..., per_sample=True)``). Build ``vgg`` in bfloat16, as
    that package runs it; its taps come back float32. Tap 0 is compared
    space-to-depth packed: a mean over its channels is the mean over the
    unpacked pixels."""
    return vgg_distance_taps(vgg(a), vgg(b))
