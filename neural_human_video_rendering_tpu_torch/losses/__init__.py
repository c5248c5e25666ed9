"""Training losses of the port (``losses/`` of the JAX package, NCHW)."""

from .gan import feature_matching_loss, lsgan_loss_d, lsgan_loss_g  # noqa: F401
from .perceptual import vgg_loss  # noqa: F401
from .recon import l2_loss, mask_loss, part_ce_loss, uv_loss  # noqa: F401
from .temporal import temporal_flow_loss  # noqa: F401
