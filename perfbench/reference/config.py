"""A configuration's flags as the reference reads them.

Every flag below must be in the configuration file: the reference keeps
no defaults of its own, so it cannot drift from what the program is told.
"""

from __future__ import annotations

from types import SimpleNamespace

FLAGS = (
    "loadSize", "batchSize", "n_parts", "tex_tile", "ngf",
    "n_downsample_translate", "n_blocks_translate", "ngf_global",
    "n_downsample_global", "n_blocks_global", "n_downsample_bg",
    "n_blocks_bg", "num_D", "n_layers_D", "ndf", "stem_s2d", "head_s2d",
    "bg_s2d", "pad_mode", "dtype", "warp_topk", "warp_eps", "warp_dtype",
    "pose_heatmaps", "heatmap_sigma", "coord_conv", "n_joints", "lr",
    "beta1", "beta2", "ema_decay", "lambda_feat", "lambda_L2", "lambda_UV",
    "lambda_Prob", "lambda_Temp", "lambda_Mask", "use_densepose_loss",
    "no_vgg_loss", "no_ganFeat_loss", "temporal_prev")

# what the reference implements, beside the numbers above
SUPPORTED = {"pad_mode": ("same", "reflect"), "n_joints": (18,),
             "temporal_prev": ("real", "fake"), "n_parts": (24,)}


def reference_config(flags: dict) -> SimpleNamespace:
    missing = [k for k in FLAGS if k not in flags]
    if missing:
        raise ValueError(f"configuration lacks {missing}")
    for k, ok in SUPPORTED.items():
        if flags[k] not in ok:
            raise ValueError(f"the reference implements {k} in {ok}, not "
                             f"{flags[k]!r}")
    cfg = SimpleNamespace(**{k: flags[k] for k in FLAGS})
    cfg.size = cfg.loadSize
    cfg.pose_nc = (3 + (cfg.n_joints if cfg.pose_heatmaps else 0)
                   + (2 if cfg.coord_conv else 0))
    return cfg
