"""A configuration's flags as the reference reads them.

Every flag below must be in the configuration file: the reference keeps
no defaults of its own, so it cannot drift from what the program is told.
A key that is neither a flag the reference implements nor one of
``PROGRAM_ONLY`` is refused: a configuration the reference would quietly
build otherwise than the program is no yardstick. The one exception is
pix2pixHD's encoder E: ``FEAT_SWITCHES`` may be left out, which means
no encoder, as the program's own options default to; where either is
true, ``FEAT_FLAGS`` are required. E's cluster codes (``load_features``,
``cluster_idx``) are not implemented, and so refused.
"""

from __future__ import annotations

from types import SimpleNamespace

FLAGS = (
    "loadSize", "batchSize", "n_parts", "tex_tile", "netG", "ngf",
    "n_downsample_translate", "n_blocks_translate", "ngf_global",
    "n_downsample_global", "n_blocks_global", "n_downsample_bg",
    "n_blocks_bg", "num_D", "n_layers_D", "ndf", "stem_s2d", "head_s2d",
    "bg_s2d", "pad_mode", "upsample_mode", "dtype", "warp_topk",
    "warp_eps", "warp_dtype", "pose_heatmaps", "heatmap_sigma",
    "coord_conv", "n_joints", "lr", "beta1", "beta2", "ema_decay",
    "lambda_feat", "lambda_L2", "lambda_UV", "lambda_Prob", "lambda_Temp",
    "lambda_Mask", "use_densepose_loss", "no_vgg_loss", "no_ganFeat_loss",
    "temporal_prev")

# required as well where netG is "local" (pix2pixHD's LocalEnhancer)
LOCAL_FLAGS = ("n_local_enhancers", "n_blocks_local", "niter_fix_global")

# pix2pixHD's encoder E (feat.py): either switch builds it; absent, false
FEAT_SWITCHES = ("instance_feat", "label_feat")
# required as well where a switch is true
FEAT_FLAGS = ("feat_num", "nef", "n_downsample_E")

# what the reference implements, beside the numbers above
SUPPORTED = {"pad_mode": ("same", "reflect"), "n_joints": (18,),
             "temporal_prev": ("real", "fake"), "n_parts": (24,),
             "netG": ("global", "local"),
             # Upsample is a transposed convolution only
             "upsample_mode": ("deconv",),
             # the harness's trainer has no epochs, so no freeze boundary
             "niter_fix_global": (0,)}

# keys the program reads that change nothing the reference computes
PROGRAM_ONLY = (
    "gpu_ids",          # which card runs the program
    "no_flip",          # the trainer's loader; the harness draws batches
    "resize_or_crop",   # the loader's resize; batches come at loadSize
    "tex_rows",         # the atlas's layout on disk; both see (P, 3, T, T)
    "tex_cols",         # likewise
    "warp_block_parts",  # the warp's kernel route, the same arithmetic
)


def reference_config(flags: dict) -> SimpleNamespace:
    use_feat = any(bool(flags.get(k, False)) for k in FEAT_SWITCHES)
    required = (FLAGS + (LOCAL_FLAGS if flags.get("netG") == "local" else ())
                + (FEAT_FLAGS if use_feat else ()))
    missing = [k for k in required if k not in flags]
    if missing:
        raise ValueError(f"configuration lacks {missing}")
    known = FLAGS + LOCAL_FLAGS + FEAT_SWITCHES + FEAT_FLAGS + PROGRAM_ONLY
    unknown = sorted(set(flags) - set(known))
    if unknown:
        raise ValueError(f"the reference does not implement {unknown}")
    for k, ok in SUPPORTED.items():
        if k in flags and flags[k] not in ok:
            raise ValueError(f"the reference implements {k} in {ok}, not "
                             f"{flags[k]!r}")
    cfg = SimpleNamespace(**{k: flags[k] for k in required})
    cfg.use_feat = use_feat
    cfg.size = cfg.loadSize
    cfg.pose_nc = (3 + (cfg.n_joints if cfg.pose_heatmaps else 0)
                   + (2 if cfg.coord_conv else 0))
    return cfg
