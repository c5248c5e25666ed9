"""Options / config layer of the PyTorch port.

The same flag surface as the JAX package's config (a copy, so the port
imports nothing of that package). Drop-in compatible CLI flag surface with the reference launchers
(reference: test_start/start.sh:7-28, train_start/pretrain_start.sh:10-37,
pretrainTrans.sh:2-16, pre_train_tex.sh:2-23 — pix2pixHD-style argparse
vocabulary). The four reference `.sh` scripts must run against this framework
with path edits only, so every flag name below (including the upstream typo
``--lapalce_path``) is preserved verbatim.

Internally everything lands in one dataclass ``Options``. ``--gpu_ids``
picks the device (``resolve_device``): the first id names the CUDA card,
``-1`` the CPU; several ids (``0,1``; ``0,0`` two ranks on one card;
``=-1,-1`` two CPU ranks) run data parallel, one rank per id, and
``--mesh_shape N`` caps the ranks at N, as it caps the JAX package's data
mesh (``runtime.py``; under torchrun, one rank per process). The flag
that only steered the TPU build (``use_pallas_warp``) is accepted and
ignored, so launch scripts run unchanged. ``--wire_pack`` picks the loader's batch format
(``data/wire.py``); ``--debug_nans`` checks every step's losses and
``--profile_dir`` / ``--profile_start`` / ``--profile_steps`` write a
torch.profiler trace of a window of steps (``train/loop.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional, Tuple


@dataclasses.dataclass
class Options:
    # ---- experiment bookkeeping (pix2pixHD BaseOptions vocabulary) ----
    name: str = "experiment"
    gpu_ids: str = "0"              # CUDA device index, -1 = CPU (resolve_device); several ids = one data-parallel rank each (runtime.py)
    checkpoints_dir: str = "./checkpoints"
    model: str = "nhvr"
    norm: str = "instance"
    verbose: bool = False

    # ---- input/output sizes ----
    batchSize: int = 1
    loadSize: int = 512
    fineSize: int = 512
    input_nc: int = 3
    output_nc: int = 3
    resize_or_crop: str = "resize"
    serial_batches: bool = False
    no_flip: bool = False
    nThreads: int = 2
    max_dataset_size: int = int(1e9)
    data_ratio: float = 1.0          # train fraction; rest held out for eval

    # ---- dataset paths (reference data contract, README.md:39-64) ----
    pose_path: str = ""
    pose_tgt_path: str = ""
    mask_path: str = ""
    img_path: str = ""
    densepose_path: str = ""
    bg_path: str = ""
    texture_path: str = ""
    flow_path: str = ""
    flow_inv_path: str = ""
    lapalce_path: str = ""           # upstream flag name kept verbatim (sic)
    part_texture_path: str = ""
    pose_texture_path: str = ""

    # ---- pose label encoding ----
    use_laplace: bool = False
    pose_plus_laplace: bool = False
    n_joints: int = 18               # "18Feature" encoding (COCO-18 from BODY_25)
    laplace_nc: int = 3              # channels loaded per LaplaceProj frame
    pose_heatmaps: bool = False      # concat n_joints Gaussian joint heatmaps to the pose input (the "18Feature" encoding of the reference's flagship run name; needs keypoint-JSON driving). Measured +2.32 dB held-out at 512px reference sizing (docs/quality/r4_arms_512px.json) — the recommended encoding for new trainings; off for checkpoint-shape parity.
    heatmap_sigma: float = 6.0       # heatmap stddev in pixels at the model canvas
    coord_conv: bool = False         # concat 2 normalized x/y coordinate channels to the pose input (CoordConv; helps the UV heads regress absolute atlas coordinates). Measured +0.17 dB held-out at 512px (docs/quality/r4_arms_512px.json).
    # limb-local coordinate channels (2 per limb: along-limb t and signed
    # perpendicular distance, Gaussian-enveloped — data/rasterize.py
    # limb_coord_maps). Motivation: DensePose UV is limb-aligned, so give
    # the UV heads each limb's local frame directly instead of
    # reconstructing it from the line render. EXPERIMENTAL/UNMEASURED: its
    # 512px arm never got chip time (rounds 3-5); do not stack it into
    # recipes until someone measures it (docs/QUALITY.md round-5 item 4).
    limb_coords: bool = False
    limb_sigma: float = 12.0         # perpendicular Gaussian envelope (px at loadSize canvas)

    # ---- generator architecture ----
    netG: str = "global"             # global | local (pix2pixHD LocalEnhancer)
    n_local_enhancers: int = 1
    n_blocks_local: int = 3
    niter_fix_global: int = 0        # epochs training ONLY the enhancer branches
    ngf: int = 64
    n_downsample_global: int = 4
    n_blocks_global: int = 9
    ngf_global: int = 64             # TexG width override (test_start/start.sh:17)
    n_blocks_translate: int = 9      # TransG depth (pretrainTrans.sh:13)
    n_downsample_translate: int = 4
    # TransG IUV refinement head (quality knob of this framework, off by
    # default for reference parity): N ResNet blocks at HALF resolution
    # (space-to-depth packed) consuming the pose input + the coarse IUV and
    # emitting a residual on the raw logits/UV — a dedicated high-res path
    # past the encoder-decoder bottleneck the decomposition blames for the
    # held-out UV error (docs/QUALITY.md).
    uv_refine: int = 0
    uv_refine_ngf: int = 64
    # multi-scale deep UV supervision (quality knob of this framework, off
    # by default for reference parity): N aux IUV heads (one 3x3 conv each)
    # at the decoder's intermediate resolutions, supervised against
    # stride-subsampled DensePose pseudo-GT with the same UV L1 + part CE,
    # weighted by lambda_MS relative to the full-res terms. Train-time
    # only — the aux heads are ignored at inference and by serving export.
    # Targets the IUV-accuracy gap the round-4 decomposition left standing
    # (docs/quality/quality_profile_ep100.json). netG=global only.
    ms_uv: int = 0
    lambda_MS: float = 0.3
    n_downsample_bg: int = 2
    n_blocks_bg: int = 2
    TexG: str = "part"
    use_mask_texture: bool = False
    # pix2pixHD encoder E (networks.define_E lineage; flag evidence
    # test_start/start.sh:23). The human-video contract has no object
    # instance maps, so the region map is the DensePose part map —
    # either flag engages the same part-wise feature path (FeatEncoder).
    instance_feat: bool = False
    label_feat: bool = False
    feat_num: int = 3                # appearance-code channels (pix2pixHD default)
    nef: int = 16                    # encoder E width (pix2pixHD default)
    n_downsample_E: int = 4          # encoder E depth (pix2pixHD default)
    load_features: str = ""          # .npz of per-part cluster codes for inference (python -m ...encode_features)
    cluster_idx: int = 0             # which cluster center to render with

    # ---- discriminator ----
    num_D: int = 2
    n_layers_D: int = 3
    ndf: int = 64
    no_lsgan: bool = False
    pool_size: int = 0

    # ---- densepose / texture geometry ----
    n_parts: int = 24                # densepose body parts (bg = index 0)
    tex_tile: int = 128              # per-part texture tile (TPU-aligned default)
    tex_rows: int = 4
    tex_cols: int = 6

    # ---- optimization ----
    lr: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    niter: int = 100
    niter_decay: int = 100
    no_decay: bool = False
    # exponential moving average of generator weights, used for held-out
    # eval / saved as *_net_G_ema / preferred at inference. 0 = off (parity
    # default: the reference's pix2pixHD lineage trains without EMA); 0.999
    # is the usual GAN setting. Stage-2 only.
    ema_decay: float = 0.0

    # ---- loss weights (train_start/pretrain_start.sh:31-37) ----
    lambda_feat: float = 10.0
    lambda_L2: float = 0.0
    lambda_UV: float = 0.0
    # spatial-gradient supervision of the predicted UV field (quality knob of
    # this framework, off by default for reference parity): matches finite
    # differences of predicted UV to the DensePose pseudo-GT's within each GT
    # part, so the warp field is locally consistent even where absolute UV
    # drifts. Applied wherever the UV L1 applies (stage 1 + stage 2).
    # MEASURED NEGATIVE at 512px reference sizing: weight 500 costs −0.69 dB
    # held-out (docs/quality/r4_arms_512px.json) — it over-smooths UV where
    # sub-pixel boundary accuracy binds. Do not use at this weight.
    lambda_UVgrad: float = 0.0
    lambda_Prob: float = 0.0
    lambda_Temp: float = 0.0
    lambda_Mask: float = 1.0
    use_densepose_loss: bool = False
    no_ganFeat_loss: bool = False
    no_vgg_loss: bool = False

    # ---- schedules / logging ----
    display_freq: int = 100
    print_freq: int = 100
    save_latest_freq: int = 1000
    save_epoch_freq: int = 10
    tf_log: bool = False
    no_html: bool = False
    debug: bool = False

    # ---- checkpoint / resume ----
    continue_train: bool = False
    load_pretrain: str = ""
    which_epoch: str = "latest"
    load_pretrain_TransG: str = ""
    which_epoch_TransG: str = "latest"

    # ---- inference ----
    results_dir: str = "./results"
    how_many: int = int(1e9)
    phase: str = "train"
    # canvas shapes "H,W[,C]" (reference passes --target_shape/--source_shape
    # to graph_posenorm, run_alignPose.sh:4-5; here they pin the pixel canvas
    # the keypoint coordinates live on, replacing max-coordinate guessing in
    # the inference driver)
    target_shape: str = ""
    source_shape: str = ""
    infer_batch: int = 8             # frames per compiled inference batch
    no_ema: bool = False             # inference: load raw G even when G_ema exists (EMA A/B evals)
    save_video: bool = False         # also assemble {results_dir}/video.mp4
    video_fps: float = 25.0

    # ---- TPU-native knobs (new; no reference analog) ----
    dtype: str = "bfloat16"          # compute dtype; params/opt state stay fp32
    mesh_shape: str = ""             # data-parallel ranks: caps the ranks of --gpu_ids ("4,2": its first extent); empty = one rank per id (runtime.py)
    use_pallas_warp: bool = True     # fused Pallas texture-warp kernel
    wire_pack: bool = True           # uint8/f16 host->device batch format (bit-exact on the 1/255 grid; <=1/255 rounding after interpolated resizes — data/wire.py)
    warp_topk: int = 4               # top-k part sampling in the texture warp (0/24 = all parts)
    warp_block_parts: int = 0        # cap active parts per warp-kernel block (0 = exact; >0 is a lossy opt-in, only valid once part probs are spatially coherent)
    warp_eps: float = 1e-3           # drop sub-eps blend weights in the warp (error <= warp_topk*eps per pixel; 0 = exact)
    warp_dtype: str = "float32"      # Pallas warp gather/reduce precision: float32 (bit-exact) | bfloat16 (~2x VPU rate, ~2^-8 rounding; precision-consistent when --dtype bfloat16)
    temporal_detach_prev: bool = True  # stop-grad the t-1 frame in the temporal loss (fwd-only prev render)
    temporal_prev: str = "fake"      # temporal-loss target: fake (render t-1, parity) | real (flow-warp the real t-1 frame; no prev render)
    stem_s2d: int = 2                # space-to-depth the generator stems (1 = pix2pixHD topology)
    head_s2d: int = 2                # pixel-shuffle the generator heads (1 = pix2pixHD topology)
    bg_s2d: int = 4                  # space-to-depth/pixel-shuffle factor for BGNet (1 = off)
    pad_mode: str = "same"           # conv padding: same (TPU default, no pre-pad copies) | reflect (pix2pixHD parity)
    upsample_mode: str = "deconv"    # decoder upsample: deconv (parity) | resize (faster, no checkerboard)
    debug_nans: bool = False         # fail fast: FloatingPointError on a step's non-finite loss (train/loop.py)
    profile_dir: str = ""            # write a torch.profiler trace of steps [profile_start, profile_start+profile_steps)
    profile_start: int = 3
    profile_steps: int = 5
    seed: int = 0
    isTrain: bool = True

    # ------------------------------------------------------------------
    @property
    def run_dir(self) -> str:
        return os.path.join(self.checkpoints_dir, self.name)

    @staticmethod
    def parse_shape(spec: str) -> Optional[Tuple[int, int]]:
        """'H,W[,C]' or 'H W [C]' -> (H, W); None when unset."""
        toks = [t for t in spec.replace(",", " ").split() if t]
        if len(toks) < 2:
            return None
        return int(toks[0]), int(toks[1])

    @property
    def train_size(self) -> int:
        """Model input resolution: fineSize when --resize_or_crop requests a
        crop (pix2pixHD resize_and_crop/crop), else loadSize (the reference
        launchers all use plain resize: train_start/pretrain_start.sh:24)."""
        if "crop" in self.resize_or_crop:
            return min(self.fineSize, self.loadSize)
        return self.loadSize

    @property
    def use_pose_render(self) -> bool:
        """Whether the 3-channel pose render enters the generator input."""
        return (self.pose_plus_laplace or not self.use_laplace
                or self.input_nc > 3)

    @property
    def laplace_nc_eff(self) -> int:
        """Effective LaplaceProj channel count.

        The 81-channel texture-pretrain contract (reference:
        pre_train_tex.sh:18 passes --input_nc 81 with --use_laplace and
        pose_path = rendered pose images): total input = 3-channel pose
        render + (input_nc - 3) LaplaceProj channels. When input_nc is the
        plain 3 (every other launcher), LaplaceProj contributes laplace_nc.
        """
        if not self.use_laplace:
            return 0
        if self.input_nc > 3:
            return self.input_nc - 3
        return self.laplace_nc

    @property
    def pose_nc(self) -> int:
        """Channels of the pose-label input fed to the generators.

        3-channel skeleton render (reference uses rendered pose images,
        input_nc 3 at test_start/start.sh:24); LaplaceProj channels are
        concatenated when --use_laplace / --pose_plus_laplace; --input_nc 81
        (pre_train_tex.sh:18) stacks the render with 78 LaplaceProj channels;
        --pose_heatmaps adds n_joints Gaussian heatmap channels (the
        "18Feature" encoding).
        """
        nc = 3 if self.use_pose_render else 0
        if self.pose_heatmaps:
            nc += self.n_joints
        if self.coord_conv:
            nc += 2
        if self.limb_coords:
            from .data.keypoints import COCO18_LIMBS
            nc += 2 * len(COCO18_LIMBS)
        return nc + self.laplace_nc_eff

    @property
    def transg_out_nc(self) -> int:
        # 1+n_parts part logits (bg at 0) + 2*n_parts UV channels
        return (1 + self.n_parts) + 2 * self.n_parts

    def save(self) -> None:
        """Dump options to {checkpoints_dir}/{name}/opt.txt (pix2pixHD contract)."""
        os.makedirs(self.run_dir, exist_ok=True)
        path = os.path.join(self.run_dir, "opt.txt")
        with open(path + ".tmp", "w") as f:  # atomic, see _save_recipe
            f.write("------------ Options -------------\n")
            for k, v in sorted(dataclasses.asdict(self).items()):
                f.write(f"{k}: {v}\n")
            f.write("-------------- End ----------------\n")
        os.replace(path + ".tmp", path)
        self._save_recipe()

    def _save_recipe(self) -> None:
        """Write {run_dir}/recipe.json: the exact regeneration recipe.

        Trained artifacts have died with scratch disks before; this records
        everything needed to regenerate the checkpoint byte-comparably —
        the literal argv, the repo revision, the seed, and the resolved
        config. opt.txt stays the human-readable pix2pixHD-contract dump;
        recipe.json is the machine-readable one.
        """
        import json
        import subprocess
        rev = ""
        try:
            rev = subprocess.run(
                ["git", "rev-parse", "HEAD"],
                cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                capture_output=True, text=True, timeout=10).stdout.strip()
        except Exception:
            pass
        rec = {"argv": sys.argv, "git_rev": rev, "seed": self.seed,
               "config": dataclasses.asdict(self)}
        # write-then-rename: a run forked from a `cp -al` clone of another
        # run dir must not rewrite the parent's recipe through the shared
        # inode (and a crash mid-write must not leave truncated JSON)
        path = os.path.join(self.run_dir, "recipe.json")
        with open(path + ".tmp", "w") as f:
            json.dump(rec, f, indent=1, default=str)
        os.replace(path + ".tmp", path)


# --help text of the flags whose meaning the port changed
HELP = {
    "gpu_ids": "CUDA device index, -1 for the CPU; several ids (0,1; 0,0 "
               "for two ranks on one card; =-1,-1 for two CPU ranks) run "
               "data parallel, one rank per id",
    "mesh_shape": "the data-parallel ranks: caps the ranks that --gpu_ids "
                  "gives (the first extent of e.g. 4,2); under torchrun a "
                  "cap below the world is refused; empty: one rank per id",
}


def _add_flags(p: argparse.ArgumentParser) -> None:
    d = Options()
    for field in dataclasses.fields(Options):
        name = "--" + field.name
        default = getattr(d, field.name)
        if field.type == "bool" or isinstance(default, bool):
            # paired --X / --no_X so default-True knobs (use_pallas_warp,
            # temporal_detach_prev, ...) are CLI-toggleable; fields already
            # named no_* keep their single pix2pixHD-style toggle
            g = p.add_mutually_exclusive_group()
            g.add_argument(name, dest=field.name, action="store_true",
                           default=default)
            if not field.name.startswith("no_"):
                g.add_argument("--no_" + field.name, dest=field.name,
                               action="store_false")
        else:
            p.add_argument(name, type=type(default), default=default,
                           help=HELP.get(field.name))


class BaseOptions:
    """argparse front-end mirroring pix2pixHD's BaseOptions.parse()."""

    isTrain = True

    def __init__(self) -> None:
        self.parser = argparse.ArgumentParser(
            description="Neural human video rendering (PyTorch port)",
            conflict_handler="resolve",
        )
        _add_flags(self.parser)
        self._customize(self.parser)

    def _customize(self, parser: argparse.ArgumentParser) -> None:
        pass

    def parse(self, args=None, save: bool = True) -> Options:
        ns = self.parser.parse_args(args)
        opt = Options(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(Options)})
        opt.isTrain = self.isTrain
        if opt.debug:
            # pix2pixHD --debug: tiny cadences + capped dataset for smoke runs
            opt.display_freq = opt.print_freq = 1
            opt.niter = 1
            opt.niter_decay = 0
            opt.max_dataset_size = min(opt.max_dataset_size, 10)
        if opt.isTrain and save and os.environ.get("RANK", "0") == "0":
            opt.save()          # under torchrun, rank 0 alone
        if opt.verbose:
            for k, v in sorted(dataclasses.asdict(opt).items()):
                print(f"{k}: {v}")
        return opt


class TrainOptions(BaseOptions):
    isTrain = True

    def _customize(self, parser: argparse.ArgumentParser) -> None:
        parser.set_defaults(phase="train")


class TestOptions(BaseOptions):
    isTrain = False

    def _customize(self, parser: argparse.ArgumentParser) -> None:
        parser.set_defaults(phase="test")


def resolve_device(gpu_ids: str):
    """--gpu_ids -> torch.device: the first id names the CUDA card, a
    negative id (or an empty list) the CPU. Asking for CUDA where there is
    none raises: the port never runs on the CPU unless told to."""
    import torch
    ids = [int(t) for t in gpu_ids.replace(",", " ").split()]
    if not ids or ids[0] < 0:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--gpu_ids {gpu_ids!r} asks for CUDA device {ids[0]} but "
            "torch.cuda.is_available() is False (pass --gpu_ids -1 for CPU)")
    return torch.device("cuda", ids[0])
