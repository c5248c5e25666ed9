"""Stage drivers of the port: the bodies behind the JAX package's train.py
(``run_train``), pre_train.py (``run_pretrain_uv``) and pre_train_tex.py
(``run_pretrain_tex``), ``train/drivers.py`` there.

Each builds the dataset (``FrameDataset`` when any modality directory
exists, else the deterministic ``SyntheticDataset``), the nets and their
optimizers (with --continue_train, --load_pretrain and
--load_pretrain_TransG restores for stage 2), the step, then runs the
epoch loop, which saves checkpoints under {checkpoints_dir}/{name}/.

    python -m neural_human_video_rendering_tpu_torch.train.drivers \\
        <train.py flags> [--gpu_ids -1 for the CPU]

A --load_pretrain*, --which_epoch or --continue_train run dir may hold
the port's .pth files or the JAX package's .msgpack files (.pth first);
--continue_train on a JAX run also restores its optimizer state
(latest_state.msgpack: both Adam states, the step, the schedule and the
freeze position; utils/checkpoint.load_train_state).

Data parallel (``runtime.launch``: several --gpu_ids, or torchrun): each
driver runs on every rank. --batchSize is the global batch; each rank's
loader reads its shard at batchSize / world. Rank 0's initial weights
are broadcast; a resume or warm start loads on every rank, and the ranks'
state is checked bit-equal after it and at the end of the run. Rank 0
alone prunes and writes metrics.jsonl, the gallery and the checkpoints
(the loop). The held-out eval spreads the split over the ranks and sums
their PSNR / SSIM, so val_PSNR is a one-rank run's.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..config import TrainOptions
from ..data import dataset as dsm
from ..data.wire import pack_batch, unpack_batch
from ..models.generators import TexG
from ..models.renderer import init_params, renderer_from_options
from ..ops import adam_ema_kernel as ak
from ..ops import flow_warp_kernel as fk
from ..ops import texture_warp_kernel as tk
from ..parallel.mesh import (DataParallel, module_tensors,
                             optimizer_tensors)
from ..runtime import launch
from ..utils import checkpoint as ckpt
from ..utils.metrics import psnr, ssim
from ..utils.visualizer import prune_metrics_after
from .loop import run_training
from .state import PretrainState, create_train_state, make_optimizer, to_nchw
from .steps import (make_pretrain_tex_step, make_pretrain_uv_step,
                    make_train_step, pose_from_batch)


def _dataset(opt, phase: str = "train"):
    """FrameDataset whenever ANY modality directory exists (the stage-1
    launcher passes pose / mask / densepose but no --img_path), else the
    SyntheticDataset."""
    if any(p and os.path.isdir(p) for p in (opt.pose_path, opt.img_path,
                                            opt.densepose_path, opt.mask_path)):
        return dsm.FrameDataset(opt, phase)
    print("[data] no real dataset dirs found -> SyntheticDataset", flush=True)
    return dsm.SyntheticDataset(opt, length=max(opt.batchSize * 4, 16),
                                seed=opt.seed)


def _loader(opt, ds, dp: DataParallel,
            shuffle: bool = True) -> dsm.BatchLoader:
    """This rank's shard of the epochs, at its share of --batchSize.
    --nThreads decode files in parallel (OpenCV and zlib release the
    GIL). The synthetic dataset computes its samples in numpy instead, and
    a pool of those takes the host's cores from the eager step: on the
    H100's host the synthetic stage-2 step ran ~30% slower with two
    threads, so it keeps the one loader thread."""
    synthetic = isinstance(getattr(ds, "base", ds), dsm.SyntheticDataset)
    return dsm.BatchLoader(ds, opt.batchSize // dp.world, shuffle=shuffle,
                           seed=opt.seed,
                           threads=1 if synthetic else opt.nThreads,
                           transform=pack_batch if opt.wire_pack else None,
                           shard=(dp.rank, dp.world))


def _assets(opt, ds):
    """(static_tex (P, T, T, 3), bg (S, S, 3)) from files, else the
    synthetic dataset's, else zeros."""
    if opt.texture_path and os.path.isfile(opt.texture_path):
        tex = dsm.load_texture_atlas(opt.texture_path, opt.tex_tile,
                                     opt.tex_rows, opt.tex_cols)
    elif hasattr(ds, "texture_atlas"):
        tex = ds.texture_atlas()
    else:
        tex = np.zeros((opt.n_parts, opt.tex_tile, opt.tex_tile, 3), np.float32)
    if opt.bg_path and os.path.isfile(opt.bg_path):
        bg = dsm.load_image(opt.bg_path, opt.train_size)
    elif hasattr(ds, "background"):
        bg = ds.background()
    else:
        bg = np.zeros((opt.train_size, opt.train_size, 3), np.float32)
    return tex, bg


def _tex_mask(opt, tex: np.ndarray) -> Optional[np.ndarray]:
    """(P, T, T, 1) mask of the atlas texels the unfold filled
    (--use_mask_texture), else None."""
    if not opt.use_mask_texture:
        return None
    return (np.abs(tex + 1.0).sum(-1, keepdims=True) > 0.05).astype(np.float32)


def _epochs(opt, epochs: Optional[int]) -> int:
    if epochs is not None:
        return epochs
    return opt.niter if opt.no_decay else opt.niter + opt.niter_decay


# ----------------------------------------------------------------------
# stage 2: end-to-end person-specific training (train.py)
# ----------------------------------------------------------------------

def save_checkpoint(run_dir: str, st, epoch, completed=None) -> None:
    """Stage 2's save: G, D, TransG, G_ema (with --ema_decay) and
    latest_state. An iteration save (epoch 'latest') anchors the state to
    the last completed epoch, so --continue_train resumes in place."""
    ckpt.save_net(run_dir, "G", epoch, st.renderer.state_dict())
    ckpt.save_net(run_dir, "D", epoch, st.disc.state_dict())
    ckpt.save_net(run_dir, "TransG", epoch, st.renderer.TransG.state_dict())
    if st.g_ema is not None:
        ckpt.save_net(run_dir, "G_ema", epoch, st.g_ema)
    anchor = epoch if str(epoch).isdigit() else (
        completed if completed is not None else -1)
    ckpt.save_train_state(run_dir, st.g_opt, st.d_opt, st.step, anchor)
    print(f"[ckpt] saved epoch {epoch} -> {run_dir}", flush=True)


def resume_train(opt, st, steps_per_epoch: int) -> Optional[int]:
    """The --continue_train ladder on --name's run dir, the port's files
    or the JAX package's: G; D (a missing latest D, from a save killed
    midway, keeps the fresh D); the EMA track (restarted from the resumed
    raw weights if this run saved none); the optimizers and the step
    (fresh where the run dir holds no state file, as the JAX package
    resumes); then the epoch to start at: the state's epoch, else the
    numeric epoch files', else step // steps-per-epoch. Returns that
    epoch, or None when there is nothing to resume."""
    run_dir = opt.run_dir
    ep = ckpt.latest_epoch(run_dir, "G")
    if ep is None and not ckpt.has_latest(run_dir, "G"):
        return None
    ckpt.load_net_into(st.renderer, run_dir, "G")
    if ckpt.has_latest(run_dir, "D"):
        ckpt.load_net_into(st.disc, run_dir, "D")
    else:
        print("[ckpt] resume: latest_net_D missing (mid-kill save?); keeping "
              "fresh D init", flush=True)
    if st.g_ema is not None:
        if ckpt.has_latest(run_dir, "G_ema"):
            saved = ckpt.load_net(run_dir, "G_ema")
            if set(saved) != set(st.g_ema):
                raise KeyError(f"{run_dir}: latest_net_G_ema does not match G")
            src = saved
        else:
            src = dict(st.renderer.named_parameters())
        with torch.no_grad():
            for k, v in src.items():
                st.g_ema[k].copy_(v)
    step, saved_ep = ckpt.load_train_state(run_dir, st.g_opt, st.d_opt,
                                           (st.renderer, st.disc))
    if step is not None:
        st.step = step
    if saved_ep is not None and saved_ep > 0:
        start = saved_ep + 1
    elif ep is not None:
        start = int(ep) + 1
    else:
        start = st.step // max(1, steps_per_epoch) + 1
    print(f"[ckpt] resumed at epoch {start} (step {st.step}, optimizer "
          f"state {'restored' if step is not None else 'fresh'})", flush=True)
    return start


def _render(opt, st, b):
    """The renderer's forward of an unpacked batch (its LaplaceProj
    channels and pose images where it has them) on the state's assets,
    with the EMA weights when a track is kept (what inference serves),
    else the raw ones. Under --instance_feat the batch's real frame is
    encoded, so the eval measures the model in the configuration it
    trains in."""
    args = (pose_from_batch(opt, b), st.bg[None], st.static_tex[None],
            st.tex_mask)
    kw = ({"feat_image": b["image"]}
          if (opt.instance_feat or opt.label_feat) and "image" in b else {})
    if st.g_ema is not None:
        return torch.func.functional_call(st.renderer, st.g_ema, args, kw)
    return st.renderer(*args, **kw)


class _RankRows:
    """Samples r, r + world, r + 2 world, ... of a dataset (rank r's share
    of the held-out split: every sample on exactly one rank, none cut);
    ``epoch`` passes through to the dataset, as BatchLoader sets it."""

    def __init__(self, ds, dp: DataParallel):
        self.ds = ds
        self.idx = range(dp.rank, len(ds), dp.world)

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, k):
        return self.ds[self.idx[k]]

    @property
    def epoch(self):
        return self.ds.epoch

    @epoch.setter
    def epoch(self, value):
        self.ds.epoch = value


def _eval_fn(opt, dp: DataParallel):
    """Held-out PSNR / SSIM on the --data_ratio split, on the EMA track;
    None without a held-out split of real frames. Each rank renders its
    share of the split (``_RankRows``) and the sums are added over the
    ranks, so every rank returns the whole split's means."""
    if not 0 < opt.data_ratio < 1:
        return None
    eval_ds = _dataset(opt, "test")
    if isinstance(eval_ds, dsm.SyntheticDataset) or not eval_ds.img_names:
        return None
    loader = dsm.BatchLoader(_RankRows(eval_ds, dp) if dp.parallel
                             else eval_ds, opt.batchSize, shuffle=False,
                             drop_last=False, threads=opt.nThreads)

    @torch.inference_mode()
    def eval_fn(st, epoch):
        sums = torch.zeros(3, dtype=torch.float64, device=dp.device)
        for eb in loader:
            b = unpack_batch(eb, dp.device)
            fake = _render(opt, st, b)["fake"]
            sums[0] += psnr(fake, b["image"]).double().sum()
            sums[1] += ssim(fake, b["image"]).double().sum()
            sums[2] += fake.shape[0]
        ps, ss, n = dp.global_count(sums).tolist()
        return {"val_PSNR": ps / n, "val_SSIM": ss / n} if n else {}

    return eval_fn


def _visuals_fn(opt, device):
    @torch.inference_mode()
    def visuals_fn(st, batch):
        b = unpack_batch({k: v[:1] for k, v in batch.items()}, device)
        outs = _render(opt, st, b)

        def hwc(t):
            return t[0].float().permute(1, 2, 0).cpu().numpy()

        vis = {"synthesized": hwc(outs["fake"]), "foreground": hwc(outs["fg"]),
               "mask": hwc(outs["mask"]) * 2 - 1,
               "bg_refined": hwc(outs["bg_refined"])}
        if "image" in b:
            vis["real"] = hwc(b["image"])
        return vis

    return visuals_fn


def run_train(opt, epochs: Optional[int] = None,
              max_steps: Optional[int] = None,
              dp: Optional[DataParallel] = None):
    """Stage-2 end-to-end training on --gpu_ids (the card unless -1) for
    niter (+ niter_decay) epochs, or ``epochs``, or ``max_steps`` steps.
    The epoch length reaches the optimizers (the LR schedule and
    --niter_fix_global's freeze). Returns the TrainState (None in a
    process that spawned its ranks: ``runtime.launch``); ``dp``: this
    rank, when the caller has started it."""
    if dp is None:
        return launch(run_train, opt, epochs, max_steps, where=opt.run_dir,
                      batch=opt.batchSize)
    device = dp.device
    torch.manual_seed(opt.seed)
    ds = _dataset(opt, "train")
    loader = _loader(opt, ds, dp, shuffle=not opt.serial_batches)
    tex, bg = _assets(opt, ds)
    state = create_train_state(opt, tex, bg, tex_mask=_tex_mask(opt, tex),
                               steps_per_epoch=len(loader), device=device,
                               dp=dp)
    run_dir = opt.run_dir
    start = resume_train(opt, state, len(loader)) if opt.continue_train else None
    if start is not None:
        state.start_epoch = start
        # the epoch order the straight run would have had
        loader.epoch = start - 1
        if dp.is_lead:
            prune_metrics_after(run_dir, start - 1)
    elif opt.continue_train:
        print(f"[ckpt] --continue_train: nothing to resume in {run_dir}; "
              "starting fresh", flush=True)
    if start is None and opt.load_pretrain and os.path.isdir(opt.load_pretrain):
        # warm-start the whole G (and D where saved), fresh optimizers
        ckpt.load_net_into(state.renderer, opt.load_pretrain, "G",
                           opt.which_epoch)
        if ckpt.find_net(opt.load_pretrain, "D", opt.which_epoch):
            ckpt.load_net_into(state.disc, opt.load_pretrain, "D",
                               opt.which_epoch)
        print(f"[ckpt] warm-started G/D from {opt.load_pretrain} "
              f"@ {opt.which_epoch}", flush=True)
    elif start is None and opt.load_pretrain_TransG:
        path = ckpt.load_transg_into(state.renderer, opt.load_pretrain_TransG,
                                     opt.which_epoch_TransG)
        print(f"[ckpt] loaded pretrained TransG from {path}", flush=True)
    dp.check("the stage-2 state at the start", state.tensors())

    step = make_train_step(opt, state.renderer, state.disc, state.vgg,
                           state.g_opt, state.d_opt, dp)
    state = run_training(
        opt, loader, step, state, _epochs(opt, epochs),
        lambda st, epoch, completed=None: save_checkpoint(run_dir, st, epoch,
                                                          completed),
        _visuals_fn(opt, device), _eval_fn(opt, dp),
        start_epoch=state.start_epoch, max_steps=max_steps, dp=dp)
    dp.check("the stage-2 state at the end", state.tensors())
    who = f"{dp} " if dp.parallel else ""
    print(f"[kernels] {who}launches since the counters' reset: "
          f"{json.dumps(kernel_launches())}", flush=True)
    return state


def kernel_launches() -> dict:
    """Each CUDA kernel wrapper's launch count since its counter's reset
    (zero on the CPU, where the wrappers run their plain versions).
    run_train prints it at its end (each rank of a data-parallel run, as
    ``[kernels] rank r of w ...``), so a run in a subprocess can be
    checked from its log."""
    return {"topk_select": tk.topk_select.launches,
            "texture_warp_fwd": tk.texture_warp_fwd.launches,
            "texture_warp_topk_fwd": tk.texture_warp_topk_fwd.launches,
            "texture_warp_bwd": tk.texture_warp_bwd.launches,
            "flow_warp_fwd": fk.flow_warp_fwd.launches,
            "adam_ema": ak.adam_ema.launches}


# ----------------------------------------------------------------------
# stage 1 and the texture pretrain: one generator each
# ----------------------------------------------------------------------

def _run_single_net(opt, label: str, ds, net: torch.nn.Module, make_step,
                    epochs: Optional[int], max_steps: Optional[int],
                    dp: DataParallel):
    """The pretrain stages' driver: resume the net from --name's run dir
    (the latest file, .pth or the JAX package's .msgpack; the epoch from
    the numeric files or the anchor), fresh Adam (neither package saves a
    pretrain stage's optimizer), then the loop saving {epoch}_net_{label}
    and the epoch anchor. Data parallel as run_train's."""
    device = dp.device
    net = init_params(net, opt.seed).to(device).train()
    dp.replicate(module_tensors(net))
    loader = _loader(opt, ds, dp)
    run_dir = opt.run_dir
    start = 1
    if opt.continue_train:
        ep = ckpt.latest_epoch(run_dir, label)
        if ep is not None or ckpt.has_latest(run_dir, label):
            ckpt.load_net_into(net, run_dir, label)
            if ep is None:
                anchor = ckpt.load_epoch_anchor(run_dir)
                ep = anchor if anchor is not None else 0
                if anchor is None:
                    print("[ckpt] resume: latest-only save with no epoch "
                          "anchor; keeping weights, restarting schedule at 1",
                          flush=True)
            start = int(ep) + 1
            loader.epoch = start - 1
            if dp.is_lead:
                prune_metrics_after(run_dir, start - 1)
            print(f"[ckpt] resumed at epoch {start}", flush=True)
            dp.check(f"the resumed {label}", module_tensors(net))
    state = PretrainState(step=0, net=net, device=device,
                          optimizer=make_optimizer(opt, net.named_parameters(),
                                                   len(loader)))

    def save_fn(st, epoch, completed=None):
        ckpt.save_net(run_dir, label, epoch, st.net.state_dict())
        anchor = epoch if str(epoch).isdigit() else completed
        if anchor is not None:
            ckpt.save_epoch_anchor(run_dir, int(anchor))
        print(f"[ckpt] saved epoch {epoch} -> {run_dir}", flush=True)

    n_epochs = epochs if epochs is not None else opt.niter
    state = run_training(opt, loader, make_step(state, dp), state, n_epochs,
                         save_fn, start_epoch=start, max_steps=max_steps,
                         dp=dp)
    dp.check(f"the {label} state at the end", module_tensors(state.net)
             + optimizer_tensors(state.optimizer))
    return state


def run_pretrain_uv(opt, epochs: Optional[int] = None,
                    max_steps: Optional[int] = None,
                    dp: Optional[DataParallel] = None) -> PretrainState:
    """Stage 1: person-agnostic TransG pretrain on DensePose pseudo-GT
    (pre_train.py) for --niter epochs; saves {epoch}_net_TransG. Returns
    the PretrainState (None where this process spawned the ranks)."""
    if dp is None:
        return launch(run_pretrain_uv, opt, epochs, max_steps,
                      where=opt.run_dir, batch=opt.batchSize)
    torch.manual_seed(opt.seed)
    return _run_single_net(
        opt, "TransG", _dataset(opt, "train"),
        renderer_from_options(opt).TransG,          # stage 2's TransG
        lambda st, dp: make_pretrain_uv_step(opt, st.net, st.optimizer, dp),
        epochs, max_steps, dp)


class _TexDataset:
    """A base dataset with each sample's part-texture GT: the atlas image
    of --part_texture_path for the frame (and of --pose_texture_path where
    given); without that directory, the static atlas plus a deterministic
    wave. The base sample's flip and crop (its pose, and the bg window or
    mirror flag the step does not read) pass through; the part textures
    live in atlas space and stay as they are, as in the JAX package."""

    def __init__(self, opt, base):
        self.opt = opt
        self.base = base

        def files(d):
            return sorted(os.listdir(d)) if d and os.path.isdir(d) else []

        self.files = files(opt.part_texture_path)
        self.pose_tex_files = files(opt.pose_texture_path)
        self._static = (base.texture_atlas() if hasattr(base, "texture_atlas")
                        else np.zeros((opt.n_parts, opt.tex_tile, opt.tex_tile,
                                       3), np.float32))

    def __len__(self):
        return len(self.base)

    @property
    def epoch(self):
        return getattr(self.base, "epoch", 0)

    @epoch.setter
    def epoch(self, value):
        # BatchLoader's per-epoch advance reaches the wrapped dataset
        if hasattr(self.base, "epoch"):
            self.base.epoch = value

    def _atlas(self, d, names, i):
        return dsm.load_texture_atlas(
            os.path.join(d, names[min(i, len(names) - 1)]), self.opt.tex_tile,
            self.opt.tex_rows, self.opt.tex_cols)

    def __getitem__(self, k):
        s = self.base[k]
        i = int(s["index"])
        if self.files:
            s["part_texture"] = self._atlas(self.opt.part_texture_path,
                                            self.files, i)
            if self.pose_tex_files:
                s["pose_texture"] = self._atlas(self.opt.pose_texture_path,
                                                self.pose_tex_files, i)
        else:
            s["part_texture"] = np.clip(
                self._static + 0.1 * np.sin(0.3 * i), -1, 1).astype(np.float32)
        return s


def texg_from_options(opt) -> TexG:
    """The texture pretrain's TexG of the flags, on the meta device (its
    driver initialises it from --seed)."""
    with torch.device("meta"):
        return TexG(opt.pose_nc, opt.n_parts, opt.tex_tile, opt.ngf_global,
                    opt.n_downsample_global, opt.n_blocks_global,
                    netG=opt.netG, n_local_enhancers=opt.n_local_enhancers,
                    n_blocks_local=opt.n_blocks_local, stem_s2d=opt.stem_s2d,
                    head_s2d=opt.head_s2d, pad_mode=opt.pad_mode,
                    upsample_mode=opt.upsample_mode,
                    dtype=torch.bfloat16 if opt.dtype == "bfloat16"
                    else torch.float32)


def run_pretrain_tex(opt, epochs: Optional[int] = None,
                     max_steps: Optional[int] = None,
                     dp: Optional[DataParallel] = None) -> PretrainState:
    """Texture pretrain: TexG against per-frame part textures
    (pre_train_tex.py) for --niter epochs; saves {epoch}_net_TexG. Returns
    the PretrainState (None where this process spawned the ranks)."""
    if dp is None:
        return launch(run_pretrain_tex, opt, epochs, max_steps,
                      where=opt.run_dir, batch=opt.batchSize)
    torch.manual_seed(opt.seed)
    base = _dataset(opt, "train")
    tex, _ = _assets(opt, base)
    device = dp.device
    static_tex = to_nchw(tex, device)
    tex_mask = to_nchw(_tex_mask(opt, tex), device)
    return _run_single_net(
        opt, "TexG", _TexDataset(opt, base), texg_from_options(opt),
        lambda st, dp: make_pretrain_tex_step(opt, st.net, st.optimizer,
                                              static_tex, tex_mask, dp),
        epochs, max_steps, dp)


def main(argv=None) -> int:
    opt = TrainOptions().parse(argv)
    run_train(opt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
