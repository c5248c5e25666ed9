"""Pose-input assembly, the inference forward and the stage-2 train step.

Port of the JAX package's ``train/steps.py``: ``build_pose_input``,
``make_forward_fn``, ``make_train_step`` and the stage-1 UV and texture
pretrain steps (``make_pretrain_uv_step``, ``make_pretrain_tex_step``).
The JAX package's ``ema_blend`` is ``ema_decay`` here with
``state.blend_ema``, which on the card the stage-2 step folds into G's
Adam update (``ScheduledAdam.update``).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import losses as L
from ..data.rasterize import joint_heatmaps, limb_coord_maps, render_skeleton
from ..data.wire import dequantize, host_tensors
from ..parallel.mesh import DataParallel, optimizer_tensors
from ..utils import spans
from ..utils.host_point import host_point
from ..utils.spans import span
from .graphs import Dispatch
from .image_pool import pool_draws, pool_update
from .state import ScheduledAdam, blend_ema


def build_pose_input(opt, joints: torch.Tensor,
                     laplace: Optional[torch.Tensor] = None,
                     pose_img: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 18, 3) joints -> (B, pose_nc, S, S) float32 pose labels.

    Channel order: the 3-channel pose render (a pre-rendered pose image
    (B, 3, S, S) where the dataset gives one, else the skeleton rasterized
    from the joints), then (--pose_heatmaps) 18 joint heatmaps mapped to
    [-1, 1], then (--coord_conv) the x ramp and the y ramp in [-1, 1], then
    (--limb_coords) two limb-local channels a limb, then (--use_laplace)
    the LaplaceProj channels (B, laplace_nc_eff, S, S): 78 under the
    --input_nc 81 contract, laplace_nc otherwise, zeros where none are
    given. The render is left out under --use_laplace with --input_nc 3
    and no --pose_plus_laplace (``opt.use_pose_render``).
    """
    S = opt.train_size
    B, dev = joints.shape[0], joints.device
    chans = []
    if opt.use_pose_render:
        chans.append(pose_img if pose_img is not None
                     else render_skeleton(joints, S, S))
    if opt.pose_heatmaps:
        chans.append(joint_heatmaps(joints, S, S, sigma=opt.heatmap_sigma)
                     * 2.0 - 1.0)
    if opt.coord_conv:
        ramp = torch.linspace(-1.0, 1.0, S, dtype=torch.float32, device=dev)
        chans.append(ramp.view(1, 1, 1, S).expand(B, 1, S, S))
        chans.append(ramp.view(1, 1, S, 1).expand(B, 1, S, S))
    if opt.limb_coords:
        chans.append(limb_coord_maps(joints, S, S, sigma=opt.limb_sigma))
    if opt.use_laplace:
        if laplace is None:
            laplace = torch.zeros((B, opt.laplace_nc_eff, S, S),
                                  dtype=torch.float32, device=dev)
        chans.append(laplace)
    pose = torch.cat(chans, dim=1)
    if pose.shape[1] != opt.pose_nc:
        raise ValueError(
            f"pose input has {pose.shape[1]} channels, config demands "
            f"{opt.pose_nc} (input_nc={opt.input_nc}, use_laplace="
            f"{opt.use_laplace}, laplace channels {opt.laplace_nc_eff})")
    return pose


def pose_from_batch(opt, b: Dict[str, torch.Tensor],
                    prev: bool = False) -> torch.Tensor:
    """build_pose_input on an unpacked batch: frame t, or (prev) frame t-1
    from joints_prev and pose_img_prev. Frame t-1 takes frame t's
    LaplaceProj channels, as the JAX package's step does."""
    if prev:
        return build_pose_input(opt, b["joints_prev"], b.get("laplace"),
                                b.get("pose_img_prev"))
    return build_pose_input(opt, b["joints"], b.get("laplace"),
                            b.get("pose_img"))


def _module_device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def make_forward_fn(opt, renderer, cluster_feats=None
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Inference forward: (assets, joints[, laplace, pose_img, feat_image])
    -> rendered frame dict.

    assets = (static_tex (P, 3, T, T), bg (3, S, S), tex_mask or None) on
    the renderer's device; they enter with batch 1, so BGNet runs once per
    batch and the compositor broadcasts. laplace (B, C, S, S) and pose_img
    (B, 3, S, S) feed build_pose_input. Under --instance_feat: feat_image
    (B, 3, S, S), a real frame, is encoded as the train step encodes it
    (held-out eval); else cluster_feats (P+1, feat_num), the codes of
    --load_features; else zero codes.

    On the card the forward is a captured program (``train/graphs.py``,
    the counterpart of the JAX package's ``jax.jit(fwd)``): one CUDA graph
    per (batch shape, inputs present), the assets held by the graph as
    the closure's constants (other asset tensors drop the captures and
    capture anew), the batch's inputs copied into static buffers, the
    outputs cloned. On the CPU it runs eagerly. ``fwd.eager`` is the
    eager forward on any device (the graph's plain version).
    """
    dev = _module_device(renderer)
    codes = None
    if renderer.use_feat and cluster_feats is not None:
        codes = torch.as_tensor(np.asarray(cluster_feats, np.float32)).to(dev)

    def eager(assets, joints, laplace=None, pose_img=None, feat_image=None):
        static_tex, bg, tex_mask = assets
        pose = build_pose_input(opt, joints, laplace, pose_img)
        kw = {}
        if renderer.use_feat and feat_image is not None:
            kw["feat_image"] = feat_image
        elif codes is not None:
            kw["cluster_feats"] = codes
        return renderer(pose, bg[None], static_tex[None], tex_mask, **kw)

    dispatch = Dispatch("forward", dev)

    @torch.inference_mode()
    def fwd(assets: Tuple[torch.Tensor, torch.Tensor, object],
            joints: torch.Tensor, laplace: Optional[torch.Tensor] = None,
            pose_img: Optional[torch.Tensor] = None,
            feat_image: Optional[torch.Tensor] = None
            ) -> Dict[str, torch.Tensor]:
        assets = tuple(assets)
        inputs = {k: v for k, v in (
            ("joints", joints), ("laplace", laplace), ("pose_img", pose_img),
            ("feat_image", feat_image)) if v is not None}
        return dispatch(
            lambda: eager(assets, joints, laplace, pose_img, feat_image),
            assets, None, inputs, lambda st: lambda: eager(
                assets, st["joints"], st.get("laplace"), st.get("pose_img"),
                st.get("feat_image")),
            state=lambda: list(renderer.buffers()))

    fwd.program = dispatch.program
    fwd.eager = torch.inference_mode()(eager)
    return fwd


def ema_decay(step, decay: float):
    """The effective decay min(decay, (1 + t) / (10 + t)), t = step + 1, in
    float32: a numpy float32 for a Python step, a () float32 tensor on the
    step's device for a tensor step (the same IEEE float32 operations, so
    the same bits)."""
    if torch.is_tensor(step):
        t = (step + 1).to(torch.float32)
        return torch.clamp((1.0 + t) / (10.0 + t),
                           max=float(np.float32(decay)))
    t = np.float32(step + 1)
    return min(np.float32(decay),
               (np.float32(1.0) + t) / (np.float32(10.0) + t))


def _slice_outs(outs, n: int):
    """The first n samples of every tensor of a renderer output dict (the
    ms_aux pairs included)."""
    if isinstance(outs, dict):
        return {k: _slice_outs(v, n) for k, v in outs.items()}
    if isinstance(outs, (tuple, list)):
        return type(outs)(_slice_outs(v, n) for v in outs)
    return outs[:n]


def optimizer_params(optimizer: torch.optim.Optimizer):
    return [p for g in optimizer.param_groups for p in g["params"]]


def _parallel(dp: Optional[DataParallel]):
    """(dp, the masked means' count reducer) of a step: a lone rank and no
    reducer without data parallel."""
    dp = dp if dp is not None else DataParallel()
    return dp, (dp.count_share if dp.parallel else None)


def _no_mark(name: str) -> None:
    pass


def _update(optimizer, ema=None) -> None:
    """The optimizer's update inside a step's body: ScheduledAdam's
    (prepare and advance run around the body; ``ema``, (parameter, EMA
    tensor) pairs and the decay, handed to it), else a plain step followed
    by the EMA's blend."""
    if isinstance(optimizer, ScheduledAdam):
        optimizer.update(ema)
        return
    optimizer.step()
    if ema is not None:
        blend_ema(*ema)


def make_train_step(opt, renderer, disc, vgg, g_opt, d_opt,
                    dp: Optional[DataParallel] = None) -> Callable:
    """The stage-2 end-to-end G + D train step.

    step(state, batch, mark=None) -> metrics (float32 scalars on the
    device). ``batch`` is a host batch (raw or wire-packed, NHWC numpy);
    its upload and dequantisation are the step's first op. The step
    updates ``state`` in place. Update semantics are the JAX package's:
      * G's loss sees D frozen (D's parameters do not require grad during
        the G backward) and D's real features detached in the
        feature-matching term;
      * D's loss sees the fake detached and the OLD D parameters;
      * both optimizers step after both backwards, and the EMA blends
        from G's new parameters with the step count before the increment
        (on the card in the same pass as G's Adam update).
    Temporal modes: --temporal_prev real flow-warps the real t-1 frame;
    --temporal_prev fake renders frame t-1 a second time under no_grad
    (temporal_detach_prev), or, with --no_temporal_detach_prev, renders t
    and t-1 in ONE forward of the 2B batch [t ; t-1], so the temporal
    loss pulls both frames (D sees frame t only). A crop-mode batch brings
    each sample's background window (``bg``; tiled to 2B in the symmetric
    mode), a flip batch its mirror flags (``bg_flip``), which the renderer
    applies to the refined background. --lambda_UVgrad adds G_UVgrad,
    --ms_uv G_MSUV (the aux heads against the subsampled pseudo-GT,
    without the mask, weighted lambda_MS against the UV and CE weights).
    --pool_size > 0 passes D's fake input through the image pool of the
    state (``train/image_pool.py``). ``mark(name)``, when given, is
    called at the end of each phase (inputs: the upload and the pose
    input; prev_render; g_forward; d_for_g; vgg; g_losses; g_backward;
    d_step; grad_all_reduce; update) so a caller can time the phases.
    Under --instance_feat the renderer encodes the real frame t (and, for
    the t-1 render, the real frame t-1: image_prev).

    Data parallel (``dp``, parallel/mesh.py): the batch is this rank's
    share of the global batch. The masked means divide by the global
    count, both optimizers' gradients are averaged over the ranks before
    either steps, the pool sees the global batch (every rank draws the
    same draws, gathers the global fakes and updates its identical pool,
    then takes its own rows), and the returned metrics are the ranks'
    mean: the global batch's losses, as the JAX step computes them on a
    mesh.

    On the card the step is a captured program (``train/graphs.py``, the
    counterpart of the JAX package's ``jax.jit(step, donate_argnums=(0,))``):
    one CUDA graph chain per (batch signature, freeze state), the state's
    tensors updated in place by every replay. What the eager step reads
    on the host each step lives on the device or around the replay: the
    EMA's decay comes from the device step counter ``state.step_t``; Adam
    runs with a device learning rate that ``ScheduledAdam`` fills from its
    schedule before the replay, as one kernel pass an optimizer, the EMA
    folded into G's; the pool's draws come from
    the state's generator before the replay, into static buffers; the
    --niter_fix_global freeze is a Python branch, so the freeze boundary
    captures a second graph. The data-parallel collectives are host
    points between the graphs (gloo cannot be captured), and so are the
    device marks ``step.g_forward.end`` (after the renderer's forward) and
    ``step.g_backward.end`` (after G's backward), which split the chain
    into the generator's forward, its losses and backward, and D's step
    with both updates (read by the benchmark's ``g_forward_ms.train``,
    ``g_backward_ms.train`` and ``d_update_ms.train``). The eager route
    (every call on the CPU, a call with ``mark`` on the card: the same
    code), the refusal of a caught out-of-memory error and the span
    ``step.prepare`` (the learning rates, the step counter, the pool's
    draws) are the shell's (``_step_shell``).
    """
    dp, count = _parallel(dp)
    use_temporal = opt.lambda_Temp > 0
    use_vgg = (not opt.no_vgg_loss) and vgg is not None
    use_fm = not opt.no_ganFeat_loss
    use_lsgan = not opt.no_lsgan
    real_prev = use_temporal and opt.temporal_prev == "real"
    detach_prev = use_temporal and opt.temporal_detach_prev and not real_prev
    symmetric = use_temporal and not detach_prev and not real_prev
    use_feat = opt.instance_feat or opt.label_feat
    dev = _module_device(renderer)

    def prepare(state, batch) -> Dict[str, torch.Tensor]:
        """The device step counter and the pool's draws (returned as
        inputs)."""
        if state.step_t is None:
            state.step_t = torch.zeros((), dtype=torch.int64,
                                       device=state.device)
        if state.step_t_at != state.step:
            state.step_t.fill_(state.step)
            state.step_t_at = state.step
        if opt.pool_size <= 0:
            return {}
        rows = len(batch["joints"]) * (dp.world if dp.parallel else 1)
        uni, perm, coin = pool_draws(state.pool_gen, rows, opt.pool_size)
        draws = {"pool_uni": uni, "pool_coin": coin}
        if perm is not None:
            draws["pool_perm"] = perm
        return draws

    def body(state, raw: Dict[str, torch.Tensor], mark=_no_mark):
        """The device work of one step: from the uploaded wire batch and
        the pool's draws to the metrics."""
        batch = dequantize({k: v for k, v in raw.items()
                            if not k.startswith("pool_")})
        pose = pose_from_batch(opt, batch)
        B = pose.shape[0]
        real = batch["image"]
        tex, bg, tex_mask = state.static_tex[None], state.bg[None], \
            state.tex_mask
        if "bg" in batch:
            bg = batch["bg"]
        flip_kw = ({"bg_flip": batch["bg_flip"]} if "bg_flip" in batch
                   else {})
        pose_prev = None
        if use_temporal and not real_prev:
            pose_prev = pose_from_batch(opt, batch, prev=True)
        mark("inputs")
        g_opt.zero_grad(set_to_none=True)
        d_opt.zero_grad(set_to_none=True)
        prev_fake = None
        if detach_prev:
            with torch.no_grad():
                prev_kw = ({"feat_image": batch.get("image_prev", real)}
                           if use_feat else {})
                prev_fake = renderer(pose_prev, bg, tex, tex_mask,
                                     **prev_kw, **flip_kw)["fake"]
            mark("prev_render")
        elif real_prev:
            prev_fake = batch["image_prev"]

        # ---- G: D frozen, its real features detached
        disc.requires_grad_(False)
        if symmetric:
            kw2 = {}
            if use_feat:
                kw2["feat_image"] = torch.cat(
                    [real, batch.get("image_prev", real)], dim=0)
            if flip_kw:
                kw2["bg_flip"] = torch.cat([batch["bg_flip"]] * 2, dim=0)
            bg2 = torch.cat([bg, bg], dim=0) if bg.shape[0] == B else bg
            outs = renderer(torch.cat([pose, pose_prev], dim=0), bg2, tex,
                            tex_mask, **kw2)
            cur = _slice_outs(outs, B)
            prev_fake = outs["fake"][B:]
        else:
            kw1 = {"feat_image": real} if use_feat else {}
            cur = renderer(pose, bg, tex, tex_mask, **kw1, **flip_kw)
        fake = cur["fake"]
        mark("g_forward")
        host_point(lambda: spans.device_mark("step.g_forward.end", dev))
        d_fake = disc(torch.cat([pose, fake], dim=1))
        losses = {"G_GAN": L.lsgan_loss_g(d_fake, use_lsgan)}
        if use_fm:
            with torch.no_grad():
                d_real = disc(torch.cat([pose, real], dim=1))
            losses["G_FM"] = L.feature_matching_loss(d_real, d_fake,
                                                     opt.lambda_feat)
        mark("d_for_g")
        if use_vgg:
            losses["G_VGG"] = opt.lambda_feat * L.vgg_loss(vgg, fake, real)
            mark("vgg")
        if opt.lambda_L2 > 0:
            losses["G_L2"] = opt.lambda_L2 * L.l2_loss(fake, real)
        if opt.use_densepose_loss and "dp_parts" in batch:
            losses["G_UV"] = opt.lambda_UV * L.uv_loss(
                cur["uv"], batch["dp_uv"], batch["dp_parts"], count)
            losses["G_Prob"] = opt.lambda_Prob * L.part_ce_loss(
                cur["logits"], batch["dp_parts"])
            if opt.lambda_UVgrad > 0:
                losses["G_UVgrad"] = opt.lambda_UVgrad * L.uv_grad_loss(
                    cur["uv"], batch["dp_uv"], batch["dp_parts"], count)
            if opt.ms_uv > 0:
                ms_uv_l, ms_ce_l = L.ms_iuv_loss(
                    cur["ms_aux"], batch["dp_uv"], batch["dp_parts"],
                    count=count)
                losses["G_MSUV"] = opt.lambda_MS * (
                    opt.lambda_UV * ms_uv_l + opt.lambda_Prob * ms_ce_l)
        if opt.lambda_Mask > 0 and "mask" in batch:
            losses["G_Mask"] = opt.lambda_Mask * L.mask_loss(cur["mask"],
                                                             batch["mask"])
        if use_temporal and "flow" in batch:
            losses["G_Temp"] = opt.lambda_Temp * L.temporal_flow_loss(
                fake, prev_fake, batch["flow"], batch["flow_inv"], count)
        g_total = functools.reduce(torch.add, losses.values())
        mark("g_losses")
        g_total.backward()
        mark("g_backward")
        host_point(lambda: spans.device_mark("step.g_backward.end", dev))

        # ---- D: the fake detached (through the pool), the old parameters
        disc.requires_grad_(True)
        d_in_fake = torch.cat([pose, fake.detach()], dim=1)
        if opt.pool_size > 0:
            fresh = dp.gather_rows(d_in_fake)
            draws = (raw["pool_uni"], raw.get("pool_perm"), raw["pool_coin"])
            pooled, pool_n = pool_update(state.pool_buf, state.pool_n, fresh,
                                         draws)
            state.pool_n.copy_(pool_n)
            d_in_fake = pooled[dp.rows(pooled.shape[0])]
        d_real = disc(torch.cat([pose, real], dim=1))
        d_fake = disc(d_in_fake)
        d_total = L.lsgan_loss_d(d_real, d_fake, use_lsgan)
        d_total.backward()
        mark("d_step")
        dp.all_reduce_grads(optimizer_params(g_opt))
        dp.all_reduce_grads(optimizer_params(d_opt))
        mark("grad_all_reduce")

        # ---- both updates, the EMA handed to G's (on the card one pass)
        ema = None
        if opt.ema_decay > 0 and state.g_ema is not None:
            ema = ([(p, state.g_ema[k]) for k, p in
                    renderer.named_parameters()],
                   ema_decay(state.step_t, opt.ema_decay))
        _update(g_opt, ema)
        _update(d_opt)
        state.step_t.add_(1)
        mark("update")
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["G_total"] = g_total.detach()
        metrics["D_total"] = d_total.detach()
        return dp.all_reduce_metrics(metrics)

    def finish(state) -> None:
        state.step_t_at = state.step

    def held(state) -> tuple:
        """What the graphs address: a new state, optimizer state, EMA, pool
        or assets drops the captures and captures anew."""
        return (state, g_opt.state, d_opt.state, state.g_ema, state.pool_buf,
                state.pool_n, state.static_tex, state.bg, state.tex_mask,
                state.step_t)

    # the warm-up saves the state's tensors: the step's optimizers are the
    # state's, or hold none (plain SGD)
    step = _step_shell("step", dev, (g_opt, d_opt), body, held,
                       lambda state: state.tensors() + [state.step_t],
                       prepare, finish)
    if step.program is not None:
        # read by replay_ms.train, replay_gap_ms.train
        step.program.marks = True
    return step


def _step_shell(name: str, dev: torch.device, optimizers, body: Callable,
                held: Callable, tensors: Callable,
                prepare: Callable = lambda state, batch: {},
                finish: Callable = lambda state: None) -> Callable:
    """The stage-2 step's and the pretrains' shell around their device
    ``body(state, raw, mark)`` (the uploaded wire batch and ``prepare``'s
    inputs -> the metrics). step(state, batch, mark=None) -> metrics:
      1. the span ``<name>.prepare``: ScheduledAdam's learning rates, then
         ``prepare(state, batch)``'s device inputs;
      2. the body through one ``graphs.Dispatch`` of ``name``: eagerly on
         the batch uploaded where there is no program (the CPU) or
         ``mark`` is given (the caller asked for per-phase times), else
         replayed on the host batch copied in, one capture per (the
         objects ``held(state)`` lists, the freeze state, the batch's
         signature), with ``tensors(state)`` the state a capture's
         warm-up saves and restores. On the card a capture, or an eager
         call, in which a caller caught an out-of-memory error and went
         on raises ``graphs.CaughtOutOfMemory`` (the arithmetic would
         depend on the memory free);
      3. the update counts, the step count, then ``finish(state)``."""
    scheduled = [o for o in optimizers if isinstance(o, ScheduledAdam)]
    dispatch = Dispatch(name, dev)

    def step(state, batch, mark: Optional[Callable[[str], None]] = None):
        with span(name + ".prepare"):
            for o in scheduled:
                o.prepare()
            draws = prepare(state, batch)
        host = host_tensors(batch)

        def eager():
            raw = {k: v.to(state.device, non_blocking=True)
                   for k, v in host.items()}
            return body(state, {**raw, **draws}, mark or _no_mark)

        metrics = dispatch(
            eager, held(state), tuple(o.freezing for o in scheduled),
            {**host, **draws},
            lambda st: lambda: body(state, st), lambda: tensors(state),
            eagerly=mark is not None)
        for o in scheduled:
            o.advance()
        state.step += 1
        finish(state)
        return metrics

    step.program = dispatch.program
    return step


def _single_net_step(name: str, net: torch.nn.Module, optimizer,
                     body: Callable, keep: Tuple = ()) -> Callable:
    """A pretrain step from its device ``body(raw, mark)`` (the uploaded
    wire batch -> the metrics: dequantisation, forward, losses, backward,
    the gradients' all-reduce and the optimizer's update; a plain
    optimizer, not a ScheduledAdam, steps there) in ``_step_shell``:
    step(state, batch, mark=None) -> metrics, updating ``net``, the
    optimizer and state.step in place. On the card the body is a captured
    program (the counterpart of the JAX package's ``jax.jit(step,
    donate_argnums=(0, 1))``) held by the net, the optimizer's state and
    ``keep`` (assets the body reads), whose warm-up saves and restores
    the net's parameters and buffers and the optimizer's tensors."""
    return _step_shell(
        name, _module_device(net), (optimizer,),
        lambda state, raw, mark=_no_mark: body(raw, mark),
        # a new net, optimizer state (a resume) or asset drops the captures
        lambda state: (net, optimizer.state) + tuple(keep),
        lambda state: [*net.parameters(), *net.buffers()]
        + optimizer_tensors(optimizer))


def make_pretrain_uv_step(opt, transg, optimizer,
                          dp: Optional[DataParallel] = None) -> Callable:
    """Stage 1: supervised IUV regression of TransG, the UV L1 at the GT
    part plus the part cross-entropy inside the mask, weighted by
    --lambda_UV (1000 when unset) and --lambda_Prob (10 when unset); with
    --lambda_UVgrad the UV-gradient L1 (UVgrad), with --ms_uv the aux
    heads' UV L1 and masked cross-entropy (MSUV, weighted lambda_MS
    against the same weights).

    step(state, batch, mark=None) -> metrics (UV, Prob[, UVgrad][,
    MSUV], total), updating transg and state.step in place (state: a
    PretrainState); ``mark(name)`` at the end of each phase (inputs,
    forward, losses, backward, grad_all_reduce, update). Captured on the
    card (``_single_net_step``). Data parallel as make_train_step's."""
    dp, count = _parallel(dp)
    w_uv = opt.lambda_UV if opt.lambda_UV > 0 else 1000.0
    w_prob = opt.lambda_Prob if opt.lambda_Prob > 0 else 10.0

    def body(raw, mark=_no_mark):
        b = dequantize(raw)
        pose = pose_from_batch(opt, b)
        mark("inputs")
        optimizer.zero_grad(set_to_none=True)
        tout = transg(pose)
        logits, uv = tout[0], tout[1]
        mark("forward")
        losses = {"UV": w_uv * L.uv_loss(uv, b["dp_uv"], b["dp_parts"],
                                         count),
                  "Prob": w_prob * L.part_ce_loss(logits, b["dp_parts"],
                                                  b.get("mask"), count)}
        if opt.lambda_UVgrad > 0:
            losses["UVgrad"] = opt.lambda_UVgrad * L.uv_grad_loss(
                uv, b["dp_uv"], b["dp_parts"], count)
        if opt.ms_uv > 0:
            ms_uv_l, ms_ce_l = L.ms_iuv_loss(tout[2], b["dp_uv"],
                                             b["dp_parts"], b.get("mask"),
                                             count)
            losses["MSUV"] = opt.lambda_MS * (w_uv * ms_uv_l
                                              + w_prob * ms_ce_l)
        total = functools.reduce(torch.add, losses.values())
        mark("losses")
        total.backward()
        mark("backward")
        dp.all_reduce_grads(optimizer_params(optimizer))
        mark("grad_all_reduce")
        _update(optimizer)
        mark("update")
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total"] = total.detach()
        return dp.all_reduce_metrics(metrics)

    return _single_net_step("pretrain_uv", transg, optimizer, body)


def make_pretrain_tex_step(opt, texg, optimizer, static_tex: torch.Tensor,
                           tex_mask: Optional[torch.Tensor] = None,
                           dp: Optional[DataParallel] = None) -> Callable:
    """Texture pretrain: TexG's dynamic texture clip(static + residual)
    against the per-frame part textures (L1; residual and error confined
    to the texel mask when given), plus the L1 against a pose-conditioned
    texture where the batch has one. static_tex (P, 3, T, T), tex_mask
    (P, 1, T, T) on the device.

    step(state, batch, mark=None) -> {"Tex_L1": loss}, updating texg and
    state.step in place; marks as make_pretrain_uv_step's. Captured on the
    card, static_tex and tex_mask held by the capture. Data parallel as
    make_train_step's (its means are plain)."""
    dp, _ = _parallel(dp)

    def body(raw, mark=_no_mark):
        b = dequantize(raw)
        pose = pose_from_batch(opt, b)
        gt = b["part_texture"].permute(0, 1, 4, 2, 3)     # (B, P, 3, T, T)
        mark("inputs")
        optimizer.zero_grad(set_to_none=True)
        res = texg(pose)
        mark("forward")
        if tex_mask is not None:
            res = res * tex_mask
        dyn = torch.clamp(static_tex[None] + res, -1.0, 1.0)
        err = torch.abs(dyn - gt)
        if tex_mask is not None:
            err = err * tex_mask
        loss = err.mean()
        if "pose_texture" in b:
            loss = loss + torch.abs(
                dyn - b["pose_texture"].permute(0, 1, 4, 2, 3)).mean()
        mark("losses")
        loss.backward()
        mark("backward")
        dp.all_reduce_grads(optimizer_params(optimizer))
        mark("grad_all_reduce")
        _update(optimizer)
        mark("update")
        return dp.all_reduce_metrics({"Tex_L1": loss.detach()})

    return _single_net_step("pretrain_tex", texg, optimizer, body,
                            keep=(static_tex, tex_mask))
