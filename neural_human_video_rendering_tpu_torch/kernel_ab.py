#!/usr/bin/env python3
"""Device time of the port's warp kernels of one checkout, so that two
checkouts (a parent commit unpacked into a git-ignored directory, and this
one) are compared on one card:

    python3 neural_human_video_rendering_tpu_torch/kernel_ab.py --tree DIR

DIR is the root of a checkout (default: this one); its package and its
csrc/ are the ones timed, built into DIR/build/kernels. The inputs, the
timing (20 calls in a CUDA graph, replayed between CUDA events) and the
grid_sample yardstick are this checkout's chip_smoke.py's:
  * the flow warp at B=2, C=5, 512x512 on an i.i.d. noise flow and on a
    smooth flow;
  * the warp backward at B=2, P=24, T=64, k=4, eps 1e-3 on random uv;
  * the texture-warp forward at P=24, T=64, k=4, eps 1e-3 on three input
    sets of batch 8: random uv / probs; the flagship renderer's own
    texture / uv / probs (random weights, cached in build/kernel_ab/ by
    the first run, so that every run times the same tensors; a random-init
    renderer's part maps are as incoherent as random ones); and coherent
    inputs, the shape of a trained renderer's (part maps constant over
    16 x 16-pixel blocks, uv an affine map per part). On each:
    texture_warp_fwd with w given at B=2 and B=8; the serving route,
    texture_warp_planes under torch.inference_mode at B=8; and the train
    step's forward launches at B=2: texture_warp_topk_fwd keeping w where
    the tree has it, else topk_select and then texture_warp_fwd.
With --step it times the flagship stage-2 step instead (chip_smoke phase
6's fixed-batch step: this checkout's chip_smoke.py TRAIN flags, 512 px,
batch 2, the recipe's losses, random weights from --seed 0, one
pre-packed batch, no loader): 5 warm-up steps, then 30 steps each ended
by a synchronise (host clock), first as make_train_step returns the step
(graphed on the card where the tree captures it, eager in a tree before
that), then eager (a call with a mark), then the phases of 10 more by
CUDA events (make_train_step's marks, eager); it prints the median,
quartiles and minimum of each route, the tree's route, and the phases'
medians. With --step --stage uv (or tex) it times a pretrain step the same
way at chip_smoke phase 16's point (stage 1: 512 px, batch 6, the
flagship's TransG, bf16; the texture pretrain: 200 px, batch 2, TexG
64/2/5 over the LaplaceProj input): the step as make_pretrain_uv_step /
make_pretrain_tex_step returns it (graphed on the card), then the eager
closure (a call with a mark), from one start; a tree whose pretrain steps
take no mark (before they were graphed) is timed on its one route.
Run parent, change, change, parent in one command. Prints one JSON line;
exits non-zero without a CUDA card.
"""

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def renderer_inputs(torch, smoke, dev, B=8):
    """The flagship renderer's (texture, uv, probs) for B synthetic driving
    poses (random weights from --seed 0, as chip_smoke's phase 3 renders
    them), made once and then read back from build/kernel_ab/."""
    import numpy as np
    from neural_human_video_rendering_tpu_torch.config import TestOptions
    from neural_human_video_rendering_tpu_torch.infer import test_driver as td
    from neural_human_video_rendering_tpu_torch.train.steps import \
        make_forward_fn
    work = os.path.join(ROOT, "build", "kernel_ab")
    cache = os.path.join(work, "renderer_tensors.pt")
    if os.path.isfile(cache):
        return torch.load(cache, map_location=dev)
    kp_dir = os.path.join(work, "keypoints")
    opt = TestOptions().parse(smoke.FLAGSHIP + [
        "--pose_path", kp_dir, "--checkpoints_dir", os.path.join(work, "ckpt"),
        "--name", "kernel_ab"], save=False)
    syn = smoke.write_driving_sequence(opt, kp_dir, B)
    fwd = make_forward_fn(opt, td.build_renderer(opt, dev))
    _, joints = td.load_driving_joints(opt)
    out = fwd(td.assets_to_device(opt, syn.texture_atlas(), syn.background(),
                                  dev),
              torch.from_numpy(joints[:B].astype(np.float32)).to(dev))
    # normal tensors, out of inference mode
    rt = tuple(out[k].clone() for k in ("texture", "uv", "probs"))
    torch.save(rt, cache)
    return rt


def coherent_inputs(torch, dev, B=8, P=24, S=512, T=64, seed=3):
    """(tex, uv, probs) whose part maps are coherent (the logits constant
    over 16 x 16-pixel blocks, plus a little noise: neighbouring pixels
    select the same parts) and whose uv is smooth (per part an affine map
    of the pixel position, wrapped into [0, 1))."""
    g = torch.Generator(device=dev).manual_seed(seed)
    blocks = torch.randn((B, P + 1, S // 16, S // 16), generator=g,
                         device=dev) * 3
    logits = blocks.repeat_interleave(16, 2).repeat_interleave(16, 3)
    probs = torch.softmax(logits + 0.1 * torch.randn(
        (B, P + 1, S, S), generator=g, device=dev), dim=1)
    ys = torch.linspace(0, 1, S, device=dev)[:, None].expand(S, S)
    xs = torch.linspace(0, 1, S, device=dev)[None, :].expand(S, S)
    a = torch.rand((B, P, 1, 1), generator=g, device=dev)
    scale = 0.3 + 0.5 * torch.rand((B, P, 1, 1), generator=g, device=dev)
    uv = torch.stack([(a + scale * xs) % 1.0, (1 - a + scale * ys) % 1.0],
                     dim=2).contiguous()
    tex = torch.rand((B, P, 3, T, T), generator=g, device=dev) * 2 - 1
    return tex, uv, probs


def forward_times(torch, smoke, tk, ttw, tex8, uv8, probs8):
    """{name: device ms} of the forward's routes on these batch-8 inputs,
    and the shape of their selection (chip_smoke.selection_shape)."""
    K, EPS = 4, 1e-3
    fused = hasattr(tk, "texture_warp_topk_fwd")
    out = {}
    for B in (2, 8):
        tex, uv, probs = tex8[:B], uv8[:B], probs8[:B]
        fg, u, v = smoke.planes(uv, probs)
        w = tk.topk_select(fg, K, 0, EPS)
        if B == 8:
            out["selection"] = smoke.selection_shape(w)
        out[f"fwd_w_given_B{B}_ms"] = smoke.graph_ms(
            torch, lambda: tk.texture_warp_fwd(tex, u, v, w))
        if B == 2:
            if fused:
                def train_fwd():
                    return tk.texture_warp_topk_fwd(tex, fg, u, v, K, EPS,
                                                    return_w=True)
            else:
                def train_fwd():
                    return tk.texture_warp_fwd(tex, u, v,
                                               tk.topk_select(fg, K, 0, EPS))
            out["train_fwd_B2_ms"] = smoke.graph_ms(torch, train_fwd)

    def serve():
        with torch.inference_mode():
            return ttw.texture_warp_planes(tex8, uv8, probs8, k=K, eps=EPS)

    out["serving_B8_ms"] = smoke.graph_ms(torch, serve)
    return out


def wall_ms(torch, fn, warmups, iters):
    """The host-clock ms of ``iters`` calls of fn, each ended by a
    synchronise, after ``warmups`` calls."""
    import time
    for _ in range(warmups):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def graphed_update_err(torch, st, step, batch, decay=0.0):
    """One graphed step of ``st`` (a stage-2 TrainState, or a
    PretrainState of one net), then its update redone eagerly: the
    pre-step parameters, Adam moments and counts and the EMA put back, the
    optimizers' eager update (ScheduledAdam.update, G's with the EMA of
    ``decay`` for a stage-2 state that has one) run on the gradients the
    graph left in .grad, and the result held against the graph's. Returns
    (the step's metrics, the largest absolute difference); the state is
    left as the graph left it. The gradients of two runs differ
    (texture_warp_bwd's float atomics), so this is how the captured update
    is held to the eager one exactly. The redo launches the Adam kernel
    too, once an optimizer: a caller that counts the step's launches takes
    the counters' change around ``step``."""
    from neural_human_video_rendering_tpu_torch.parallel.mesh import \
        optimizer_tensors
    from neural_human_video_rendering_tpu_torch.train.steps import ema_decay
    stage2 = hasattr(st, "g_opt")
    opts = (st.g_opt, st.d_opt) if stage2 else (st.optimizer,)
    ema = stage2 and st.g_ema is not None

    def tensors():
        return ([p for o in opts for grp in o.param_groups
                 for p in grp["params"]]
                + [t for o in opts for t in optimizer_tensors(o)]
                + (list(st.g_ema.values()) if ema else []))

    before = tensors()
    saved = [t.detach().clone() for t in before]
    t_before = torch.tensor(st.step, dtype=torch.int64, device=st.device)
    metrics = step(st, batch)
    after = tensors()
    got = [t.detach().clone() for t in after]
    with torch.no_grad():
        known = {id(t) for t in before}
        for t, s in zip(before, saved):
            t.copy_(s)
        for t in after:
            if id(t) not in known:       # Adam's moments made at the capture
                t.zero_()
        for o in opts:                   # the update as the step ran it
            o.freeze_count -= 1
            o.update(([(p, st.g_ema[k]) for k, p in
                       st.renderer.named_parameters()],
                      ema_decay(t_before, decay))
                     if ema and o is st.g_opt else None)
            o.freeze_count += 1
        err = max(float((t - w).abs().max()) for t, w in zip(after, got))
        for t, w in zip(after, got):
            t.copy_(w)
    return metrics, err


def step_times(torch, smoke, tree):
    """{median_ms, q1_ms, q3_ms, min_ms, route, eager, phases_ms} of the
    fixed-batch stage-2 step of the checkout at tree (see the module's
    docstring): the step as make_train_step returns it (route: graphed or
    eager), then eager (``eager``: the same quartiles), then the eager
    phases."""
    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.data.wire import pack_batch
    from neural_human_video_rendering_tpu_torch.ops import build
    from neural_human_video_rendering_tpu_torch.train.state import \
        create_train_state
    from neural_human_video_rendering_tpu_torch.train.steps import \
        make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    opt = TrainOptions().parse(smoke.TRAIN + [
        "--checkpoints_dir", os.path.join(tree, "build", "step_ab"),
        "--name", "step_ab"], save=False)
    ds = dsm.SyntheticDataset(opt, length=4, seed=opt.seed)
    batch = pack_batch(dsm.collate([ds[0], ds[1]]))
    st = create_train_state(opt, ds.texture_atlas(), ds.background())
    step = make_train_step(opt, st.renderer, st.disc, st.vgg, st.g_opt,
                           st.d_opt)

    def timed(**kw):
        """Quartiles of 30 synchronised steps after 5 warm-ups (a capture
        in the first, where the route is a graph)."""
        s = sorted(wall_ms(torch, lambda: step(st, batch, **kw), 5, 30))
        return {"median_ms": s[15], "q1_ms": s[7], "q3_ms": s[22],
                "min_ms": s[0]}

    # the tree's own route (a graph where make_train_step captures one),
    # then the eager step (a mark that does nothing)
    out = timed()
    out["route"] = ("graphed" if getattr(step, "program", None) is not None
                    else "eager")
    out["eager"] = timed(mark=lambda name: None)
    phases = {}
    for _ in range(10):
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append((name, e))

        step(st, batch, mark)
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(events, events[1:]):
            phases.setdefault(name, []).append(a.elapsed_time(b))
    out["phases_ms"] = {k: sorted(v)[5] for k, v in phases.items()}
    return out


def pretrain_step_times(torch, smoke, tree, stage):
    """{median_ms, q1_ms, q3_ms, min_ms, route, eager} of a pretrain step
    (``stage`` uv or tex) of the checkout at tree, on one packed batch at
    chip_smoke phase 16's point (the module's docstring)."""
    import inspect

    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.ops import build
    from neural_human_video_rendering_tpu_torch.profile_step import \
        pretrain_case
    from neural_human_video_rendering_tpu_torch.train.state import (
        PretrainState, make_optimizer)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda", 0)
    opt = TrainOptions().parse(smoke.TRAIN + (
        smoke.PRE_UV if stage == "uv" else smoke.PRE_TEX) + [
        "--checkpoints_dir", os.path.join(tree, "build", "step_ab"),
        "--name", f"pretrain_{stage}_ab"], save=False)
    net, make, batches = pretrain_case(opt, stage, dev, 1)
    st = PretrainState(step=0, net=net, device=dev, optimizer=make_optimizer(
        opt, net.named_parameters(), 1))
    step = make(net, st.optimizer)

    def timed(**kw):
        s = sorted(wall_ms(torch, lambda: step(st, batches[0], **kw), 5, 30))
        return {"median_ms": s[15], "q1_ms": s[7], "q3_ms": s[22],
                "min_ms": s[0]}

    out = timed()
    out["route"] = ("graphed" if getattr(step, "program", None) is not None
                    else "eager")
    out["eager"] = (timed(mark=lambda name: None) if "mark" in
                    inspect.signature(step).parameters else None)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT, help="root of the checkout timed")
    ap.add_argument("--step", action="store_true",
                    help="time the flagship stage-2 step, not the kernels")
    ap.add_argument("--stage", default="e2e", choices=["e2e", "uv", "tex"],
                    help="with --step: the stage-2 step (e2e) or a pretrain "
                         "step")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    # the timed checkout's package, not this script's directory
    sys.path[0] = tree
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    from neural_human_video_rendering_tpu_torch.ops import flow_warp_kernel as fk
    from neural_human_video_rendering_tpu_torch.ops import texture_warp as ttw
    from neural_human_video_rendering_tpu_torch.ops import \
        texture_warp_kernel as tk
    if not fk.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {fk.__file__}, not from {tree}")
    out = {"tree": os.path.relpath(tree, ROOT)}
    if args.step:
        out.update(step_times(torch, smoke, tree) if args.stage == "e2e"
                   else pretrain_step_times(torch, smoke, tree, args.stage),
                   stage=args.stage, card=torch.cuda.get_device_name(0))
        print(json.dumps(out), flush=True)
        return 0
    dev = torch.device("cuda", 0)
    img, noise = smoke.flow_inputs(torch, 2, 512, 5, dev)
    flows = {"noise": noise, "smooth": smoke.smooth_flow(torch, noise)}
    for name, fl in flows.items():
        grid = smoke.flow_grid(torch, fl)
        out[f"flow_{name}_ms"] = smoke.graph_ms(
            torch, lambda: fk.flow_warp_fwd(img, fl))
        out[f"grid_sample_{name}_ms"] = smoke.graph_ms(
            torch, lambda: smoke.flow_library(torch, img, grid))
    tex, uv, probs = smoke.warp_inputs(torch, 2, 24, 512, 512, 64, 4, dev)
    fg, u, v = smoke.planes(uv, probs)
    w = tk.topk_select(fg, 4, 0, 1e-3)
    g = torch.randn((2, 3, fg.shape[2]), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(9))
    out["bwd_ms"] = smoke.graph_ms(
        torch, lambda: tk.texture_warp_bwd(tex, u, v, w, g))
    del tex, uv, probs, fg, u, v, w, g
    for name, inputs in (
            ("random", smoke.warp_inputs(torch, 8, 24, 512, 512, 64, 0, dev)),
            ("renderer", renderer_inputs(torch, smoke, dev)),
            ("coherent", coherent_inputs(torch, dev))):
        for key, val in forward_times(torch, smoke, tk, ttw, *inputs).items():
            out[f"{name}_{key}"] = val
        del inputs
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
