#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) if anything in it fails:
  1. device: the card's name and power limit (nvidia-smi), CUDA version,
     TF32 settings; build the CUDA kernels from csrc/ with nvcc.
  2. kernel vs plain version at the serving shapes (B=8, P=24, 512x512,
     T=64, k=4, eps=1e-3), k=P, block_parts=8, tile 128, bf16 texture.
     Top-k must match exactly; the forward within 2e-5 (float32).
  3. main path: 16 synthetic OpenPose JSONs through the port's
     run_inference at the flagship model's full width (bf16, batch 8,
     random weights from --seed): 16 finite PNG frames, and each kernel
     launched once per batch. Then kernel vs plain version on one batch's
     own texture / uv / probs, and a tiny float32 renderer on the card
     against the same weights on the CPU (all parts blended: a top-k
     selection among near-equal random-init probabilities would flip on
     float rounding and make the comparison meaningless).
  4. numbers: forward ms and FPS at batch 8, peak memory, each layer's
     time, a profiler trace of the forward (device busy share, top
     kernels), kernel / plain / library times from CUDA events, each
     kernel's memory bound.
The last lines are the kernels' JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}. Without a CUDA card, or without the
package beside this script, it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
FWD_TOL = 2e-5
REF_TOL = 1e-3

FLAGSHIP = (
    "--loadSize 512 --tex_tile 64 --n_parts 24 --ngf 64 "
    "--n_blocks_translate 9 --n_downsample_translate 4 --ngf_global 48 "
    "--n_blocks_global 10 --n_downsample_global 2 --n_blocks_bg 2 "
    "--n_downsample_bg 2 --stem_s2d 2 --head_s2d 2 --bg_s2d 4 "
    "--pad_mode same --upsample_mode deconv --dtype bfloat16 "
    "--pose_heatmaps --coord_conv --warp_topk 4 --warp_eps 1e-3 "
    "--warp_dtype float32 --infer_batch 8 --gpu_ids 0 --seed 0").split()
TINY = (
    "--loadSize 64 --tex_tile 16 --ngf 8 --ngf_global 8 "
    "--n_blocks_translate 1 --n_downsample_translate 2 --n_blocks_global 1 "
    "--n_downsample_global 1 --n_blocks_bg 1 --n_downsample_bg 1 "
    "--stem_s2d 2 --head_s2d 2 --bg_s2d 4 --pad_mode same --dtype float32 "
    "--pose_heatmaps --coord_conv --warp_topk 24 --warp_eps 0").split()

REPLACES = {
    "topk_select": "neural_human_video_rendering_tpu/ops/pallas_warp2.py:118",
    "texture_warp_fwd": "neural_human_video_rendering_tpu/ops/pallas_warp2.py:310",
}
SOURCE = "neural_human_video_rendering_tpu_torch/csrc/texture_warp.cu"


class Smoke:
    def __init__(self):
        self.failures = []

    def check(self, name, err, tol):
        ok = err <= tol
        print(f"{'PASS' if ok else 'FAIL'}  {name}: max_abs_err {err:.3e} "
              f"(tol {tol:.1e})", flush=True)
        if not ok:
            self.failures.append(name)
        return err

    def require(self, name, cond, detail=""):
        print(f"{'PASS' if cond else 'FAIL'}  {name} {detail}", flush=True)
        if not cond:
            self.failures.append(name)


def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def trace_forward(torch, fn, iters=3, top=10):
    """torch.profiler over `iters` calls of fn: device time per call, and
    the kernels and the aten ops (by the device time of the kernels each
    launched itself) with the most of it. The profiler's host-side cost
    stretches the window, so busy shares are taken against unprofiled
    times by the caller."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    on_device = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == on_device]
    ops = [e for e in events
           if e.device_type != on_device and e.self_device_time_total > 0]

    def ranked(evs, width):
        evs = sorted(evs, key=lambda e: e.self_device_time_total, reverse=True)
        return [[e.key[:width], e.self_device_time_total / 1e3 / iters]
                for e in evs[:top]]

    return {"device_busy_ms_per_call":
            sum(e.self_device_time_total for e in kernels) / 1e3 / iters,
            "top_ops_ms_per_call": ranked(ops, 60),
            "top_kernels_ms_per_call": ranked(kernels, 120)}


def warp_inputs(torch, B, P, H, W, T, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    logits = torch.randn((B, P + 1, H, W), generator=g, device=device) * 2.0
    probs = torch.softmax(logits, dim=1)
    uv = torch.rand((B, P, 2, H, W), generator=g, device=device)
    tex = torch.rand((B, P, 3, T, T), generator=g, device=device) * 2 - 1
    return tex, uv, probs


def planes(uv, probs):
    return (probs[:, 1:].flatten(2), uv[:, :, 0].flatten(2),
            uv[:, :, 1].flatten(2))


def compare_kernels(torch, tk, smoke, tag, tex, uv, probs, k, bp, eps):
    """Kernel vs plain version on the same inputs; returns the errors and
    the kernel's selection."""
    fg, u, v = planes(uv, probs)
    w_k = tk.topk_select(fg, k, bp, eps)
    w_p = tk.topk_select_plain(fg, k, bp, eps)
    out_k = tk.texture_warp_fwd(tex, u, v, w_k)
    out_p = tk.texture_warp_fwd_plain(tex, u, v, w_p)
    torch.cuda.synchronize()
    e_sel = smoke.check(f"topk_select {tag}",
                        float((w_k - w_p).abs().max()), 0.0)
    e_fwd = smoke.check(f"texture_warp_fwd {tag}",
                        float((out_k - out_p).abs().max()), FWD_TOL)
    return e_sel, e_fwd, w_k


def write_driving_sequence(opt, kp_dir, n):
    import numpy as np
    from neural_human_video_rendering_tpu_torch.data.dataset import \
        SyntheticDataset
    from neural_human_video_rendering_tpu_torch.data.keypoints import (
        BODY25_TO_COCO18, write_keypoint_json)
    syn = SyntheticDataset(opt, length=n, seed=opt.seed)
    os.makedirs(kp_dir, exist_ok=True)
    for f in os.listdir(kp_dir):
        os.remove(os.path.join(kp_dir, f))
    for i, j in enumerate(syn.joints):
        body = np.zeros((25, 3), np.float32)
        body[BODY25_TO_COCO18] = j
        write_keypoint_json(os.path.join(kp_dir, f"frame{i:05d}_keypoints.json"),
                            body)
    return syn


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        import numpy as np
        from neural_human_video_rendering_tpu_torch.config import TestOptions
        from neural_human_video_rendering_tpu_torch.infer import test_driver as td
        from neural_human_video_rendering_tpu_torch.models.renderer import (
            init_params, renderer_from_options)
        from neural_human_video_rendering_tpu_torch.ops import build
        from neural_human_video_rendering_tpu_torch.ops.texture_warp import \
            texture_warp_planes
        from neural_human_video_rendering_tpu_torch.ops import \
            texture_warp_kernel as tk
        from neural_human_video_rendering_tpu_torch.train.steps import (
            build_pose_input, make_forward_fn)
        from neural_human_video_rendering_tpu_torch.utils.image import read_png
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    smoke = Smoke()
    dev = torch.device("cuda", 0)

    # ---------------------------------------------------------- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
          f" | matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    logs = build.build_all(ptxas_verbose=True)
    print(f"[build] {time.perf_counter() - t0:.1f} s for {sorted(logs)}",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)

    # ------------------------------------------ 2. kernel vs plain version
    B, P, S, T, K, EPS = 8, 24, 512, 64, 4, 1e-3
    tex, uv, probs = warp_inputs(torch, B, P, S, S, T, 0, dev)
    errs = {}
    e_sel, e_fwd, w_main = compare_kernels(torch, tk, smoke, "main k=4",
                                           tex, uv, probs, K, 0, EPS)
    errs["topk_select"], errs["texture_warp_fwd"] = e_sel, e_fwd
    compare_kernels(torch, tk, smoke, "k=P", tex, uv, probs, P, 0, 0.0)
    compare_kernels(torch, tk, smoke, "block_parts=8", tex, uv, probs, K, 8, EPS)
    tex128, uv128, probs128 = warp_inputs(torch, 2, P, 256, 256, 128, 1, dev)
    compare_kernels(torch, tk, smoke, "tile 128", tex128, uv128, probs128,
                    K, 0, EPS)
    compare_kernels(torch, tk, smoke, "bf16 texture",
                    tex.bfloat16().float(), uv, probs, K, 0, EPS)
    del tex128, uv128, probs128

    # ---------------------------------------------------------- 3. main path
    work = os.path.join(repo, "build", "chip_smoke")
    kp_dir = os.path.join(work, "keypoints")
    res_dir = os.path.join(work, "results")
    opt = TestOptions().parse(FLAGSHIP + [
        "--pose_path", kp_dir, "--results_dir", res_dir,
        "--checkpoints_dir", os.path.join(work, "ckpt"), "--name", "smoke"],
        save=False)
    syn = write_driving_sequence(opt, kp_dir, 16)
    assets = (syn.texture_atlas(), syn.background())
    if os.path.isdir(os.path.join(res_dir, "images")):
        for f in os.listdir(os.path.join(res_dir, "images")):
            os.remove(os.path.join(res_dir, "images", f))
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    n = td.run_inference(opt, assets=assets)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = {"topk_select": tk.topk_select.launches,
                "texture_warp_fwd": tk.texture_warp_fwd.launches}
    batches = -(-16 // opt.infer_batch)
    print(f"[main] run_inference wrote {n} frames in {e2e_s:.2f} s; "
          f"launches {launches} for {batches} batches", flush=True)
    smoke.require("16 frames written", n == 16)
    frames = sorted(os.listdir(os.path.join(res_dir, "images")))
    smoke.require("16 PNGs on disk", len(frames) == 16)
    imgs = [read_png(os.path.join(res_dir, "images", f)) for f in frames]
    smoke.require("frames are SxS RGB and not flat",
                  all(i.shape == (S, S, 3) and i.std() > 1.0 for i in imgs))
    for name, count in launches.items():
        smoke.require(f"{name} launched once per batch", count == batches,
                      f"({count} launches, {batches} batches)")

    # one batch's own tensors: kernel vs plain version
    renderer = td.build_renderer(opt, dev)
    fwd = make_forward_fn(opt, renderer)
    state_assets = td.assets_to_device(opt, *assets, dev)
    names, joints = td.load_driving_joints(opt)
    jb = torch.from_numpy(joints[:8].astype(np.float32)).to(dev)
    out = fwd(state_assets, jb)
    smoke.require("renderer outputs finite", all(
        bool(torch.isfinite(t).all()) for t in out.values()))
    smoke.require("fake has shape (8, 3, S, S)",
                  tuple(out["fake"].shape) == (8, 3, S, S))
    _, _, w_real = compare_kernels(torch, tk, smoke, "renderer tensors",
                                   out["texture"], out["uv"], out["probs"],
                                   K, 0, EPS)
    sel_real = float((w_real > 0).sum(1).float().mean())
    print(f"[main] renderer batch: mean selected parts per pixel {sel_real:.3f}",
          flush=True)

    # the whole tiny renderer on the card vs the same weights on the CPU
    topt = TestOptions().parse(TINY + ["--gpu_ids", "0"], save=False)
    tiny = init_params(renderer_from_options(topt), 3)
    tsyn = write_driving_sequence(topt, os.path.join(work, "tiny_kp"), 4)
    tj = torch.from_numpy(tsyn.joints.astype(np.float32))
    tassets = (tsyn.texture_atlas(), tsyn.background())
    outs = {}
    for d in (torch.device("cpu"), dev):
        f = make_forward_fn(topt, tiny.to(d).eval())
        outs[d.type] = f(td.assets_to_device(topt, *tassets, d), tj.to(d))
    for key in ("fake", "fg", "mask"):
        smoke.check(f"tiny renderer {key} card vs cpu",
                    float((outs["cuda"][key].cpu() - outs["cpu"][key]).abs().max()),
                    REF_TOL)

    # ------------------------------------------------------------ 4. numbers
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        fwd(state_assets, jb)
    torch.cuda.synchronize()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        fwd(state_assets, jb)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3 / iters
    peak = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        pose = build_pose_input(opt, jb)
        logits, uv_r = renderer.TransG(pose)
        probs_r = torch.softmax(logits.float(), dim=1)
        tex_r = torch.clamp(state_assets[0][None] + renderer.TexG(pose), -1, 1)
        layer_ms = {
            "pose_input": cuda_ms(torch, lambda: build_pose_input(opt, jb), 10),
            "TransG": cuda_ms(torch, lambda: renderer.TransG(pose), 10),
            "TexG": cuda_ms(torch, lambda: renderer.TexG(pose), 10),
            "BGNet": cuda_ms(torch, lambda: renderer.BGNet(
                state_assets[1][None]), 10),
            "warp": cuda_ms(torch, lambda: texture_warp_planes(
                tex_r, uv_r, probs_r, **renderer.warp), 10),
        }
    print(json.dumps({"layers_ms": layer_ms, "card": smi}), flush=True)
    # profiled separately: the profiler's own cost stays out of the times above
    trace = trace_forward(torch, lambda: fwd(state_assets, jb))
    trace["device_busy_share_of_forward"] = \
        trace["device_busy_ms_per_call"] / fwd_ms
    print(json.dumps({"trace": trace, "card": smi}), flush=True)
    print(json.dumps({"forward": {
        "batch": 8, "ms_per_batch": fwd_ms, "fps": 8e3 / fwd_ms,
        "run_inference_16_frames_s": e2e_s, "peak_mem_bytes": peak,
        "dtype": opt.dtype, "card": smi}}), flush=True)

    fg, u, v = planes(uv, probs)
    F = torch.nn.functional
    nnz = int((w_main > 0).sum())
    N = S * S

    def topk_library():
        thr = torch.topk(fg, K, dim=1).values[:, -1:]
        w = torch.where(fg >= thr, fg, 0.0)
        return torch.where(w >= EPS, w, 0.0)

    grid = torch.stack([u * 2 - 1, v * 2 - 1], -1).reshape(B * P, S, S, 2)
    tex_bp = tex.reshape(B * P, 3, T, T)

    def fwd_library():
        samp = F.grid_sample(tex_bp, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)
        return (samp.view(B, P, 3, N) * w_main[:, :, None]).sum(1)

    def bound(nbytes, flops):
        t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
        return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")

    b_topk = bound(2 * B * P * N * 4, B * N * P * (2 * K + 2))
    b_fwd = bound(B * P * N * 4 + nnz * 8 + tex.numel() * 4 + B * 3 * N * 4,
                  nnz * 3 * 14)
    timing = {
        "topk_select": (lambda: tk.topk_select(fg, K, 0, EPS),
                        lambda: tk.topk_select_plain(fg, K, 0, EPS),
                        topk_library, b_topk),
        "texture_warp_fwd": (lambda: tk.texture_warp_fwd(tex, u, v, w_main),
                             lambda: tk.texture_warp_fwd_plain(tex, u, v, w_main),
                             fwd_library, b_fwd),
    }
    kernels = []
    for name, (kern, plain, lib, (b_ms, b_by)) in timing.items():
        ms = cuda_ms(torch, kern)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms,
            "plain_ms": cuda_ms(torch, plain, iters=5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(torch, lib, iters=10, warmup=2),
            "card": smi})
    print(f"[numbers] selected (pixel, part) pairs at k={K} eps={EPS}: {nnz} "
          f"of {B * P * N}", flush=True)
    if smoke.failures:
        print(f"chip_smoke FAILED: {smoke.failures}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
