#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) if anything in it fails:
  1. device: the card's name and power limit (nvidia-smi), CUDA version,
     TF32 settings; build the CUDA kernels from csrc/ with nvcc (one nvcc
     per source, all started together).
  2. kernel vs plain version at the serving shapes (B=8, P=24, 512x512,
     T=64, k=4, eps=1e-3), k=P, block_parts=8, tile 128 (256x256 at B=2,
     and phase 8's 512x512 at B=8 and B=2), bf16 texture.
     Top-k must match exactly; the forward with w given and the fused
     forward (both modes; not with block_parts) within 2e-5 (float32), the
     fused forward's kept w exactly. Then at the train step's shapes
     (B=2): the warp backward (k=4 eps=1e-3, k=P, tile 128 at 256x256 and
     at phase 8's 512x512, texture batch 1) within 1e-5 + 1e-5 * max|plain|
     (float atomics reorder dtex's sums); TextureWarp's three gradients
     with a bf16 texture against the float32 plain versions' within 3e-2
     of max|plain|; the flow warp (C=5,
     flow ~ 8 N(0,1) px, some of it leaving the image; a smooth flow, a
     strided channel view, and W=510) within 2e-5.
  3. main path: 16 synthetic OpenPose JSONs through the port's
     run_inference at the flagship model's full width (bf16, batch 8,
     random weights from --seed): 16 finite PNG frames, and the fused
     forward launched once per batch and no other kernel; one batch with
     --warp_block_parts 8 launches top-k and the forward with w given once
     each. Then the kernels vs their plain versions on one batch's own
     texture / uv / probs (the backward on its first 2 samples), and a
     tiny float32 renderer on the card against the same weights on the
     CPU (all parts blended: a top-k selection among near-equal
     random-init probabilities would flip on float rounding and make the
     comparison meaningless).
  4. numbers: forward ms and FPS at batch 8, peak memory, each layer's
     time, a profiler trace of the forward (device busy share, top
     kernels, the port's kernels), the serving kernels' numbers (the fused
     forward in its serving mode), the forward's device time on the
     renderer's tensors at batch 8 (fused, top-k then forward, w given),
     the backward's on them at batch 2.
  5. train path: the port's run_train at the flagship width (512px, batch
     2, the recipe's losses, random weights from --seed) for 3 warm-up and
     10 timed steps with --temporal_prev real: finite losses, G and D
     changed, the fused forward (keeping w), the backward and the flow
     warp launched once per step, top-k and the forward with w given
     never; one step with --temporal_prev fake launches the fused forward
     twice. Then a tiny float32 train step on the card against the CPU
     (all parts blended, SGD lr 1, TF32 off): losses and parameter deltas.
  6. train numbers: step ms (median) and steps/s, peak memory, the phases
     of a step (CUDA events), a profiler trace of one step (with the
     port's kernels' device time), and for each of the five kernels at
     the train step's shapes (the fused forward keeping w): its device
     time (20 calls captured in a CUDA graph, replayed between CUDA
     events), its host cost per call, the plain version's time, a library
     yardstick's device time, and its bound.
  7. pipeline: the flagship recipe end to end on a real-format corpus of
     20 frames at 512 px (keypoint JSONs; frames, masks, DensePose IUV as
     PNG; .npy flows; bg, atlas and part textures) under
     build/chip_smoke/pipeline/: stage 1 (batch 6, one epoch), the texture
     pretrain (one epoch), stage 2 (--load_pretrain_TransG, --data_ratio
     0.9, EMA, a mid-epoch 'latest' save, the epoch save), --continue_train
     for epoch 2, and 8 frames served from the run dir. Checks: stage 2's
     TransG at step 0 is stage 1's; the resume restored the step and both
     Adam counts; one fused forward, one backward and one flow warp a
     step, one fused launch per eval and per serving batch, none in the
     pretrain stages; finite held-out PSNR / SSIM; the served frames equal
     a forward of the loaded G_ema. Numbers: each stage's median step ms,
     steps/s and peak memory, the stage-2 step with FrameDataset and the
     loader against the same step on one packed batch, decode ms a sample
     and the decoder, checkpoint bytes, save and load seconds.
  8. the reference launchers: every script under launchers/ run through
     the port's entry points with its own flags (paths and epoch caps
     edited) on a
     corpus of 12 frames at 512 px in their layout (LaplaceProj as PNG and
     as 78-channel .npy, pre-rendered pose images, part and pose textures,
     the unfolded texture.jpg): pose retargeting, stage 1, the texture
     pretrain, stage 2 with LaplaceProj and the encoder E, encode_features,
     serving twice (stage 2's model with cluster codes and a video;
     test_infer.sh's flags at batch 8), a profiler window and
     --debug_nans (launchers_path has the details).
  9. measure: the port's benchmark and quality entry points. bench.main
     (--ckpt '': the random-init regime at the JAX bench's operating
     point, tile 128, bf16 warp texture) and bench_infer.main in process,
     their JSON lines and the launches per train step (the fused forward
     keeping w, the fused forward without w for the t-1 render, the
     backward, the flow warp) and per inference batch (the fused forward
     without w); the bilinear corpus oracle on the fused kernel (a 512 px
     frame of data/synthetic_video within 1e-5 of the warp of its own IUV);
     make_demo_data at 512 px (8 frames bilinear, 8 with --corrupt 0.5)
     read back through FrameDataset; quality_run at FULL_FLAGS cut in depth
     (8 frames, 1 pre-epoch, 2 epochs), its val curve, served frames,
     parity JSON and stage 2's launches; evaluate on the card (identical
     dirs, and renders against the GT against the CPU: PSNR 1e-3 dB, SSIM
     1e-5, flicker 1e-5 relative, VGG distance and LPIPS 3e-2 relative);
     (g) quality_profile on the quality run's held-out frames at
     FULL_FLAGS with the tile sweep 32/64/128: every variant and tile
     finite, the model-free all_gt_exact and the sweep through the fused
     kernel against the plain warp on the card (1e-3 dB, 1e-4 SSIM), and
     quality_profile.launches_per_frame fused launches without w a frame.
 10. options: every model and training option of the JAX package at full
     width through the drivers' functions, 5 steps a stage on a corpus of
     6 frames: (a) r4's uv_uvr -> e2e_uvr (--uv_refine 3, the TransG
     handoff), (b) r5's uv_msuv -> e2e_msuv with --lambda_UVgrad 500, (c)
     the flagship with --temporal_prev fake --no_temporal_detach_prev
     --pool_size 50, flip and --resize_or_crop resize_and_crop at 576 ->
     512, (d) pix2pixHD's 1024 px setting (--netG local --ngf 32, the
     trunk frozen for its first epoch by --niter_fix_global 1), then
     serving at batch 8 at 1024^2. Checks: finite losses with the JAX
     package's keys; per stage-2 step the fused forward keeping w, the
     backward and the flow warp once each (at 2B in the symmetric step),
     per serving batch one fused forward; in (d) every global_trunk
     parameter bit-equal while frozen and moved after, the enhancers
     moved from the first step; the kernels against their plain versions
     at 1024^2 (B=8 and B=2), at 2B=4 with a texture per sample and the
     flow warp at 1024^2 (phase 2's tolerances); tiny float32 steps card
     vs CPU with --netG local and --uv_refine, with --ms_uv, --uv_refine
     and --lambda_UVgrad, and in the symmetric mode with the pool.
     Numbers: each run's median step, its device busy share (trace of the
     step on one packed batch), peak memory and launches; serving ms a
     batch of 8 at 1024^2; the symmetric step's flow-warp backward (the
     plain version's VJP, the only PyTorch backward on the path).
 11. serving: (a) the flagship (512 px, bf16, random init from --seed 0)
     exported by export_serving at batch 8 with uint8 frames and the
     weights sidecar: the graph holds one nhvr_torch.texture_warp_topk_fwd
     node and no plain warp, the program is smaller than its sidecar; the
     program served (a CUDA graph) by serve.serve in process (a
     thread): /healthz, a request of 8 and one of 1 each launching the
     fused forward once and nothing else, the PNGs within 1 uint8 level of the live
     make_forward_fn forward; then by `python -m ...serve --port 0` as a
     fresh process, whose frames equal the in-process ones bit for bit;
     the --warp_block_parts 8 program with its weights baked in launches
     top-k and the forward with w given once each; (e) bench_serve's
     ladder (concurrency 1 and 4, 12 requests each) on the same program in
     a server process: finite positive frames/s, the server's exit 0 on
     SIGINT, its fused launches (one a request, one a warm-up call).
     Numbers: export, load
     and warm-up seconds, program and sidecar bytes, the median of 10
     requests at N=8 and N=1, frames/s through HTTP against the live
     forward, a request's split (device forward, host copy, PNG encode,
     JSON). (b) the committed JAX run dir (testdata/jax_resume_tiny: a
     tiny model's weights and latest_state.msgpack) resumed on the card
     and on the CPU: epoch and step, the optimizer states equal; one step
     each: losses and gradients card vs CPU (the tiny steps' tolerances),
     and the parameter changes against the CPU's resumed Adam fed the
     card's gradients, every parameter within 1e-6 (Adam scales the
     gradients' rounding by lr (1 - beta1) / sqrt(v): the changes' own
     difference card vs CPU is printed).
     (c) a random pix2pixHD GlobalGenerator at the flagship TransG's
     width (64/4/9) through import_torch_checkpoint, run on the card in
     float32 against the torch original within 1e-4 of max|original|.
 12. parallel: data parallel over ranks (parallel/mesh.py, runtime.py),
     two ranks time-sharing cuda:0 through --gpu_ids 0,0 over gloo (NCCL
     refuses two ranks on one card): (a) the flagship widths in float32,
     SGD(1), one global batch of 2 on two ranks against the same two
     ranks as threads of this process, each at its own shapes, the ranks
     graphed and the threads eager (two threads cannot capture at once)
     (losses 1e-4 relative, the changes of G, D and the EMA within the
     parity tests' form at 1e-5, each rank's num_ooms 0 and its peak
     reserved printed), the ranks' parameters, Adam moments and EMA
     bit-equal after 2 Adam steps; (b) run_train with the flagship
     recipe, 3 steps on two ranks (loss keys, one metrics.jsonl writer,
     the checkpoints, each rank's launches), resumed on one rank; (c) the same under
     torchrun at world 1 over NCCL; (d) run_inference of 16 frames at
     batch 8 on two ranks against one (1 uint8 level, each rank's fused
     forwards, one HTML); (e) profile_step at the flagship. parallel_path
     has the details; its times are no scaling number.
 13. tools: (a) bench_trained_regime at the bench's operating point (512
     px, batch 2, tile 128, bf16), 4 windows of 15 steps: G_Prob lower in
     the last window than in the first, each step's launches the bench's
     (the fused forward keeping w and without w, the backward, the flow
     warp), the fused forward and the backward timed on the first and
     last windows' renderer tensors (CUDA graphs); (b) noisy_gt_ab at the
     reference sizing (512 px, tile 64) cut in depth (12 frames, 1
     pre-epoch, 1 epoch, 4 held-out frames at most), then noisyab_anatomy
     on its dir, while (c) arm_ab64 (64 px, --limb_coords, 1 + 1 epochs)
     runs beside it: finite summaries, IoUs in [0, 1], each arm's saved
     epoch equal to --epochs, every stage-2 run's launches from its log.
 14. native data: the native decode/prefetch runtime
     (data/native_loader.py, native/loader.cpp). (a) g++'s version,
     whether it finds png.h and jpeglib.h, and the loader's build (its
     library, or why it did not build: then the host decodes with OpenCV,
     as the JAX package does on such a host). (b) Where it built:
     decode_image against decode_image_plain in the three modes on a
     1024 px frame, mask and IUV PNG read at 512 and on a 1920x1080 JPEG
     (a non-integer ratio), within 1 ulp (labels exactly); NativeBatcher
     with 4 threads bit-equal to per-file decodes on every frame, mask
     and IUV file; a bad path counted as one error. (c) The flagship's
     stage-2 recipe through train's main on an 8-frame corpus at 1024 px
     with --bg_path on the JPEG, one epoch (4 steps at batch 2): every
     frame, mask, IUV and the background decoded by (a)'s route (counted
     in the port's dataset module), the reason printed exactly where the
     loader is unavailable, per step one fused forward keeping w, one
     backward and one flow warp. Numbers: decode ms of one stage-2 sample
     by each route the host has, the step, the loader's share of it.
 15. the compiled step: make_train_step and make_forward_fn capture CUDA
     graphs on the card (train/graphs.py, the counterpart of the JAX
     package's jax.jit), so phases 3-14 run the graphs and count their
     launches on the replays. At the flagship recipe (TRAIN with
     --pool_size 8, batch 2), each route from one start with cuDNN
     deterministic: (a1) one SGD(1) step in float32, the losses within
     1e-5 relative and the changes (the gradients) of G, D and the EMA in
     phase 12's form; (a2) 5 Adam steps: step 1's losses within 1e-5,
     every graphed update (Adam, the EMA) equal to the eager update on
     the graph's own gradients, the pool's count and generator equal,
     the later losses printed beside a second eager run's (two runs part:
     texture_warp_bwd's float atomics, amplified by Adam); (a3) step 1's
     gradients of G and D as the recipe trains (bf16, VGG, the pool),
     graphed against eager in phase 12's form at bf16's unit roundoff,
     on 2 seeds' states and batches, beside a second eager run's (the
     floor); (b) 3 steps' launches each route, equal and the main
     path's; (e) a batch of 1 captures a second graph, and each capture's
     warm-up launched the step's kernels 3 times (kept out of the
     counters, printed). (c) Both routes at the
     recipe and at the bench's operating point, in this process: wall ms
     a step (median of 10), device ms (profiler, CUDA events), the busy
     share, peak memory, capture seconds. (d) The graphed forward at
     batch 8 bit-equal to the eager forward, frames/s both ways, one
     fused launch a batch; (f) no capture caught an out-of-memory error
     (compiled_path has the details).
 16. the compiled pretrains and server: make_pretrain_uv_step,
     make_pretrain_tex_step and serve._Model capture CUDA graphs on the
     card, so phases 7-13 run them. (a) Stage 1 at
     launchers/pretrain_trans.sh's point (512 px, batch 6, the flagship's
     TransG, bf16) and (b) the texture pretrain at
     launchers/pretrain_tex.sh's (200 px, batch 2, TexG 64/2/5, the
     LaplaceProj input, the texel mask), each route from one start with
     cuDNN deterministic: one SGD(1) step in float32 (the losses within
     1e-5 relative, the change in phase 12's form), then 3 Adam steps
     (step 1's losses within 1e-5, every graphed update equal to the eager
     update on its own gradients, the counts equal, one capture, no
     kernel); (c) both routes timed in this process (step_times). (d)
     Phase 11's two programs at batch 8 served by serve._Model graphed:
     a request of 8 and of 1 bit-equal to the module's eager call, both
     replaying the one capture, the fused forward once a request (top-k
     and the forward with w given on the --warp_block_parts 8 program),
     forward_s both ways. (e) No capture caught an out-of-memory error
     (compiled_pretrain_path has the details).
 17. the refusal of a caught out-of-memory error (train/graphs.py): a
     float32 conv closure whose first cuDNN plan asks 9.20 GB of
     workspace, at a shape no earlier phase runs, taken as a Program on
     cuda:0 while a blocking tensor leaves 256 MB beyond its input and
     output: graphs.CaughtOutOfMemory, naming the conv's line with a count
     above 0, and nothing stored; the blocker freed, the same closure at
     batch N + 1 captures with num_ooms 0 and replays bit-equal to its
     eager call. Numbers: the check's seconds, the host cost of one
     refuse_caught_ooms region (the eager step's check a call).
The last lines are the script's total and each phase's wall seconds,
the kernels' JSON, the nvidia-smi line, and {"ok": true, "device":
{...}}. Without a CUDA card, or without the package beside this script,
it exits non-zero and prints no result.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time

T0 = time.perf_counter()        # the script's start: its total wall time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
FWD_TOL = 2e-5
REF_TOL = 1e-3
# warp backward: float atomics add dtex in a run-dependent order
BWD_ATOL, BWD_RTOL = 1e-5, 1e-5
FLOW_TOL = 2e-5
BF16_GRAD_RTOL = 3e-2      # bf16 texture: relative to max|float32 gradient|
# tiny train step card vs CPU: per tensor, of the SGD(1) parameter deltas
STEP_SCALE_TOL, STEP_TENSOR_TOL, STEP_LOSS_RTOL = 1e-4, 1e-3, 1e-4
TRAIN_WARMUP, TRAIN_TIMED = 3, 10

FLAGSHIP = (
    "--loadSize 512 --tex_tile 64 --n_parts 24 --ngf 64 "
    "--n_blocks_translate 9 --n_downsample_translate 4 --ngf_global 48 "
    "--n_blocks_global 10 --n_downsample_global 2 --n_blocks_bg 2 "
    "--n_downsample_bg 2 --stem_s2d 2 --head_s2d 2 --bg_s2d 4 "
    "--pad_mode same --upsample_mode deconv --dtype bfloat16 "
    "--pose_heatmaps --coord_conv --warp_topk 4 --warp_eps 1e-3 "
    "--warp_dtype float32 --infer_batch 8 --gpu_ids 0 --seed 0").split()
# the flagship's training recipe (checkpoints/flagship/recipe.json) at
# batch 2, with random weights (no --load_pretrain_TransG)
TRAIN = FLAGSHIP + (
    "--batchSize 2 --num_D 2 --n_layers_D 3 --ndf 64 --lambda_feat 10 "
    "--lambda_L2 500 --lambda_UV 1000 --lambda_Prob 10 --use_densepose_loss "
    "--lambda_Mask 1.0 --lambda_Temp 500 --temporal_prev real "
    "--ema_decay 0.999 --pool_size 0 --no_flip --lr 2e-4 --beta1 0.5 "
    "--niter 30 --niter_decay 10 --print_freq 1").split()
TINY = (
    "--loadSize 64 --tex_tile 16 --ngf 8 --ngf_global 8 "
    "--n_blocks_translate 1 --n_downsample_translate 2 --n_blocks_global 1 "
    "--n_downsample_global 1 --n_blocks_bg 1 --n_downsample_bg 1 "
    "--stem_s2d 2 --head_s2d 2 --bg_s2d 4 --pad_mode same --dtype float32 "
    "--pose_heatmaps --coord_conv --warp_topk 24 --warp_eps 0").split()

TINY_TRAIN = TINY + (
    "--ndf 8 --n_layers_D 2 --batchSize 2 --no_flip "
    "--lambda_L2 500 --lambda_UV 1000 --lambda_Prob 10 --use_densepose_loss "
    "--lambda_Temp 500 --temporal_prev real --ema_decay 0.999 "
    "--no_vgg_loss").split()

REPLACES = {
    "topk_select": "neural_human_video_rendering_tpu/ops/pallas_warp2.py:118",
    "texture_warp_fwd": "neural_human_video_rendering_tpu/ops/pallas_warp2.py:310",
    # the selection (:118) and the forward (:310) in one launch
    "texture_warp_topk_fwd": "neural_human_video_rendering_tpu/ops/pallas_warp2.py:310",
    "texture_warp_bwd": "neural_human_video_rendering_tpu/ops/pallas_warp2.py:358",
    "flow_warp_fwd": "neural_human_video_rendering_tpu/ops/pallas_flow_warp.py:51",
}
SOURCE = {
    "topk_select": "neural_human_video_rendering_tpu_torch/csrc/texture_warp.cu",
    "texture_warp_fwd": "neural_human_video_rendering_tpu_torch/csrc/texture_warp.cu",
    "texture_warp_topk_fwd": "neural_human_video_rendering_tpu_torch/csrc/texture_warp.cu",
    "texture_warp_bwd": "neural_human_video_rendering_tpu_torch/csrc/texture_warp.cu",
    "flow_warp_fwd": "neural_human_video_rendering_tpu_torch/csrc/flow_warp.cu",
}


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
    """ms per call from CUDA events around `iters` eager calls: the host's
    cost per call is in it wherever it is close to the device's."""
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


def graph_ms(torch, fn, iters=20, warmup=3, reps=5):
    """Device ms of one call of fn, every launch it makes included: `iters`
    calls captured in one CUDA graph after warm-up, the graph replayed
    between two CUDA events (median of `reps` replays) / iters. The
    wrappers launch on the current stream, which is the capturing one."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    torch.cuda.empty_cache()
    return sorted(times)[reps // 2]


def host_us(torch, fn, iters=200):
    """Host microseconds per call of fn: the host clock over `iters` calls
    with no synchronise between them (the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


# device kernels by name: the forward's modes share texture_warp_fwd_kernel
# and the texel-major copy texel_major_kernel
PORT_KERNELS = {"topk_select": ("topk_",),
                "texture_warp_fwd and texture_warp_topk_fwd": (
                    "texture_warp_fwd", "texel_major"),
                "texture_warp_bwd": ("texture_warp_bwd",),
                "flow_warp_fwd": ("flow_warp_fwd",)}


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

    port = {name: sum(e.self_device_time_total for e in kernels
                      if any(key in e.key for key in keys)) / 1e3 / iters
            for name, keys in PORT_KERNELS.items()}
    return {"device_busy_ms_per_call":
            sum(e.self_device_time_total for e in kernels) / 1e3 / iters,
            "port_kernels_ms_per_call": port,
            "port_kernels_ms_total": sum(port.values()),
            "top_ops_ms_per_call": ranked(ops, 60),
            "top_kernels_ms_per_call": ranked(kernels, 120)}


# launches per train step on the main path (the rest: none)
TRAIN_LAUNCHES_PER_STEP = {"topk_select": 0, "texture_warp_fwd": 0,
                           "texture_warp_topk_fwd": 1,
                           "texture_warp_bwd": 1, "flow_warp_fwd": 1}


def launch_counts():
    """Every kernel wrapper's launch count, by REPLACES' names."""
    from neural_human_video_rendering_tpu_torch.train.drivers import \
        kernel_launches
    return kernel_launches()


def fused_modes():
    """The fused forward's launches by mode (keeping w for a backward, or
    not): its wrapper's counters, which a CUDA graph's replays advance."""
    from neural_human_video_rendering_tpu_torch.ops import \
        texture_warp_kernel as tk
    f = tk.texture_warp_topk_fwd
    return {"keep_w": f.launches_keep_w,
            "no_w": f.launches - f.launches_keep_w}


def warp_inputs(torch, B, P, H, W, T, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    logits = torch.randn((B, P + 1, H, W), generator=g, device=device) * 2.0
    probs = torch.softmax(logits, dim=1)
    uv = torch.rand((B, P, 2, H, W), generator=g, device=device)
    tex = torch.rand((B, P, 3, T, T), generator=g, device=device) * 2 - 1
    return tex, uv, probs


def selection_shape(w):
    """How coherent a selection w (B, P, N) is: selected parts a pixel,
    the share of 32-byte sectors (8 pixels) of the u / v planes that hold
    a selected pixel, and the parts that a warp's 32 pixels select."""
    B, P, N = w.shape
    sel = w > 0
    return {"parts_per_pixel": float(sel.sum(1).float().mean()),
            "uv_sectors_read": float(
                sel.view(B, P, N // 8, 8).any(3).float().mean()),
            "parts_per_warp": float(
                sel.view(B, P, N // 32, 32).any(3).float().sum(1).mean())}


def planes(uv, probs):
    return (probs[:, 1:].flatten(2), uv[:, :, 0].flatten(2),
            uv[:, :, 1].flatten(2))


def compare_kernels(torch, tk, smoke, tag, tex, uv, probs, k, bp, eps):
    """Kernels vs plain versions on the same inputs: top-k, the forward
    with w given and, without the block_parts cap, the fused forward in
    both modes (its kept w exactly). Returns the errors {name: err} and
    topk_select's selection."""
    fg, u, v = planes(uv, probs)
    w_k = tk.topk_select(fg, k, bp, eps)
    w_p = tk.topk_select_plain(fg, k, bp, eps)
    out_k = tk.texture_warp_fwd(tex, u, v, w_k)
    out_p = tk.texture_warp_fwd_plain(tex, u, v, w_p)
    torch.cuda.synchronize()
    errs = {"topk_select": smoke.check(f"topk_select {tag}",
                                       float((w_k - w_p).abs().max()), 0.0),
            "texture_warp_fwd": smoke.check(
                f"texture_warp_fwd {tag}", float((out_k - out_p).abs().max()),
                FWD_TOL)}
    if bp == 0:
        out_f = tk.texture_warp_topk_fwd(tex, fg, u, v, k, eps)
        out_fk, w_fk = tk.texture_warp_topk_fwd(tex, fg, u, v, k, eps,
                                                return_w=True)
        torch.cuda.synchronize()
        errs["texture_warp_topk_fwd"] = max(
            smoke.check(f"texture_warp_topk_fwd {tag}",
                        float((out_f - out_p).abs().max()), FWD_TOL),
            smoke.check(f"texture_warp_topk_fwd {tag} keeping w",
                        float((out_fk - out_p).abs().max()), FWD_TOL))
        smoke.require(f"texture_warp_topk_fwd {tag}: kept w == topk_select's",
                      torch.equal(w_fk, w_k))
    return errs, w_k


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


def flow_inputs(torch, B, S, C, device, seed=5):
    """A 5-channel image (the t-1 frame and flow_inv) as the temporal loss
    builds it, and a flow of ~8 px, some of it leaving the image."""
    g = torch.Generator(device=device).manual_seed(seed)
    img = torch.rand((B, C, S, S), generator=g, device=device) * 2 - 1
    flow = torch.randn((B, 2, S, S), generator=g, device=device) * 8.0
    flow[:, :, :8] += 40.0                          # leaves the image
    return img, flow


def smooth_flow(torch, flow):
    """A smooth flow of flow's shape: a shift of a few pixels plus a slow
    swirl (up to ~6 px), leaving the image along one border."""
    B, _, H, W = flow.shape
    ys = torch.linspace(0, 6.2832, H, device=flow.device)[:, None]
    xs = torch.linspace(0, 6.2832, W, device=flow.device)[None, :]
    out = torch.empty_like(flow)
    out[:, 0] = 3.3 + 3.0 * torch.sin(ys) * torch.cos(xs)
    out[:, 1] = -2.7 + 3.0 * torch.cos(ys) * torch.sin(xs)
    return out


def flow_grid(torch, flow):
    """grid_sample's normalized grid (align_corners) for the points
    p + flow(p) of a (B, 2, H, W) flow."""
    H, W = flow.shape[2:]
    xs = torch.arange(W, device=flow.device)
    ys = torch.arange(H, device=flow.device)[:, None]
    return torch.stack([(flow[:, 0] + xs) * (2.0 / (W - 1)) - 1,
                        (flow[:, 1] + ys) * (2.0 / (H - 1)) - 1], -1)


def flow_library(torch, img, grid):
    """The flow warp's yardstick: grid_sample with zeros padding, which
    zeroes each outside TAP, not the whole sample: a time yardstick only,
    never called by the port."""
    return torch.nn.functional.grid_sample(img, grid, mode="bilinear",
                                           padding_mode="zeros",
                                           align_corners=True)


def compare_bwd(torch, tk, smoke, tag, tex, uv, probs, k, eps, seed=0):
    """texture_warp_bwd vs its plain version on the same inputs; returns
    the largest error over duv, dprobs and dtex."""
    fg, u, v = planes(uv, probs)
    w = tk.topk_select(fg, k, 0, eps)
    B, C, N = uv.shape[0], tex.shape[2], fg.shape[2]
    gen = torch.Generator(device=uv.device).manual_seed(seed)
    g = torch.randn((B, C, N), generator=gen, device=uv.device)
    got = tk.texture_warp_bwd(tex, u, v, w, g)
    want = tk.texture_warp_bwd_plain(tex, u, v, w, g)
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, b in zip(("duv", "dprobs", "dtex"), got, want):
        tol = BWD_ATOL + BWD_RTOL * float(b.abs().max())
        worst = max(worst, smoke.check(f"texture_warp_bwd {tag} {name}",
                                       float((a - b).abs().max()), tol))
    return worst


def bf16_grads(torch, tk, smoke, tex, uv, probs, k, eps):
    """TextureWarp's three gradients of sum(out^2) with compute_dtype
    bfloat16 (the kernels on a bf16-rounded texture) against the float32
    plain versions', relative to max|plain| (tools/tpu_selftest.py's bf16
    gradient check)."""
    from neural_human_video_rendering_tpu_torch.ops.texture_warp import \
        texture_warp_planes
    leaves = [t.clone().requires_grad_() for t in (tex, uv, probs)]
    out = texture_warp_planes(*leaves, k=k, eps=eps, compute_dtype="bfloat16")
    (out ** 2).sum().backward()
    fg, u, v = planes(uv, probs)
    w = tk.topk_select_plain(fg, k, 0, eps)
    ref = tk.texture_warp_fwd_plain(tex, u, v, w)
    want = tk.texture_warp_bwd_plain(tex, u, v, w, 2 * ref)
    torch.cuda.synchronize()
    for name, leaf, b in zip(("dtex", "duv", "dprobs"), leaves,
                             (want[2], want[0], want[1])):
        scale = float(b.abs().max()) + 1e-6
        smoke.check(f"TextureWarp bf16 {name} vs float32 plain (relative)",
                    float((leaf.grad - b.view(leaf.shape)).abs().max()) / scale,
                    BF16_GRAD_RTOL)


def bound(nbytes, flops):
    """(ms, what binds): the larger of the bytes at the card's memory rate
    and the float32 operations at its peak."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def kernel_numbers(torch, tk, fk, tex, uv, probs, w, K, EPS, names,
                   flow=None, keep_w=False):
    """{name: ms, host_us, plain_ms, bound_ms, bound_by, library_ms} at
    these inputs. ms and library_ms are device time (graph_ms); host_us the
    host's cost per call; plain_ms CUDA events around eager calls. The
    fused forward is timed in its keep mode where keep_w (the train
    step's), else in its serving mode."""
    F = torch.nn.functional
    B, P, C, T = tex.shape[0], tex.shape[1], tex.shape[2], tex.shape[3]
    S = uv.shape[3]
    N = S * S
    fg, u, v = planes(uv, probs)
    nnz = int((w > 0).sum())
    gen = torch.Generator(device=uv.device).manual_seed(9)
    g = torch.randn((B, C, N), generator=gen, device=uv.device)
    grid = torch.stack([u * 2 - 1, v * 2 - 1], -1).reshape(B * P, S, S, 2)
    tex_bp = tex.reshape(B * P, C, T, T)

    def topk_library():
        thr = torch.topk(fg, K, dim=1).values[:, -1:]
        sel = torch.where(fg >= thr, fg, 0.0)
        return torch.where(sel >= EPS, sel, 0.0)

    def fwd_library(ww=w):
        samp = F.grid_sample(tex_bp, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)
        return (samp.view(B, P, C, N) * ww[:, :, None]).sum(1)

    out = {}
    todo = {}
    # each operator's CUDA kernel called directly, without the dispatcher:
    # the wrappers' launch path before the kernels became torch operators
    direct = {
        "topk_select": lambda: tk._topk_select_cuda(fg, K, 0, EPS),
        "texture_warp_fwd": lambda: tk._texture_warp_fwd_cuda(tex, u, v, w),
        "texture_warp_topk_fwd": lambda: tk._texture_warp_topk_fwd_cuda(
            tex, fg, u, v, K, EPS, keep_w),
        "texture_warp_bwd": lambda: tk._texture_warp_bwd_cuda(tex, u, v, w, g),
        "flow_warp_fwd": lambda: fk._flow_warp_fwd_cuda(*flow)}
    if "topk_select" in names:
        todo["topk_select"] = (
            lambda: tk.topk_select(fg, K, 0, EPS),
            lambda: tk.topk_select_plain(fg, K, 0, EPS), topk_library,
            bound(2 * B * P * N * 4, B * N * P * (2 * K + 2)))
    if "texture_warp_fwd" in names:
        todo["texture_warp_fwd"] = (
            lambda: tk.texture_warp_fwd(tex, u, v, w),
            lambda: tk.texture_warp_fwd_plain(tex, u, v, w), fwd_library,
            bound(B * P * N * 4 + nnz * 8 + tex.numel() * 4 + B * C * N * 4,
                  nnz * C * 14))
    if "texture_warp_topk_fwd" in names:
        # fg read densely, u / v of the selected pairs, the atlas, out (and
        # w) written; the selection's and the blend's operations
        todo["texture_warp_topk_fwd"] = (
            lambda: tk.texture_warp_topk_fwd(tex, fg, u, v, K, EPS,
                                             return_w=keep_w),
            lambda: tk.texture_warp_fwd_plain(
                tex, u, v, tk.topk_select_plain(fg, K, 0, EPS)),
            lambda: fwd_library(topk_library()),
            bound(B * P * N * 4 * (2 if keep_w else 1) + nnz * 8
                  + tex.numel() * 4 + B * C * N * 4,
                  B * N * P * (2 * K + 2) + nnz * C * 14))
    if "texture_warp_bwd" in names:
        # yardstick: grid_sample's backward (bilinear, border, align_corners)
        # over the B*P tiles, given the cotangent the blend hands each tile
        g_samp = (g.view(B, 1, C, N) * w[:, :, None]).reshape(B * P, C, S, S)

        def bwd_library():
            return torch.ops.aten.grid_sampler_2d_backward(
                g_samp, tex_bp, grid, 0, 1, True, [True, True])

        todo["texture_warp_bwd"] = (
            lambda: tk.texture_warp_bwd(tex, u, v, w, g),
            lambda: tk.texture_warp_bwd_plain(tex, u, v, w, g), bwd_library,
            # w densely, u / v for the selected pairs, g, the texture; du,
            # dv, dw written densely, dtex once
            bound(B * P * N * 4 + nnz * 8 + B * C * N * 4 + 2 * tex.numel() * 4
                  + 3 * B * P * N * 4, nnz * C * 40))
    if "flow_warp_fwd" in names:
        img, fl = flow
        Cf = img.shape[1]
        fgrid = flow_grid(torch, fl)
        todo["flow_warp_fwd"] = (
            lambda: fk.flow_warp_fwd(img, fl),
            lambda: fk.flow_warp_fwd_plain(img, fl),
            lambda: flow_library(torch, img, fgrid),
            bound(B * 2 * N * 4 + 2 * B * Cf * N * 4, B * N * Cf * 10))
    for name, (kern, plain, lib, (b_ms, b_by)) in todo.items():
        out[name] = {"ms": graph_ms(torch, kern),
                     "host_us": host_us(torch, kern),
                     "host_us_direct": host_us(torch, direct[name]),
                     "plain_ms": cuda_ms(torch, plain, iters=5, warmup=1),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": graph_ms(torch, lib)}
    if "flow_warp_fwd" in names:
        # the train step's kind of flow: smooth (a rigid shift in the
        # synthetic data, optical flow in real video), not i.i.d. noise
        img, fl = flow
        sm = smooth_flow(torch, fl)
        sgrid = flow_grid(torch, sm)
        out["flow_warp_fwd"].update({
            "smooth_flow_ms": graph_ms(torch, lambda: fk.flow_warp_fwd(img, sm)),
            "smooth_flow_library_ms": graph_ms(
                torch, lambda: flow_library(torch, img, sgrid))})
    print(f"[numbers] B={B}: selected (pixel, part) pairs at k={K} "
          f"eps={EPS}: {nnz} of {B * P * N}; {json.dumps(out)}", flush=True)
    return out


def linear_atlas(np, P, T, seed=5):
    """(P, T, T, 3) atlas linear in the texel coordinates: bilinear
    sampling's gradient in uv is then the same in every texel cell, so a
    sample that float rounding moves across a texel edge does not change
    it (on a random atlas it jumps there)."""
    yy, xx = np.mgrid[0:T, 0:T].astype(np.float32) / (T - 1)
    coef = np.random.default_rng(seed).uniform(-0.4, 0.4, (P, 3, 2))
    return (coef[:, None, None, :, 0] * xx[None, :, :, None]
            + coef[:, None, None, :, 1] * yy[None, :, :, None]
            ).astype(np.float32)


def tiny_step_card_vs_cpu(torch, smoke, dev, work, extra=(), tag="tiny"):
    """One tiny float32 train step (all parts blended, SGD lr 1, TF32 off)
    on the CPU and on the card from the same weights: the losses and every
    parameter's change, which is its gradient (the warp's backward kernel
    on the card, its plain version on the CPU). ``extra``: more flags
    (phase 10's options)."""
    import numpy as np
    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.train.state import \
        create_train_state
    from neural_human_video_rendering_tpu_torch.train.steps import \
        make_train_step
    opt = TrainOptions().parse(TINY_TRAIN + list(extra) + [
        "--gpu_ids", "0", "--checkpoints_dir", os.path.join(work, "ckpt"),
        "--name", "tiny"], save=False)
    syn = dsm.SyntheticDataset(opt, length=4, seed=opt.seed)
    batch = dsm.collate([syn[i] for i in (1, 2)])
    atlas = linear_atlas(np, opt.n_parts, opt.tex_tile)
    states = {name: create_train_state(opt, atlas, syn.background(), device=d)
              for name, d in (("cpu", torch.device("cpu")), ("card", dev))}
    cpu, card = states["cpu"], states["card"]
    texg = cpu.renderer.TexG.backbone
    head = texg.head if opt.netG == "local" else getattr(texg, texg.order[-1])
    with torch.no_grad():      # TexG's head at 0: the texture stays linear
        head.Conv_0.weight.zero_()
    card.renderer.load_state_dict(cpu.renderer.state_dict())
    card.disc.load_state_dict(cpu.disc.state_dict())
    before = {"G": {k: v.clone() for k, v in cpu.renderer.state_dict().items()},
              "D": {k: v.clone() for k, v in cpu.disc.state_dict().items()}}
    metrics = {}
    for name, st in states.items():
        st.g_ema = {k: v.detach().clone()
                    for k, v in st.renderer.named_parameters()}
        step = make_train_step(
            opt, st.renderer, st.disc, None,
            torch.optim.SGD(st.renderer.parameters(), lr=1.0),
            torch.optim.SGD(st.disc.parameters(), lr=1.0))
        metrics[name] = {k: float(v) for k, v in step(st, batch).items()}
    worst = 0.0
    for k, ref in metrics["cpu"].items():
        rel = abs(metrics["card"][k] - ref) / max(abs(ref), 1e-12)
        worst = max(worst, rel)
    smoke.require(f"{tag} train step: the same losses on both",
                  sorted(metrics["cpu"]) == sorted(metrics["card"]),
                  str(sorted(metrics["cpu"])))
    smoke.check(f"{tag} train step losses card vs cpu (relative)", worst,
                STEP_LOSS_RTOL)
    for mod_tag, mods in (("G", (cpu.renderer, card.renderer)),
                          ("D", (cpu.disc, card.disc))):
        b = before[mod_tag]
        ref = {k: v - b[k] for k, v in mods[0].state_dict().items()}
        got = {k: v.cpu() - b[k] for k, v in mods[1].state_dict().items()}
        scale = max(float(d.abs().max()) for d in ref.values())
        ratio, err_scale = 0.0, 0.0
        for k, d in ref.items():
            err = float((got[k] - d).abs().max())
            tol = STEP_SCALE_TOL * scale + STEP_TENSOR_TOL * float(d.abs().max())
            ratio = max(ratio, err / tol)
            err_scale = max(err_scale, err / scale)
        print(f"[train] {tag} step {mod_tag} deltas card vs cpu: max err / "
              f"max|delta| {err_scale:.3e}, worst err / tol {ratio:.3f}",
              flush=True)
        smoke.check(f"{tag} train step {mod_tag} deltas card vs cpu "
                    "(err/tol)", ratio, 1.0)


def train_path(torch, smoke, tk, fk, repo, dev, smi):
    """Phases 5 and 6: run_train at the flagship width, the fake-prev mode,
    the tiny card-vs-CPU step, then the step's numbers."""
    import numpy as np
    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.data.wire import pack_batch
    from neural_human_video_rendering_tpu_torch.models.discriminator import \
        discriminator_from_options
    from neural_human_video_rendering_tpu_torch.models.renderer import (
        init_params, renderer_from_options)
    from neural_human_video_rendering_tpu_torch.train.drivers import run_train
    from neural_human_video_rendering_tpu_torch.train.steps import \
        make_train_step
    work = os.path.join(repo, "build", "chip_smoke")
    ckpt = ["--checkpoints_dir", os.path.join(work, "ckpt")]

    def counts():
        return launch_counts()

    def reset():
        tk.reset_launch_counts()
        fk.reset_launch_counts()

    # the main path: run_train, temporal_prev real
    opt = TrainOptions().parse(TRAIN + ckpt + ["--name", "train_real"])
    steps = TRAIN_WARMUP + TRAIN_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    state = run_train(opt, max_steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[train] run_train {state.step} steps in {wall:.2f} s (set-up "
          f"included); launches {launches}", flush=True)
    smoke.require(f"run_train took {steps} steps", state.step == steps)
    per_step = {k: v / max(state.step, 1) for k, v in launches.items()}
    smoke.require("train step: texture_warp_topk_fwd, texture_warp_bwd and "
                  "flow_warp_fwd once per step, topk_select and "
                  "texture_warp_fwd never",
                  launches == {k: v * state.step
                               for k, v in TRAIN_LAUNCHES_PER_STEP.items()},
                  f"({launches}, {state.step} steps)")
    finite = {k: float(v) for k, v in state.metrics.items()}
    print(f"[train] last step losses {json.dumps(finite)}", flush=True)
    smoke.require("train losses finite", len(finite) >= 9 and all(
        np.isfinite(v) for v in finite.values()))
    fresh = {"G": init_params(renderer_from_options(opt), opt.seed),
             "D": init_params(discriminator_from_options(opt), opt.seed + 1)}
    for tag, mod in (("G", state.renderer), ("D", state.disc)):
        moved = max(float((a.cpu() - b).abs().max()) for a, b in zip(
            mod.state_dict().values(), fresh[tag].state_dict().values()))
        smoke.require(f"{tag} parameters changed", moved > 0,
                      f"(max |change| {moved:.3e})")
    del fresh

    # the default temporal mode: t-1 rendered again, forward only
    opt_fake = TrainOptions().parse(TRAIN + ckpt + [
        "--name", "train_fake", "--temporal_prev", "fake"])
    reset()
    st_fake = run_train(opt_fake, max_steps=1)
    torch.cuda.synchronize()
    fake_counts = counts()
    print(f"[train] temporal_prev fake, 1 step: launches {fake_counts}",
          flush=True)
    smoke.require("temporal_prev fake: fused forward 2, bwd 1, flow 1",
                  fake_counts == {"topk_select": 0, "texture_warp_fwd": 0,
                                  "texture_warp_topk_fwd": 2,
                                  "texture_warp_bwd": 1, "flow_warp_fwd": 1},
                  str(fake_counts))
    smoke.require("temporal_prev fake losses finite", all(
        np.isfinite(float(v)) for v in st_fake.metrics.values()))
    del st_fake
    torch.cuda.empty_cache()

    tiny_step_card_vs_cpu(torch, smoke, dev, work)

    # ---- numbers: the step's time from the run, its phases, a trace
    timed = sorted(state.step_seconds[TRAIN_WARMUP:])
    step_ms = timed[len(timed) // 2] * 1e3
    ds = dsm.SyntheticDataset(opt, length=4, seed=opt.seed)
    batch = pack_batch(dsm.collate([ds[0], ds[1]]))
    step = make_train_step(opt, state.renderer, state.disc, state.vgg,
                           state.g_opt, state.d_opt)
    phases = {}
    for it in range(5):
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append((name, e))

        step(state, batch, mark)
        torch.cuda.synchronize()
        if it >= 2:
            for (_, a), (name, b) in zip(events, events[1:]):
                phases.setdefault(name, []).append(a.elapsed_time(b))
    phase_ms = {k: sorted(v)[len(v) // 2] for k, v in phases.items()}
    totals = sorted(sum(v[i] for v in phases.values())
                    for i in range(len(phases["update"])))
    fixed_ms = totals[len(totals) // 2]
    trace = trace_forward(torch, lambda: step(state, batch), iters=2)
    # the trace runs the fixed-batch step (no loader thread beside it)
    trace["device_busy_share_of_step"] = trace["device_busy_ms_per_call"] / fixed_ms
    print(json.dumps({"train_step": {
        "batch": opt.batchSize, "size": opt.train_size, "ms_median": step_ms,
        "steps_per_s": 1e3 / step_ms,
        "ms_timed_steps": [t * 1e3 for t in state.step_seconds[TRAIN_WARMUP:]],
        "run_train_wall_s": wall, "peak_mem_bytes": peak,
        # the same step on one pre-packed batch, no loader thread beside it
        "fixed_batch_ms_median": fixed_ms,
        "fixed_batch_steps_per_s": 1e3 / fixed_ms,
        "phases_ms": phase_ms, "dtype": opt.dtype, "card": smi}}), flush=True)
    print(json.dumps({"train_trace": trace, "card": smi}), flush=True)
    del state, step
    torch.cuda.empty_cache()
    return {"launches": launches, "per_step": per_step}


PIPE_FRAMES = 20
# stage 2 of the pipeline: 18 training frames (--data_ratio 0.9) at batch 2
PIPE_STEPS = 9
PIPE_LATEST = 5


def _atlas_png(path, atlas):
    """(24, T, T, 3) atlas in [-1, 1] -> the 4 x 6 tile grid as a PNG."""
    from neural_human_video_rendering_tpu_torch.utils.image import (encode_png,
                                                                    to_uint8)
    T = atlas.shape[1]
    grid = atlas.reshape(4, 6, T, T, 3).transpose(0, 2, 1, 3, 4)
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(grid.reshape(4 * T, 6 * T, 3))))


def write_corpus(opt, root, n=None):
    """A real-format corpus of n (PIPE_FRAMES) frames at 512 px from the
    port's SyntheticDataset, in the reference layout: keypoint JSONs;
    frames, masks and DensePose IUV as PNG; pairwise flow / flow_inv as
    .npy; bg.png, texture.png and per-frame part textures."""
    import numpy as np
    from neural_human_video_rendering_tpu_torch.data.dataset import \
        SyntheticDataset
    from neural_human_video_rendering_tpu_torch.data.densepose import \
        encode_iuv
    from neural_human_video_rendering_tpu_torch.data.keypoints import (
        BODY25_TO_COCO18, write_keypoint_json)
    from neural_human_video_rendering_tpu_torch.utils.image import (
        encode_png, save_image, to_uint8)
    n = n or PIPE_FRAMES
    shutil.rmtree(root, ignore_errors=True)
    syn = SyntheticDataset(opt, length=n, seed=opt.seed)
    d = {k: os.path.join(root, k) for k in
         ("openpose_json", "frames", "mask", "densepose", "flow", "flow_inv",
          "part_texture")}
    for p in d.values():
        os.makedirs(p)
    samples = [syn[i] for i in range(n)]
    for i, s in enumerate(samples):
        body = np.zeros((25, 3), np.float32)
        body[BODY25_TO_COCO18] = s["joints"]
        write_keypoint_json(os.path.join(d["openpose_json"],
                                         f"frame{i:05d}_keypoints.json"), body)
        save_image(os.path.join(d["frames"], f"frame{i:05d}.png"), s["image"])
        with open(os.path.join(d["mask"], f"frame{i:05d}.png"), "wb") as f:
            f.write(encode_png(to_uint8(s["mask"], assume_01=True)))
        with open(os.path.join(d["densepose"], f"frame{i:05d}.png"), "wb") as f:
            f.write(encode_png(encode_iuv(s["dp_parts"], s["dp_uv"])))
        if i + 1 < n:      # flow[j] maps frame j+1 back to frame j
            np.save(os.path.join(d["flow"], f"{i:05d}.npy"),
                    samples[i + 1]["flow"])
            np.save(os.path.join(d["flow_inv"], f"{i:05d}.npy"),
                    samples[i + 1]["flow_inv"])
        _atlas_png(os.path.join(d["part_texture"], f"frame{i:05d}.png"),
                   np.clip(syn.texture_atlas() + 0.05 * np.sin(0.3 * i), -1, 1))
    save_image(os.path.join(root, "bg.png"), syn.background())
    _atlas_png(os.path.join(root, "texture.png"), syn.texture_atlas())
    return d


DANCE = "dance"


def synthetic_laplace(torch, joints, size, channels):
    """(channels, size, size) float32 LaplaceProj stand-in in [-1, 1],
    computed from a frame's joints (profile_step.synthetic_laplace)."""
    from neural_human_video_rendering_tpu_torch.profile_step import \
        synthetic_laplace as laplace
    return laplace(joints, size, channels)


def write_launcher_corpus(root, n, size, tile=128):
    """What the five reference launchers read, from the port's
    SyntheticDataset, at `size` px with n frames, under root:
      {DANCE}/ for train_e2e.sh / test_infer.sh (ROOT=root): openpose_json
        (keypoint JSONs), {DANCE}/ (frames), mask, densepose (IUV), flow
        and flow_inv (.npy), LaplaceProj (3-channel PNG), bg.jpg and the
        unfolded texture.jpg (data/texture_unfold, timed);
      all/ for pretrain_trans.sh (DATA): keypoints, mask, densepose;
      seq/ for pretrain_tex.sh (SEQ): openpose_img (the skeleton rendered
        to PNG), LaplaceProj (78-channel float16 .npy, the --input_nc 81
        contract), part_texture and Laplace_texture
        (per-frame atlases at `tile`), texture.jpg;
      align/target, align/source for run_align_pose.sh (TGT, SRC): two
        persons' keypoints on the launcher's 1024 x 1024 canvas, the
        target the corpus's person;
      serve/{DANCE}/ for test_infer.sh at the aligned poses (ROOT): the
        target's 1024 px keypoints as openpose_json, bg.jpg, texture.jpg.
    Returns {name: path} and the unfold's seconds."""
    import cv2
    import numpy as np
    import torch
    from neural_human_video_rendering_tpu_torch.config import Options
    from neural_human_video_rendering_tpu_torch.data.dataset import \
        SyntheticDataset
    from neural_human_video_rendering_tpu_torch.data.densepose import \
        encode_iuv
    from neural_human_video_rendering_tpu_torch.data.keypoints import (
        BODY25_TO_COCO18, write_keypoint_json)
    from neural_human_video_rendering_tpu_torch.data.rasterize import \
        render_skeleton
    from neural_human_video_rendering_tpu_torch.data.texture_unfold import \
        unfold_texture
    from neural_human_video_rendering_tpu_torch.utils.image import (
        encode_png, save_image, to_uint8)
    shutil.rmtree(root, ignore_errors=True)
    opt = Options(loadSize=size, tex_tile=tile)
    syn = SyntheticDataset(opt, length=n, seed=0)
    other = SyntheticDataset(opt, length=n, seed=1)
    dance = os.path.join(root, DANCE)
    p = {k: os.path.join(dance, k) for k in (
        "openpose_json", DANCE, "mask", "densepose", "flow", "flow_inv",
        "LaplaceProj")}
    p.update({k: os.path.join(root, "seq", k) for k in (
        "openpose_img", "LaplaceProj78", "part_texture", "Laplace_texture")})
    p["LaplaceProj78"] = os.path.join(root, "seq", "LaplaceProj")
    p.update({"align_target": os.path.join(root, "align", "target"),
              "align_source": os.path.join(root, "align", "source")})
    for d in p.values():
        os.makedirs(d)

    def keypoints(path, joints):
        body = np.zeros((25, 3), np.float32)
        body[BODY25_TO_COCO18] = joints
        write_keypoint_json(path, body)

    def png(path, img01):
        with open(path, "wb") as f:
            f.write(encode_png(img01))

    scale = 1024.0 / size                 # run_align_pose.sh's canvas
    samples = [syn[i] for i in range(n)]
    for i, s in enumerate(samples):
        name = f"frame{i:05d}"
        keypoints(os.path.join(p["openpose_json"], f"{name}_keypoints.json"),
                  s["joints"])
        save_image(os.path.join(p[DANCE], f"{name}.png"), s["image"])
        png(os.path.join(p["mask"], f"{name}.png"),
            to_uint8(s["mask"], assume_01=True))
        png(os.path.join(p["densepose"], f"{name}.png"),
            encode_iuv(s["dp_parts"], s["dp_uv"]))
        if i + 1 < n:                # flow[j] maps frame j+1 back to frame j
            np.save(os.path.join(p["flow"], f"{i:05d}.npy"),
                    samples[i + 1]["flow"])
            np.save(os.path.join(p["flow_inv"], f"{i:05d}.npy"),
                    samples[i + 1]["flow_inv"])
        lap = synthetic_laplace(torch, s["joints"], size, 78)
        save_image(os.path.join(p["LaplaceProj"], f"{name}.png"),
                   lap[:3].transpose(1, 2, 0))
        np.save(os.path.join(p["LaplaceProj78"], f"{name}.npy"),
                torch.from_numpy(lap).permute(1, 2, 0).half().contiguous()
                .numpy())      # numpy's strided float16 cast is ~10x slower
        skel = render_skeleton(torch.from_numpy(s["joints"][None]), size, size)
        save_image(os.path.join(p["openpose_img"], f"{name}.png"),
                   skel[0].permute(1, 2, 0).numpy())
        wave = np.sin(0.3 * i + np.arange(3, dtype=np.float32))
        _atlas_png(os.path.join(p["part_texture"], f"{name}.png"),
                   np.clip(syn.texture_atlas() + 0.05 * wave, -1, 1))
        _atlas_png(os.path.join(p["Laplace_texture"], f"{name}.png"),
                   np.clip(syn.texture_atlas() - 0.05 * wave, -1, 1))
        tgt = s["joints"].copy()
        tgt[:, :2] *= scale
        keypoints(os.path.join(p["align_target"], f"{name}_keypoints.json"),
                  tgt)
        src = other.joints[i].copy()            # a smaller, shifted person
        src[:, :2] = src[:, :2] * scale * 0.8 + 60.0
        keypoints(os.path.join(p["align_source"], f"{name}_keypoints.json"),
                  src)
    p["bg.jpg"] = os.path.join(dance, "bg.jpg")
    cv2.imwrite(p["bg.jpg"], cv2.cvtColor(to_uint8(syn.background()),
                                          cv2.COLOR_RGB2BGR))
    p["texture.jpg"] = os.path.join(dance, "texture.jpg")
    t0 = time.perf_counter()
    unfold_texture(p[DANCE], p["densepose"], p["texture.jpg"], tile=tile)
    unfold_s = time.perf_counter() - t0
    shutil.copy(p["texture.jpg"], os.path.join(root, "seq", "texture.jpg"))
    for k, src in (("keypoints", "openpose_json"), ("mask", "mask"),
                   ("densepose", "densepose")):
        os.makedirs(os.path.join(root, "all"), exist_ok=True)
        os.symlink(p[src], os.path.join(root, "all", k))
    serve = os.path.join(root, "serve", DANCE)
    os.makedirs(serve)
    os.symlink(p["align_target"], os.path.join(serve, "openpose_json"))
    for f in ("bg.jpg", "texture.jpg"):
        os.symlink(p[f], os.path.join(serve, f))
    p.update({"root": root, "all": os.path.join(root, "all"),
              "seq": os.path.join(root, "seq"),
              "serve_root": os.path.join(root, "serve")})
    return p, unfold_s


def through_main(module, driver, argv):
    """Run an entry point's main(argv) (python -m <module> argv) and return
    the state its driver returned, for the checks and the numbers."""
    kept = {}
    run = getattr(module, driver)

    def keep(*args, **kw):
        kept["state"] = run(*args, **kw)
        return kept["state"]

    setattr(module, driver, keep)
    try:
        rc = module.main(argv)
    finally:
        setattr(module, driver, run)
    if rc != 0:
        raise RuntimeError(f"{module.__name__}.main exited {rc}")
    return kept["state"]


def pipeline_path(torch, smoke, tk, fk, repo, dev, smi):
    """Phase 7: the flagship recipe end to end on a real-format corpus, each
    stage through its entry point's main: stage 1 (batch 6, one
    epoch), the texture pretrain (one epoch), stage 2 with the TransG
    handoff, --data_ratio 0.9, EMA, a mid-epoch 'latest' save and the epoch
    save, then --continue_train for a second epoch, then serving 8 frames
    from the run dir's G_ema. Returns the stage-2 launches."""
    import numpy as np
    from neural_human_video_rendering_tpu_torch.config import (TestOptions,
                                                               TrainOptions)
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.data.wire import pack_batch
    from neural_human_video_rendering_tpu_torch.infer import test_driver as td
    from neural_human_video_rendering_tpu_torch import pre_train, pre_train_tex
    from neural_human_video_rendering_tpu_torch.train import __main__ as train
    from neural_human_video_rendering_tpu_torch.train import drivers
    from neural_human_video_rendering_tpu_torch.train.steps import (
        make_forward_fn, make_train_step)
    from neural_human_video_rendering_tpu_torch.utils import checkpoint as ckpt
    from neural_human_video_rendering_tpu_torch.utils.image import (
        decoder_name, read_png, to_uint8)
    work = os.path.join(repo, "build", "chip_smoke", "pipeline")
    corpus = os.path.join(work, "corpus")
    ck = os.path.join(work, "ckpt")
    base = TrainOptions().parse(TRAIN, save=False)
    t0 = time.perf_counter()
    d = write_corpus(base, corpus)
    corpus_s = time.perf_counter() - t0
    decoder = decoder_name()
    print(f"[pipeline] corpus of {PIPE_FRAMES} frames at 512 px written in "
          f"{corpus_s:.1f} s; decoder: {decoder}", flush=True)
    data = ["--pose_path", d["openpose_json"], "--mask_path", d["mask"],
            "--densepose_path", d["densepose"], "--data_ratio", "0.9",
            "--checkpoints_dir", ck, "--no_flip", "--print_freq", "1",
            "--display_freq", "10000"]
    assets = ["--bg_path", os.path.join(corpus, "bg.png"),
              "--texture_path", os.path.join(corpus, "texture.png")]
    stages = {}

    def counts():
        return launch_counts()

    def reset():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tk.reset_launch_counts()
        fk.reset_launch_counts()

    def record(name, st, t_wall, skip=0):
        torch.cuda.synchronize()
        times = sorted(st.step_seconds[skip:])
        med = times[len(times) // 2] * 1e3 if times else float("nan")
        stages[name] = {"steps": len(st.step_seconds), "ms_median": med,
                        "steps_per_s": 1e3 / med,
                        "ms_steps": [t * 1e3 for t in st.step_seconds],
                        "wall_s": t_wall,
                        "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        print(f"[pipeline] {name}: {json.dumps(stages[name])}", flush=True)

    # checkpoint I/O of the real path, timed where the driver calls it
    io_s = {"save": [], "resume": []}
    save_orig, resume_orig = drivers.save_checkpoint, drivers.resume_train

    def timed(kind, fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            io_s[kind].append(time.perf_counter() - t)
            return out
        return wrapper

    drivers.save_checkpoint = timed("save", save_orig)
    drivers.resume_train = timed("resume", resume_orig)
    none = {k: 0 for k in REPLACES}
    try:
        # ---- stage 1: TransG on DensePose pseudo-GT (pre_train.py)
        uv_argv = TRAIN + data + ["--name", "uv", "--batchSize", "6",
                                  "--niter", "1"]
        reset()
        t = time.perf_counter()
        st1 = through_main(pre_train, "run_pretrain_uv", uv_argv)
        record("stage1_uv", st1, time.perf_counter() - t)
        smoke.require("stage 1: 3 steps of batch 6, finite losses, no kernel",
                      st1.step == 3 and counts() == none and all(
                          np.isfinite(float(v)) for v in st1.metrics.values()),
                      f"({st1.step} steps, {counts()})")
        uv_saved = ckpt.load_net(os.path.join(ck, "uv"), "TransG")
        del st1

        # ---- texture pretrain (pre_train_tex.py)
        reset()
        t = time.perf_counter()
        st_t = through_main(pre_train_tex, "run_pretrain_tex", TRAIN + data
                            + assets + ["--name", "tex", "--niter", "1",
                                        "--part_texture_path",
                                        d["part_texture"]])
        record("texture_pretrain", st_t, time.perf_counter() - t)
        smoke.require("texture pretrain: 9 steps, finite loss, no kernel, "
                      "TexG saved",
                      st_t.step == 9 and counts() == none
                      and np.isfinite(float(st_t.metrics["Tex_L1"]))
                      and ckpt.find_net(os.path.join(ck, "tex"), "TexG", 1)
                      is not None, f"({st_t.step} steps, {counts()})")
        del st_t
        torch.cuda.empty_cache()

        # ---- stage 2 (train.py): the handoff, one epoch, then a resume
        s2 = (TRAIN + data + assets + [
            "--img_path", d["frames"], "--flow_path", d["flow"],
            "--flow_inv_path", d["flow_inv"], "--name", "e2e",
            "--load_pretrain_TransG", os.path.join(ck, "uv"),
            "--save_latest_freq", str(PIPE_LATEST), "--save_epoch_freq", "40",
            "--no_decay"])
        st0 = drivers.run_train(TrainOptions().parse(s2 + ["--niter", "1"]),
                                max_steps=0)
        same = all(torch.equal(v.cpu(), uv_saved[k])
                   for k, v in st0.renderer.TransG.state_dict().items())
        smoke.require("stage 2 at step 0: TransG equals stage 1's saved "
                      "TransG", same and st0.step == 0)
        del st0, uv_saved
        torch.cuda.empty_cache()
        reset()
        t = time.perf_counter()
        st2 = through_main(train, "run_train", s2 + ["--niter", "1"])
        record("stage2_epoch1", st2, time.perf_counter() - t)
        l1 = counts()
        run = os.path.join(ck, "e2e")
        smoke.require("stage 2 epoch 1: 9 steps; per step 1 fused forward, 1 "
                      "backward, 1 flow warp; 1 fused launch for the eval",
                      st2.step == PIPE_STEPS and l1 == {
                          **none, "texture_warp_topk_fwd": PIPE_STEPS + 1,
                          "texture_warp_bwd": PIPE_STEPS,
                          "flow_warp_fwd": PIPE_STEPS}, f"({l1})")
        del st2
        torch.cuda.empty_cache()
        reset()
        t = time.perf_counter()
        st2 = through_main(train, "run_train",
                           s2 + ["--niter", "2", "--continue_train"])
        opt_c = TrainOptions().parse(s2 + ["--niter", "2"], save=False)
        record("stage2_resumed_epoch2", st2, time.perf_counter() - t, skip=2)
        l2 = counts()
        smoke.require("stage 2 resumed at epoch 2 with the step and both Adam "
                      "counts restored (18 after 9 more steps)",
                      st2.start_epoch == 2 and st2.step == 2 * PIPE_STEPS
                      and st2.g_opt.count == st2.d_opt.count == 2 * PIPE_STEPS,
                      f"(start {st2.start_epoch}, step {st2.step}, counts "
                      f"{st2.g_opt.count} / {st2.d_opt.count})")
        smoke.require("stage 2 epoch 2: the same launches", l2 == l1, str(l2))
        with open(os.path.join(run, "metrics.jsonl")) as f:
            vals = [json.loads(ln) for ln in f if "val_PSNR" in ln]
        smoke.require("held-out PSNR / SSIM after both epochs, finite",
                      [v["epoch"] for v in vals] == [1, 2] and all(
                          np.isfinite([v["val_PSNR"], v["val_SSIM"]]).all()
                          for v in vals), json.dumps(vals))
        files = sorted(os.listdir(run))
        smoke.require("stage 2 files: epoch 1 and 2, latest, state",
                      {"1_net_G.pth", "2_net_G_ema.pth", "latest_net_D.pth",
                       "2_net_TransG.pth", "latest_state.pth"} <= set(files),
                      str(files))
        ckpt_bytes = {f: os.path.getsize(os.path.join(run, f)) for f in files
                      if f.startswith("2_") or f == "latest_state.pth"}

        # the loader's share: the same step on one pre-packed batch
        ds = dsm.FrameDataset(opt_c, "train")
        t = time.perf_counter()
        items = [ds[i] for i in range(6)]
        decode_ms = (time.perf_counter() - t) * 1e3 / 6
        batch = pack_batch(dsm.collate(items[:2]))
        step = make_train_step(opt_c, st2.renderer, st2.disc, st2.vgg,
                               st2.g_opt, st2.d_opt)
        fixed = []
        for _ in range(6):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(st2, batch)
            torch.cuda.synchronize()
            fixed.append(time.perf_counter() - t)
        fixed_ms = sorted(fixed[1:])[len(fixed[1:]) // 2] * 1e3
        loader_ms = stages["stage2_resumed_epoch2"]["ms_median"]
        del st2, step
        torch.cuda.empty_cache()

        # ---- serving from the run dir (G_ema at epoch 2)
        topt = TestOptions().parse(FLAGSHIP + assets + [
            "--pose_path", d["openpose_json"], "--results_dir",
            os.path.join(work, "results"), "--checkpoints_dir", ck,
            "--name", "e2e", "--which_epoch", "2"], save=False)
        reset()
        t = time.perf_counter()
        n = td.run_inference(topt, max_frames=8)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t
        ls = counts()
        smoke.require("serving from the checkpoint: 8 frames, 1 fused launch",
                      n == 8 and ls == {**none, "texture_warp_topk_fwd": 1},
                      str(ls))
        renderer = td.build_renderer(topt, dev)
        saved = ckpt.load_net(run, "G_ema", 2)
        smoke.require("serving loaded G_ema of epoch 2", all(
            torch.equal(v.cpu(), saved[k])
            for k, v in renderer.state_dict().items()))
        _, joints = td.load_driving_joints(topt)
        fake = make_forward_fn(topt, renderer)(
            td.assets_to_device(topt, *td.load_assets(topt), dev),
            torch.from_numpy(joints[:8]).to(dev))["fake"]
        worst, unequal = 0, 0
        for i in range(8):
            png = read_png(os.path.join(work, "results", "images",
                                        f"frame{i:05d}_synthesized.png"))
            want = to_uint8(fake[i].float().permute(1, 2, 0).cpu().numpy())
            diff = np.abs(png.astype(int) - want.astype(int))
            worst, unequal = max(worst, int(diff.max())), unequal + int(
                (diff > 0).sum())
        smoke.require("served frames == a forward of the loaded G_ema (uint8)",
                      worst == 0, f"(max diff {worst}, {unequal} values differ)")
        del renderer, fake
    finally:
        drivers.save_checkpoint, drivers.resume_train = save_orig, resume_orig
    print(json.dumps({"pipeline": {
        "stages": stages, "frames": PIPE_FRAMES, "size": 512,
        "stage2_loader_vs_fixed_batch": {
            "with_frame_dataset_and_loader_ms_median": loader_ms,
            "fixed_packed_batch_ms_median": fixed_ms,
            "loader_share": (loader_ms - fixed_ms) / loader_ms},
        "decode_ms_per_sample": decode_ms, "decoder": decoder,
        "corpus_write_s": corpus_s,
        "checkpoint_bytes": ckpt_bytes,
        "checkpoint_bytes_epoch_save": sum(ckpt_bytes.values()),
        "save_s": io_s["save"], "resume_load_s": io_s["resume"],
        "serving_8_frames_s": serve_s, "card": smi}}), flush=True)
    shutil.rmtree(ck, ignore_errors=True)         # ~10 GB of checkpoints
    return {"stage2_epoch": l1}


LAUNCH_FRAMES = 12


def launchers_path(torch, smoke, tk, fk, repo, dev, smi):
    """Phase 8: the reference launchers, each script's argv read from the
    script under launchers/ (launch.launcher_argv) and run through its
    entry point's main, with only paths and epoch caps edited (--tf_log
    writes TensorBoard events, or logs/scalars.jsonl where
    torch.utils.tensorboard does not import): run_align_pose.sh; pretrain_trans.sh for 2 epochs (train_e2e.sh loads
    its epoch 2; its 5 residual blocks go into stage 2's 9 partially);
    pretrain_tex.sh for one epoch (pose images, 78 LaplaceProj channels
    from .npy, --input_nc 81, 200 px); train_e2e.sh for one epoch
    (LaplaceProj, encoder E, --lambda_Temp 500 with the default
    --temporal_prev fake); encode_features on stage 2's run dir. Every
    stage runs at the launcher's own widths, at 512 px but for
    pretrain_tex.sh's --loadSize 200.

    Serving runs twice, because the launchers disagree on the pose input:
    train_e2e.sh has --use_laplace with --input_nc 3 and no
    --pose_plus_laplace (pose_nc 3: LaplaceProj only, plus E's 3 codes at
    TexG), test_infer.sh has --pose_plus_laplace (pose_nc 6), so
    test_infer.sh cannot load stage 2's weights. First stage 2's model
    flags (train_e2e.sh's argv) with the serving-only flags --which_epoch,
    --load_features, --cluster_idx and --save_video, from the stage-2 run
    dir; then test_infer.sh's exact flags (batch 8) on the poses
    run_align_pose.sh aligned, from a random init.

    Checks: each stage's finite losses, its launches (none in the pretrain
    stages; a stage-2 step 2 fused forwards, 1 backward and 1 flow warp,
    and 1 fused forward a held-out or serving batch), the video's frame
    count, the centers' shape, a profiler window (--profile_dir, 3 steps of
    stage 2) wrote a trace, --debug_nans raised on a batch with a NaN.
    Numbers: each stage's median step ms, steps/s and peak memory, E's
    forward ms inside the stage-2 step, the unfold's seconds, serving
    frames/s at batch 8 under test_infer.sh's flags. Returns stage 2's
    launches."""
    import numpy as np
    from neural_human_video_rendering_tpu_torch import (encode_features,
                                                        graph_posenorm,
                                                        pre_train,
                                                        pre_train_tex)
    from neural_human_video_rendering_tpu_torch.config import (TestOptions,
                                                               TrainOptions)
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.infer import test_driver as td
    from neural_human_video_rendering_tpu_torch.launch import launcher_argv
    from neural_human_video_rendering_tpu_torch.models import generators
    from neural_human_video_rendering_tpu_torch.train import __main__ as train
    from neural_human_video_rendering_tpu_torch.train import drivers, loop
    from neural_human_video_rendering_tpu_torch.train.steps import (
        make_forward_fn, make_train_step)
    t_phase = time.perf_counter()
    work = os.path.join(repo, "build", "chip_smoke", "launchers")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    p, unfold_s = write_launcher_corpus(os.path.join(work, "data"),
                                        LAUNCH_FRAMES, 512)
    corpus_s = time.perf_counter() - t0
    print(f"[launchers] corpus of {LAUNCH_FRAMES} frames at 512 px written in "
          f"{corpus_s:.1f} s; texture unfold (texture.jpg, tile 128) "
          f"{unfold_s:.3f} s | {smi}", flush=True)
    ck = os.path.join(work, "ckpt")
    env = {"TGT": p["align_target"], "SRC": p["align_source"],
           "OUT": os.path.join(work, "aligned"), "DATA": p["all"],
           "CKPTS": ck, "ROOT": p["root"]}
    none = {k: 0 for k in REPLACES}
    stages, launches = {}, {}

    def argv_of(script, args=(), e=None):
        _, argv = launcher_argv(os.path.join(repo, "launchers", script), args,
                                env if e is None else e)
        return argv

    def reset():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tk.reset_launch_counts()
        fk.reset_launch_counts()

    def record(name, st, t_wall):
        torch.cuda.synchronize()
        launches[name] = launch_counts()
        times = sorted(st.step_seconds)
        med = times[len(times) // 2] * 1e3
        stages[name] = {"steps": len(st.step_seconds), "ms_median": med,
                        "steps_per_s": 1e3 / med,
                        "ms_steps": [t * 1e3 for t in st.step_seconds],
                        "wall_s": t_wall, "launches": launches[name],
                        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                        "losses": {k: float(v) for k, v in st.metrics.items()}}
        print(f"[launchers] {name}: {json.dumps(stages[name])} | {smi}",
              flush=True)
        smoke.require(f"{name}: finite losses", all(
            np.isfinite(v) for v in stages[name]["losses"].values()))

    # ---- run_align_pose.sh
    t = time.perf_counter()
    smoke.require("run_align_pose.sh", graph_posenorm.main(
        argv_of("run_align_pose.sh")) == 0)
    align_s = time.perf_counter() - t
    aligned = [f for f in os.listdir(env["OUT"]) if f.endswith(".json")]
    smoke.require("run_align_pose.sh: aligned keypoints and align_meta.json",
                  len(aligned) == LAUNCH_FRAMES + 1, str(len(aligned)))

    # ---- pretrain_trans.sh (stage 1), 2 epochs
    reset()
    t = time.perf_counter()
    st = through_main(pre_train, "run_pretrain_uv",
                      argv_of("pretrain_trans.sh") + ["--niter", "2"])
    record("pretrain_trans", st, time.perf_counter() - t)
    n1 = LAUNCH_FRAMES // 6
    smoke.require(f"pretrain_trans.sh: 2 epochs of {n1} steps at batch 6, no "
                  "kernel, epoch 2 saved",
                  st.step == 2 * n1 and launches["pretrain_trans"] == none
                  and os.path.isfile(os.path.join(
                      ck, "uvGenerator_pretrain", "2_net_TransG.pth")),
                  f"({st.step} steps)")
    del st

    # ---- pretrain_tex.sh, one epoch (--checkpoints_dir: a path the
    # script leaves at ./checkpoints)
    reset()
    t = time.perf_counter()
    st = through_main(pre_train_tex, "run_pretrain_tex",
                      argv_of("pretrain_tex.sh", [p["seq"]])
                      + ["--niter", "1", "--checkpoints_dir", ck])
    record("pretrain_tex", st, time.perf_counter() - t)
    n_tex = int(round(LAUNCH_FRAMES * 0.9)) // 2
    smoke.require("pretrain_tex.sh: one epoch at 200 px with pose images and "
                  "78 LaplaceProj channels (pose_nc 81), no kernel",
                  st.step == n_tex and launches["pretrain_tex"] == none
                  and st.net.GlobalGenerator_0.ConvNormRelu_0.Conv_0.weight
                  .shape[1] == 81 * 4, f"({st.step} steps)")
    del st
    torch.cuda.empty_cache()

    # ---- train_e2e.sh (stage 2), one epoch, E's forwards timed
    e2e = argv_of("train_e2e.sh", [DANCE])
    cap = ["--niter", "1", "--niter_decay", "0"]
    feat_ev = []
    forward = generators.FeatEncoder.forward

    def timed_forward(self, img):
        # a capture launches nothing and its replays run no Python: the
        # graphed step's E is timed on the capture's eager warm-up calls
        if torch.cuda.is_current_stream_capturing():
            return forward(self, img)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = forward(self, img)
        b.record()
        feat_ev.append((torch.is_grad_enabled(), a, b))
        return out

    generators.FeatEncoder.forward = timed_forward
    reset()
    t = time.perf_counter()
    try:
        st = through_main(train, "run_train", e2e + cap)
    finally:
        generators.FeatEncoder.forward = forward
    record("train_e2e", st, time.perf_counter() - t)
    n2 = int(round(LAUNCH_FRAMES * 0.9)) // 2
    want = {**none, "texture_warp_topk_fwd": 2 * n2 + 1,
            "texture_warp_bwd": n2, "flow_warp_fwd": n2}
    smoke.require("train_e2e.sh: one epoch; a step 2 fused forwards (t, the "
                  "detached t-1), 1 backward, 1 flow warp; 1 fused forward "
                  "for the held-out batch",
                  st.step == n2 and launches["train_e2e"] == want,
                  f"({st.step} steps, {launches['train_e2e']})")
    run = os.path.join(ck, f"{DANCE}_18Feature_Temporal")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        vals = [json.loads(ln) for ln in f if "val_PSNR" in ln]
    smoke.require("train_e2e.sh: held-out PSNR / SSIM finite (E encodes the "
                  "held-out frame)", len(vals) == 1 and np.isfinite(
                      [vals[0]["val_PSNR"], vals[0]["val_SSIM"]]).all(),
                  json.dumps(vals))
    g = st.renderer
    smoke.require("train_e2e.sh: E in G and in G's Adam state; TexG takes "
                  "pose_nc 3 + 3 codes",
                  hasattr(g, "FeatE") and all(
                      p_ in st.g_opt.state for p_ in g.FeatE.parameters())
                  and g.TexG.GlobalGenerator_0.ConvNormRelu_0.Conv_0.weight
                  .shape[1] == 6 * 4)
    torch.cuda.synchronize()
    feat_ms = {"with_grad": [], "without_grad": []}
    for grad, a, b in feat_ev:
        feat_ms["with_grad" if grad else "without_grad"].append(
            a.elapsed_time(b))
    feat = {k: {"calls": len(v), "ms_median": sorted(v)[len(v) // 2]}
            for k, v in feat_ms.items() if v}
    feat["step_ms_median"] = stages["train_e2e"]["ms_median"]
    print(f"[launchers] E's forward inside stage 2 (batch 2, 512 px; "
          f"with_grad: frame t on the graph's warm-up calls, without_grad: "
          f"the detached t-1 render there and the held-out batch): "
          f"{json.dumps(feat)} | {smi}", flush=True)
    del st, g
    torch.cuda.empty_cache()

    # ---- encode_features on stage 2's run dir
    npz = os.path.join(work, "features.npz")
    t = time.perf_counter()
    smoke.require("encode_features", encode_features.main(
        e2e + ["--out", npz, "--which_epoch", "1"]) == 0)
    enc_s = time.perf_counter() - t
    centers = np.load(npz)["centers"]
    smoke.require("encode_features: centers (10, 25, 3), finite",
                  centers.shape == (10, 25, 3) and np.isfinite(centers).all(),
                  str(centers.shape))

    # ---- serving 1: stage 2's model with its codes and a video
    r1 = os.path.join(work, "serve_e2e")
    reset()
    t = time.perf_counter()
    n_s1 = through_main(td, "run_inference", e2e + [
        "--results_dir", r1, "--which_epoch", "1", "--load_features", npz,
        "--cluster_idx", "0", "--save_video"])
    serve1_s = time.perf_counter() - t
    l_s1 = launch_counts()
    videos = [f for f in os.listdir(r1) if f.startswith("video.")]
    import cv2
    cap_v = cv2.VideoCapture(os.path.join(r1, videos[0])) if videos else None
    n_video = 0
    while cap_v is not None and cap_v.read()[0]:
        n_video += 1
    batches = -(-LAUNCH_FRAMES // 8)
    smoke.require("serving stage 2 (codes, --save_video): all frames, the "
                  "video holds them, 1 fused forward a batch",
                  n_s1 == LAUNCH_FRAMES and n_video == n_s1 and l_s1 == {
                      **none, "texture_warp_topk_fwd": batches},
                  f"({n_s1} frames, {videos} of {n_video} frames, {l_s1})")

    # ---- serving 2: test_infer.sh's flags on the aligned poses, batch 8
    env2 = dict(env, ROOT=p["serve_root"], POSE=env["OUT"],
                CKPTS=os.path.join(work, "no_ckpt"),
                RESULTS=os.path.join(work, "results"))
    ti = argv_of("test_infer.sh", [DANCE], env2)
    reset()
    t = time.perf_counter()
    n_s2 = through_main(td, "run_inference", ti)
    serve2_s = time.perf_counter() - t
    l_s2 = launch_counts()
    smoke.require("test_infer.sh: all frames, 1 fused forward a batch",
                  n_s2 == LAUNCH_FRAMES and l_s2 == {
                      **none, "texture_warp_topk_fwd": batches},
                  f"({n_s2} frames, {l_s2})")
    topt = TestOptions().parse(ti, save=False)
    renderer = td.build_renderer(topt, dev)
    _, joints, _ = td.load_driving_poses(topt)
    fwd = make_forward_fn(topt, renderer)
    state_assets = td.assets_to_device(topt, *td.load_assets(topt), dev)
    jb = torch.from_numpy(joints[:8].astype(np.float32)).to(dev)
    out = fwd(state_assets, jb)
    smoke.require("test_infer.sh forward: finite (8, 3, 512, 512)",
                  tuple(out["fake"].shape) == (8, 3, 512, 512)
                  and bool(torch.isfinite(out["fake"]).all()))
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        fwd(state_assets, jb)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        fwd(state_assets, jb)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t) * 1e3 / 10
    serve_peak = torch.cuda.max_memory_allocated()
    del renderer, fwd, state_assets, jb
    torch.cuda.empty_cache()

    # ---- --profile_dir (3 steps of stage 2), then --debug_nans
    prof = os.path.join(work, "profile")
    opt_p = TrainOptions().parse(e2e + cap + [
        "--name", "e2e_profile", "--profile_dir", prof, "--profile_start",
        "1", "--profile_steps", "3"])
    t = time.perf_counter()
    st = drivers.run_train(opt_p, max_steps=4)
    torch.cuda.synchronize()
    prof_s = time.perf_counter() - t
    traces = sorted(os.listdir(prof)) if os.path.isdir(prof) else []
    trace_bytes = sum(os.path.getsize(os.path.join(prof, f)) for f in traces)
    smoke.require("--profile_dir: a trace of steps 1-3",
                  traces == ["steps_1-3.trace.json"] and trace_bytes > 0,
                  f"({traces}, {trace_bytes} bytes)")
    opt_n = TrainOptions().parse(e2e + cap + ["--name", "e2e_nan",
                                              "--debug_nans"])
    ds = dsm.FrameDataset(opt_n)
    batch = dsm.collate([ds[0], ds[1]])
    batch["image"][0, 5, 5, 0] = np.nan
    step = make_train_step(opt_n, st.renderer, st.disc, st.vgg, st.g_opt,
                           st.d_opt)
    raised = ""
    try:
        loop.run_training(opt_n, iter([batch]), step, st, 1)
    except FloatingPointError as e:
        raised = str(e)
    print(f"[launchers] --debug_nans: {raised}", flush=True)
    smoke.require("--debug_nans raised FloatingPointError naming the loss",
                  "G_" in raised)
    del st, step, batch
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(json.dumps({"launchers": {
        "frames": LAUNCH_FRAMES, "size": 512, "stages": stages,
        "feat_encoder_ms": feat, "corpus_write_s": corpus_s,
        "texture_unfold_s": unfold_s, "align_s": align_s,
        "encode_features_s": enc_s,
        "serving_e2e_codes_video": {"frames": n_s1, "video_frames": n_video,
                                    "wall_s": serve1_s, "launches": l_s1},
        "serving_test_infer": {"frames": n_s2, "wall_s": serve2_s,
                               "launches": l_s2, "batch": 8,
                               "ms_per_batch": serve_ms,
                               "fps": 8e3 / serve_ms,
                               "peak_mem_bytes": serve_peak},
        "profile": {"run_s": prof_s, "trace_bytes": trace_bytes},
        "phase_s": phase_s,
        "card": smi}}), flush=True)
    shutil.rmtree(work, ignore_errors=True)    # checkpoints, 78-channel .npy
    return launches["train_e2e"]


QUALITY_FRAMES = 8
CORRUPT_FRAMES = 8
# the oracle's bound: the JAX package's (tests/test_synthetic_video.py)
ORACLE_TOL = 1e-5
# evaluate on the card against the CPU on the same dirs
EVAL_PSNR_TOL, EVAL_SSIM_TOL, EVAL_FLICKER_RTOL, EVAL_VGG_RTOL = (
    1e-3, 1e-5, 1e-5, 3e-2)
EVAL_CPU_FRAMES = 2
# bench.py's and bench_infer.py's rounds: one warm-up, then 2 x 20 steps;
# one warm-up and 1 x 20 forwards (bench_infer: 2 x 20)
BENCH_STEPS, BENCH_FORWARDS, BENCH_INFER_FORWARDS = 1 + 2 * 20, 1 + 20, 1 + 2 * 20


def captured_main(main, argv):
    """main(argv) with its standard output captured (and echoed); returns
    (its return value, the last line it printed)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    print(out, end="", flush=True)
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return rc, (lines[-1] if lines else "")


def measure_path(torch, smoke, tk, fk, repo, dev, smi):
    """Phase 9: the port measures itself. (a) bench.main and (b)
    bench_infer.main in process: their JSON lines (keys, finite values
    > 0) and the launches of each train step and inference batch (the
    fused forward's two modes told apart by its wrapper's counters); (c) the bilinear corpus oracle on the fused kernel: a 512 px
    frame of data/synthetic_video rendered by texture_warp_planes on the
    card from its own IUV, atlas and bg, within 1e-5; (d) make_demo_data
    at 512 px (QUALITY_FRAMES frames bilinear; 8 frames with --corrupt
    0.5), read back through FrameDataset; (e) quality_run at FULL_FLAGS,
    cut in depth only (QUALITY_FRAMES frames, 1 pre-epoch, 2 epochs): its
    val curve, the served frames, the parity JSON, and stage 2's
    launches from its log; (f) evaluate on the card: identical dirs score
    perfectly, and the renders against the GT agree with the same command
    on the CPU. Returns the launches per
    bench step and per inference batch."""
    import math
    import numpy as np
    from neural_human_video_rendering_tpu_torch import (bench, bench_infer,
                                                        make_demo_data,
                                                        quality_run)
    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.data import \
        synthetic_video as sv
    from neural_human_video_rendering_tpu_torch.infer import evaluate
    from neural_human_video_rendering_tpu_torch.ops import texture_warp as ttw
    t_phase = time.perf_counter()
    work = os.path.join(repo, "build", "chip_smoke", "measure")
    shutil.rmtree(work, ignore_errors=True)
    none = {k: 0 for k in REPLACES}
    numbers = {}

    # ---- a, b: the benchmark entry points, launches per step and batch
    seen = {}

    def counted(name, module, fn_name):
        fn = getattr(module, fn_name)

        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            tk.reset_launch_counts()
            fk.reset_launch_counts()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            seen[name] = {**launch_counts(), **fused_modes()}
            return out
        return fn, wrapped

    patches = [(bench, "train_steps_per_sec", "bench_train"),
               (bench, "inference_fps", "bench_inference"),
               (bench_infer, "inference_fps", "bench_infer")]
    saved = []
    try:
        for module, fn_name, name in patches:
            fn, wrapped = counted(name, module, fn_name)
            saved.append((module, fn_name, fn))
            setattr(module, fn_name, wrapped)
        lines = {}
        for name, main, argv in (
                ("bench", bench.main, ["--ckpt", "", "--gpu_ids", "0"]),
                ("bench_infer", bench_infer.main, ["--gpu_ids", "0"])):
            t = time.perf_counter()
            rc, last = captured_main(main, argv)
            numbers[f"{name}_wall_s"] = time.perf_counter() - t
            lines[name] = json.loads(last)
            smoke.require(f"{name}.main exits 0", rc == 0)
            torch.cuda.empty_cache()
    finally:
        for module, fn_name, fn in saved:
            setattr(module, fn_name, fn)
    b, bi = lines["bench"], lines["bench_infer"]
    smoke.require("bench: its JSON line's keys, finite values > 0",
                  list(b) == ["metric", "value", "unit", "inference_fps",
                              "regime"]
                  and b["metric"] == "train_steps_per_sec_512px_bs2"
                  and b["regime"] == "randinit+bf16warp"
                  and all(math.isfinite(b[k]) and b[k] > 0
                          for k in ("value", "inference_fps")), json.dumps(b))
    smoke.require("bench_infer: its JSON line's keys, finite values > 0",
                  list(bi) == ["metric", "value", "unit", "vs_baseline"]
                  and bi["metric"] == "inference_fps_512px"
                  and all(math.isfinite(bi[k]) and bi[k] > 0
                          for k in ("value", "vs_baseline")), json.dumps(bi))
    want_step = {**none, "texture_warp_topk_fwd": 2, "texture_warp_bwd": 1,
                 "flow_warp_fwd": 1, "keep_w": 1, "no_w": 1}
    smoke.require(
        "bench: a train step launches the fused forward keeping w once, the "
        "fused forward without w once (the t-1 render), the backward and "
        "the flow warp once; top-k and the w-given forward never",
        seen["bench_train"] == {k: v * BENCH_STEPS
                                for k, v in want_step.items()},
        f"({seen['bench_train']} in {BENCH_STEPS} steps)")
    for name, n in (("bench_inference", BENCH_FORWARDS),
                    ("bench_infer", BENCH_INFER_FORWARDS)):
        smoke.require(f"{name}: the fused forward without w once a batch, "
                      "no other kernel",
                      seen[name] == {**none, "texture_warp_topk_fwd": n,
                                     "keep_w": 0, "no_w": n},
                      f"({seen[name]} in {n} batches)")
    per_step = {k: seen["bench_train"][k] / BENCH_STEPS for k in REPLACES}
    per_batch = {k: seen["bench_inference"][k] / BENCH_FORWARDS
                 for k in REPLACES}
    print(f"[measure] bench: {json.dumps(b)}; bench_infer: {json.dumps(bi)};"
          f" launches {json.dumps(seen)} | {smi}", flush=True)

    # ---- c: the bilinear corpus oracle on the fused kernel
    S, T = 512, 64
    kp_dir = os.path.join(work, "keypoints")
    base = TrainOptions().parse(TRAIN, save=False)
    write_driving_sequence(base, kp_dir, QUALITY_FRAMES)
    joints = sv.load_reference_joints(kp_dir, S)
    parts, uv, _ = sv.rasterize_iuv(joints[QUALITY_FRAMES // 2], S)
    atlas, bg = sv.part_texture_atlas(tile=T), sv.background_image(S)
    frame, mask = sv.render_frame(parts, uv, atlas, bg, "bilinear")
    P = atlas.shape[0]
    tex_t = torch.from_numpy(atlas).permute(0, 3, 1, 2)[None].to(dev)
    uv_t = torch.from_numpy(uv).permute(2, 0, 1)[None, None].expand(
        1, P, 2, S, S).contiguous().to(dev)
    probs_t = torch.from_numpy(np.eye(P + 1, dtype=np.float32)[parts]).permute(
        2, 0, 1)[None].contiguous().to(dev)
    launches_before = tk.texture_warp_topk_fwd.launches
    with torch.no_grad():
        fg = ttw.texture_warp_planes(tex_t, uv_t, probs_t, k=4, eps=1e-3)
    torch.cuda.synchronize()
    smoke.require("oracle: texture_warp_planes launched the fused kernel",
                  tk.texture_warp_topk_fwd.launches == launches_before + 1)
    fg = fg[0].permute(1, 2, 0).cpu().numpy()
    err = float(np.abs(mask * fg + (1 - mask) * bg - frame).max())
    numbers["oracle_max_abs_err"] = err
    smoke.check(f"oracle: a bilinear {S} px corpus frame (T={T}, "
                f"{int((parts > 0).sum())} body pixels) == the fused kernel's "
                "warp of its own IUV, composited", err, ORACLE_TOL)
    del tex_t, uv_t, probs_t

    # ---- d: make_demo_data at 512 px, read back through FrameDataset
    data = os.path.join(work, "demo")
    t = time.perf_counter()
    smoke.require(f"make_demo_data ({QUALITY_FRAMES} frames, bilinear)",
                  make_demo_data.main([
                      "--out", data, "--keypoints", kp_dir, "--size", str(S),
                      "--tile", str(T), "--sampling", "bilinear"]) == 0)
    numbers["make_demo_data_s"] = time.perf_counter() - t
    kp8 = os.path.join(work, "keypoints8")
    write_driving_sequence(base, kp8, CORRUPT_FRAMES)
    noisy = os.path.join(work, "demo_corrupt")
    t = time.perf_counter()
    smoke.require("make_demo_data (8 frames, --corrupt 0.5)",
                  make_demo_data.main(["--out", noisy, "--keypoints", kp8,
                                       "--size", str(S), "--tile", str(T),
                                       "--corrupt", "0.5"]) == 0)
    numbers["make_demo_data_8_frames_corrupt_s"] = time.perf_counter() - t
    for root, n, corrupt in ((data, QUALITY_FRAMES, False),
                             (noisy, CORRUPT_FRAMES, True)):
        fopt = TrainOptions().parse([
            "--loadSize", str(S), "--tex_tile", str(T),
            "--pose_path", f"{root}/openpose_json", "--img_path",
            f"{root}/frames", "--mask_path", f"{root}/mask",
            "--densepose_path", f"{root}/densepose", "--flow_path",
            f"{root}/flow", "--flow_inv_path", f"{root}/flow_inv",
            "--no_flip"], save=False)
        ds = dsm.FrameDataset(fopt)
        s1 = ds[1]
        true_mask = (sv.rasterize_iuv(sv.load_reference_joints(
            fopt.pose_path, S)[1], S)[0] > 0).astype(np.float32)
        mask_differs = bool((s1["mask"][..., 0] != true_mask).any())
        flo = dsm.read_flo(os.path.join(root, "flow", "frame00000.flo"))
        smoke.require(
            f"make_demo_data {os.path.basename(root)}: FrameDataset reads "
            f"{n} frames at {S} px with keypoints, mask, IUV and .flo flows; "
            f"the mask is {'corrupted' if corrupt else 'the true one'}",
            len(ds) == n and s1["image"].shape == (S, S, 3)
            and s1["dp_parts"].shape == (S, S) and s1["joints"].shape == (18, 3)
            and np.array_equal(s1["flow"], flo)
            and mask_differs == corrupt
            and os.path.isfile(os.path.join(root, "texture.png")),
            f"({len(ds)} frames, mask differs {mask_differs})")

    # ---- e: quality_run at FULL_FLAGS, cut in depth
    q = os.path.join(work, "quality")
    cut = {"frames": QUALITY_FRAMES, "pre_epochs": 1, "epochs": 2}
    torch.cuda.empty_cache()
    t = time.perf_counter()
    rc, _ = captured_main(quality_run.main, [
        "--out", q, "--keypoints", kp_dir, "--size", str(S), "--tile",
        str(T), "--pre_epochs", "1", "--epochs", "2", "--extra",
        "--gpu_ids 0"])
    numbers["quality_run_wall_s"] = time.perf_counter() - t
    smoke.require("quality_run exits 0", rc == 0)
    with open(os.path.join(q, "quality_run.json")) as f:
        qr = json.load(f)
    curve = qr["val_curve"]
    smoke.require("quality_run: 2 finite val points",
                  [p["epoch"] for p in curve] == [1, 2] and all(
                      math.isfinite(p["val_PSNR"]) and math.isfinite(
                          p["val_SSIM"]) for p in curve), json.dumps(curve))
    served = dsm.list_images(os.path.join(q, "renders", "images"))
    smoke.require("quality_run: one served frame per corpus frame",
                  len(served) == QUALITY_FRAMES == qr["config"]["frames"],
                  str(len(served)))
    parity = qr["final_parity_all_frames"]
    smoke.require("quality_run: the parity JSON is finite",
                  set(parity) == {"psnr", "ssim", "temporal_l1",
                                  "temporal_l1_gt", "flicker_ratio", "frames"}
                  and all(math.isfinite(v) for v in parity.values()),
                  json.dumps(parity))
    with open(os.path.join(q, "ckpt", "e2e", "metrics.jsonl")) as f:
        steps = max(json.loads(ln)["step"] for ln in f if ln.strip())
    qopt = TrainOptions().parse([
        "--loadSize", str(S), "--img_path", f"{q}/data/frames",
        "--data_ratio", "0.9", "--no_flip"], save=False)
    held_out = len(dsm.FrameDataset(qopt, "test"))
    with open(os.path.join(q, "run.log")) as f:
        logged = [json.loads(ln.split(": ", 1)[1]) for ln in f
                  if ln.startswith("[kernels] launches")]
    # temporal_prev fake: t and the t-1 render; one fused launch per
    # held-out batch of each epoch's eval
    want = {**none, "texture_warp_topk_fwd": 2 * steps + 2 * math.ceil(
        held_out / 2), "texture_warp_bwd": steps, "flow_warp_fwd": steps}
    smoke.require("quality_run stage 2: per step 2 fused forwards, 1 "
                  "backward, 1 flow warp (real .flo flows); 1 fused forward a "
                  "held-out batch", logged == [want],
                  f"({logged}, {steps} steps, {held_out} held out)")
    print(f"[measure] quality_run at FULL_FLAGS 512 px tile 64, cut in depth "
          f"only ({json.dumps(cut)}): {json.dumps(qr)} | {smi}", flush=True)

    # ---- f: evaluate on the card
    gt = os.path.join(q, "data", "frames")
    res = os.path.join(q, "renders", "images")
    common = ["--loadSize", str(S), "--metric", "lpips,temporal"]
    t = time.perf_counter()
    same = evaluate.main(["--results_dir", gt, "--gt_dir", gt, "--gpu_ids",
                          "0"] + common)
    numbers["evaluate_identical_s"] = time.perf_counter() - t
    smoke.require("evaluate, identical dirs: PSNR >= 100, SSIM 1 +- 1e-5, "
                  "VGG distance and LPIPS 0 +- 1e-6",
                  same["psnr"] >= 100 and abs(same["ssim"] - 1) <= 1e-5
                  and abs(same["vgg_dist"]) <= 1e-6
                  and abs(same["lpips"]) <= 1e-6, json.dumps(same))
    runs = {}
    for name, ids in (("card", "0"), ("cpu", "-1")):
        t = time.perf_counter()
        runs[name] = evaluate.main(["--results_dir", res, "--gt_dir", gt,
                                    "--gpu_ids", ids, "--max_frames",
                                    str(EVAL_CPU_FRAMES)] + common)
        numbers[f"evaluate_{name}_{EVAL_CPU_FRAMES}_frames_s"] = \
            time.perf_counter() - t
    card, cpu = runs["card"], runs["cpu"]
    rel = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12)
           for k in ("temporal_l1", "temporal_l1_gt", "flicker_ratio",
                     "vgg_dist", "lpips")}
    numbers["evaluate_card_vs_cpu"] = {
        "psnr_abs": abs(card["psnr"] - cpu["psnr"]),
        "ssim_abs": abs(card["ssim"] - cpu["ssim"]), **{
            f"{k}_rel": v for k, v in rel.items()}}
    smoke.check("evaluate card vs cpu: PSNR (dB)",
                abs(card["psnr"] - cpu["psnr"]), EVAL_PSNR_TOL)
    smoke.check("evaluate card vs cpu: SSIM", abs(card["ssim"] - cpu["ssim"]),
                EVAL_SSIM_TOL)
    smoke.check("evaluate card vs cpu: flicker (relative)",
                max(rel[k] for k in ("temporal_l1", "temporal_l1_gt",
                                     "flicker_ratio")), EVAL_FLICKER_RTOL)
    smoke.check("evaluate card vs cpu: VGG distance, LPIPS (relative, bf16)",
                max(rel["vgg_dist"], rel["lpips"]), EVAL_VGG_RTOL)

    # ---- g: quality_profile on (e)'s run
    t = time.perf_counter()
    numbers["quality_profile"] = quality_profile_path(
        torch, smoke, tk, fk, q, S, T, smi)
    numbers["quality_profile_s"] = time.perf_counter() - t
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"measure": {
        "bench": b, "bench_infer": bi, "launches": seen,
        "quality_run": qr, "quality_run_cut": cut,
        "evaluate_identical": same, "evaluate_card": card,
        "evaluate_cpu": cpu, **numbers, "card": smi}}), flush=True)
    shutil.rmtree(work, ignore_errors=True)       # checkpoints, corpora
    return {"per_train_step": per_step, "per_inference_batch": per_batch,
            "quality_profile": numbers["quality_profile"]["launches"]["cuda"]}


PROFILE_TILES = (32, 64, 128)
# quality_profile's model-free numbers, fused kernel vs plain warp: float32
# sums of one part a pixel in another order
PROFILE_PSNR_TOL, PROFILE_SSIM_TOL = 1e-3, 1e-4


def plain_warp(tex, uv, probs, k, eps):
    """The renderer's warp through the kernels' plain versions (on the
    card here: the yardstick of quality_profile's substitutions)."""
    from neural_human_video_rendering_tpu_torch.ops import texture_warp as ttw
    from neural_human_video_rendering_tpu_torch.ops import \
        texture_warp_kernel as tk
    B, _, H, W = probs.shape
    tex32, fg, u, v = ttw._operands(tex, uv, probs, "float32")
    w = tk.topk_select_plain(fg, k, 0, eps)
    return tk.texture_warp_fwd_plain(tex32, u, v, w).view(B, -1, H, W)


def quality_profile_path(torch, smoke, tk, fk, q, S, T, smi):
    """Phase 9 (g): quality_profile.main on the cut quality run's held-out
    frames (its run dir and corpus under q) at FULL_FLAGS, the
    substitutions' warps through the fused kernel and then through the
    plain warp on the card. Checks: every variant and tile finite; the
    model-free all_gt_exact and tile sweep equal across the two routes
    (PROFILE_*_TOL): the fused kernel on one-hot probabilities and one UV
    copied to every part; launches_per_frame fused launches without w a
    frame (the plain route: only the model's forward)."""
    import math
    from neural_human_video_rendering_tpu_torch import quality_profile as qp
    from neural_human_video_rendering_tpu_torch import quality_run
    argv = ["--data", os.path.join(q, "data"), "--run_dir",
            os.path.join(q, "ckpt", "e2e"), "--how_many", "8",
            "--ceiling_tiles", ",".join(str(t) for t in PROFILE_TILES), "--",
            "--loadSize", str(S), "--tex_tile", str(T),
            *quality_run.FULL_FLAGS, "--gpu_ids", "0"]
    out, counts, secs = {}, {}, {}
    for route, warp in (("cuda", qp.kernel_warp), ("plain", plain_warp)):
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        fk.reset_launch_counts()
        t = time.perf_counter()
        out[route] = json.loads(json.dumps(qp.main(argv, warp=warp)))
        torch.cuda.synchronize()
        secs[route] = time.perf_counter() - t
        counts[route] = launch_counts()
    none = {k: 0 for k in REPLACES}
    res, plain = out["cuda"], out["plain"]
    n = res["config"]["frames"]
    per = qp.launches_per_frame(len(PROFILE_TILES))
    smoke.require(
        f"quality_profile: {per} fused launches without w a frame (the "
        f"model, 4 substitutions, {len(PROFILE_TILES)} tiles) in {n} "
        "frames, no other kernel; the plain route only the model's",
        counts["cuda"] == {**none, "texture_warp_topk_fwd": per * n}
        and counts["plain"] == {**none, "texture_warp_topk_fwd": n},
        json.dumps(counts))
    rows = list(res["variants"].values()) + list(res["tile_ceiling"].values())
    smoke.require(f"quality_profile: 7 variants and {len(PROFILE_TILES)} "
                  "tiles, all finite",
                  len(res["variants"]) == 7 and sorted(
                      res["tile_ceiling"], key=int) == [
                          str(t) for t in PROFILE_TILES]
                  and all(math.isfinite(r["PSNR"]) and math.isfinite(
                      r["SSIM"]) for r in rows), json.dumps(res))
    pairs = {"all_gt_exact": (res["variants"]["all_gt_exact"],
                              plain["variants"]["all_gt_exact"]),
             **{f"tile {t}": (res["tile_ceiling"][t], plain["tile_ceiling"][t])
                for t in res["tile_ceiling"]}}
    d_psnr = max(abs(a["PSNR"] - b["PSNR"]) for a, b in pairs.values())
    d_ssim = max(abs(a["SSIM"] - b["SSIM"]) for a, b in pairs.values())
    smoke.check("quality_profile: all_gt_exact and the tile sweep, fused "
                "kernel vs plain warp: PSNR (dB)", d_psnr, PROFILE_PSNR_TOL)
    smoke.check("quality_profile: all_gt_exact and the tile sweep, fused "
                "kernel vs plain warp: SSIM", d_ssim, PROFILE_SSIM_TOL)
    others = {k: abs(res["variants"][k]["PSNR"] - plain["variants"][k]["PSNR"])
              for k in res["variants"]}
    # the fused kernel's device time on one-hot probabilities and one UV
    # copied to every part (all_gt_exact of the last corpus frame, B=1)
    from neural_human_video_rendering_tpu_torch.data import \
        synthetic_video as sv
    from neural_human_video_rendering_tpu_torch.ops import texture_warp as ttw
    dev = torch.device("cuda", 0)
    P = 24
    joints = sv.load_reference_joints(os.path.join(q, "data", "openpose_json"),
                                      S)[-1]
    onehot, _, uv2 = qp.exact_gt(joints, S, P, dev)
    atlas = qp.atlas_tensor(sv.part_texture_atlas(P, tile=T), dev)
    uv = uv2[:, None].expand(1, P, 2, S, S).contiguous()
    tex32, fg, u, v = ttw._operands(atlas, uv, onehot, "float32")
    one_hot_ms = {
        "ms": graph_ms(torch, lambda: tk.texture_warp_topk_fwd(
            tex32, fg, u, v, 4, 1e-3)),
        "plain_ms": cuda_ms(torch, lambda: plain_warp(atlas, uv, onehot, 4,
                                                      1e-3), iters=5,
                            warmup=1),
        "body_pixels": int((onehot[:, 1:].sum(1) > 0).sum())}
    print(f"[measure] quality_profile ({n} held-out frames, FULL_FLAGS 512 px "
          f"tile 64): {json.dumps(res)}; plain-warp route: "
          f"{json.dumps(plain)}; |dPSNR| every variant {json.dumps(others)} "
          f"| {smi}", flush=True)
    print(f"[measure] texture_warp_topk_fwd on one-hot probabilities "
          f"(B=1, {S}^2, T={T}, k=4, eps=1e-3): {json.dumps(one_hot_ms)}",
          flush=True)
    return {"table": res, "plain_route": plain, "frames": n,
            "launches_per_frame": per, "launches": counts, "s": secs,
            "model_free_max_dpsnr": d_psnr, "model_free_max_dssim": d_ssim,
            "one_hot_fused": one_hot_ms}


# phase 10: every model and training option of the JAX package
OPT_FRAMES = 6            # batch 2: 3 steps an epoch; stage 1 (batch 6): 1
OPT_STEPS = 5             # each stage's steps: (d) crosses the unfreeze
OPT_S, OPT_SERVE = 1024, 8
OPT_SYM_S = 512           # the flagship's frames: the symmetric step's 2B
# the recipe flags phase 10 replaces with its corpus and run dir
RECIPE_PATHS = ("--name", "--checkpoints_dir", "--pose_path", "--mask_path",
                "--img_path", "--densepose_path", "--bg_path",
                "--texture_path", "--flow_path", "--flow_inv_path",
                "--load_pretrain_TransG", "--which_epoch_TransG")
# a stage-2 step of the flagship's kind (--temporal_prev real): the fused
# forward keeping w, the backward, the flow warp, once each; the
# symmetric step (--no_temporal_detach_prev) the same, its forward at 2B
OPT_STEP_LAUNCHES = {**{k: 0 for k in REPLACES}, "texture_warp_topk_fwd": 1,
                     "texture_warp_bwd": 1, "flow_warp_fwd": 1,
                     "keep_w": 1, "no_w": 0}
S2_KEYS = ["D_total", "G_FM", "G_GAN", "G_L2", "G_Mask", "G_Prob", "G_Temp",
           "G_UV", "G_VGG", "G_total"]


def recipe_argv(repo, run, drop=()):
    """A recipe's own flags (checkpoints/<run>/recipe.json), without its
    paths and without the flags in ``drop``."""
    with open(os.path.join(repo, "checkpoints", run, "recipe.json")) as f:
        argv = json.load(f)["argv"][1:]
    out, i = [], 0
    while i < len(argv):
        if argv[i] in RECIPE_PATHS:
            i += 2
            continue
        if argv[i] not in drop:
            out.append(argv[i])
        i += 1
    return out


def options_path(torch, smoke, tk, fk, repo, dev, smi):
    """Phase 10: the model and training options of the JAX package at full
    width, through the drivers' functions (OPT_STEPS steps a stage) on a
    real-format corpus of OPT_FRAMES frames: (a) r4's uv_uvr -> e2e_uvr
    (--uv_refine 3, the TransG handoff); (b) r5's uv_msuv -> e2e_msuv with
    --lambda_UVgrad 500; (c) the flagship with --temporal_prev fake
    --no_temporal_detach_prev --pool_size 50, flip, --resize_or_crop
    resize_and_crop --loadSize 576 --fineSize 512; (d) pix2pixHD's 1024 px
    setting (--netG local --ngf 32 --loadSize 1024: the trunk is the
    flagship's 64-wide TransG at 512 px) with --niter_fix_global 1 across
    the unfreeze, then serving at batch 8. Checks: finite losses, JAX's
    loss keys, the launches per step, the trunk frozen then moving, the
    kernels against their plain versions at 1024^2 and at 2B, tiny steps
    card vs CPU with the options. Returns the launches and numbers."""
    import numpy as np
    from neural_human_video_rendering_tpu_torch.config import (TestOptions,
                                                               TrainOptions)
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.data.wire import pack_batch
    from neural_human_video_rendering_tpu_torch.infer import test_driver as td
    from neural_human_video_rendering_tpu_torch.train import drivers
    from neural_human_video_rendering_tpu_torch.train.steps import (
        make_forward_fn, make_train_step)
    t_phase = time.perf_counter()
    work = os.path.join(repo, "build", "chip_smoke", "options")
    shutil.rmtree(work, ignore_errors=True)
    corpus, ck = os.path.join(work, "corpus"), os.path.join(work, "ckpt")
    t = time.perf_counter()
    d = write_corpus(TrainOptions().parse(TRAIN, save=False), corpus,
                     OPT_FRAMES)
    print(f"[options] corpus of {OPT_FRAMES} frames at 512 px in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    data = ["--pose_path", d["openpose_json"], "--mask_path", d["mask"],
            "--densepose_path", d["densepose"], "--checkpoints_dir", ck,
            "--gpu_ids", "0", "--seed", "0", "--print_freq", "1",
            "--display_freq", "10000", "--save_epoch_freq", "10000"]
    s2 = data + ["--img_path", d["frames"], "--flow_path", d["flow"],
                 "--flow_inv_path", d["flow_inv"], "--bg_path",
                 os.path.join(corpus, "bg.png"), "--texture_path",
                 os.path.join(corpus, "texture.png"), "--data_ratio", "1.0",
                 "--save_latest_freq", "0"]
    none = {k: 0 for k in REPLACES}

    # the fused forward's modes by its wrapper's counters; each stage-2
    # step's batch keys and an after-step hook by a spy on the step
    make = drivers.make_train_step
    hooks = {"keys": set(), "after": None}

    def spy_make(*args):
        step = make(*args)

        def wrapped(st, batch, mark=None):
            hooks["keys"].update(batch)
            out = step(st, batch, mark)
            if hooks["after"] is not None:
                hooks["after"](st)
            return out
        return wrapped

    runs = {}

    def run(name, fn, argv):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tk.reset_launch_counts()
        fk.reset_launch_counts()
        hooks["keys"] = set()
        opt = TrainOptions().parse(argv + ["--name", name], save=False)
        t = time.perf_counter()
        st = fn(opt, max_steps=OPT_STEPS)
        torch.cuda.synchronize()
        times = sorted(st.step_seconds)
        med = times[len(times) // 2] * 1e3
        losses = {k: float(v) for k, v in st.metrics.items()}
        runs[name] = {"steps": st.step, "ms_median": med,
                      "ms_steps": [x * 1e3 for x in st.step_seconds],
                      "wall_s": time.perf_counter() - t,
                      "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                      "launches": {**launch_counts(), **fused_modes()},
                      "losses": losses}
        print(f"[options] {name}: {json.dumps(runs[name])} | {smi}",
              flush=True)
        smoke.require(f"{name}: {OPT_STEPS} steps, finite losses",
                      st.step == OPT_STEPS and all(
                          np.isfinite(v) for v in losses.values()),
                      json.dumps(losses))
        return st, opt

    def stage2_numbers(name, st, opt, per_step):
        """The launches a step, then the step on one packed batch of the
        run's data: its median ms and the device's busy share (trace)."""
        got = runs[name]["launches"]
        smoke.require(f"{name}: launches per step {json.dumps(per_step)}",
                      got == {k: v * OPT_STEPS for k, v in per_step.items()},
                      json.dumps(got))
        ds = drivers._dataset(opt, "train")
        batch = pack_batch(dsm.collate([ds[0], ds[1]]))
        step = make(opt, st.renderer, st.disc, st.vgg, st.g_opt, st.d_opt)
        fixed = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(st, batch)
            torch.cuda.synchronize()
            fixed.append(time.perf_counter() - t)
        fixed_ms = sorted(fixed[1:])[1] * 1e3
        trace = trace_forward(torch, lambda: step(st, batch), iters=2, top=5)
        runs[name].update(
            fixed_batch_ms_median=fixed_ms,
            device_busy_ms=trace["device_busy_ms_per_call"],
            device_busy_share=trace["device_busy_ms_per_call"] / fixed_ms,
            port_kernels_ms=trace["port_kernels_ms_per_call"],
            top_kernels_ms=trace["top_kernels_ms_per_call"])
        print(f"[options] {name}: {json.dumps(runs[name])} | {smi}",
              flush=True)

    drivers.make_train_step = spy_make
    try:
        # ---- (a) r4 uv_uvr -> e2e_uvr: --uv_refine 3, the TransG handoff
        st, _ = run("a_uv_uvr", drivers.run_pretrain_uv,
                    recipe_argv(repo, "r4/uv_uvr") + data
                    + ["--save_latest_freq", str(OPT_STEPS)])
        smoke.require("a_uv_uvr: JAX's losses, the refine stack, no kernel",
                      sorted(st.metrics) == ["Prob", "UV", "total"]
                      and hasattr(st.net, "refine_block2")
                      and runs["a_uv_uvr"]["launches"] == {
                          **none, "keep_w": 0, "no_w": 0})
        uv_a = {k: v.cpu() for k, v in st.net.state_dict().items()}
        del st
        st, opt = run("a_e2e_uvr", drivers.run_train,
                      recipe_argv(repo, "r4/e2e_uvr") + s2 + [
                          "--load_pretrain_TransG",
                          os.path.join(ck, "a_uv_uvr"),
                          "--which_epoch_TransG", "latest"])
        smoke.require("a_e2e_uvr: JAX's loss keys", sorted(st.metrics)
                      == S2_KEYS, str(sorted(st.metrics)))
        smoke.require("a_e2e_uvr: the handoff loaded stage 1's TransG "
                      "(its refine stack included)",
                      set(uv_a) == set(st.renderer.TransG.state_dict())
                      and any(k.startswith("refine_") for k in uv_a))
        stage2_numbers("a_e2e_uvr", st, opt, OPT_STEP_LAUNCHES)
        del st, uv_a

        # ---- (b) r5 uv_msuv -> e2e_msuv, with r4's --lambda_UVgrad 500
        st, _ = run("b_uv_msuv", drivers.run_pretrain_uv,
                    recipe_argv(repo, "r5/uv_msuv") + data
                    + ["--lambda_UVgrad", "500",
                       "--save_latest_freq", str(OPT_STEPS)])
        smoke.require("b_uv_msuv: JAX's losses (UVgrad, MSUV)",
                      sorted(st.metrics) == ["MSUV", "Prob", "UV", "UVgrad",
                                             "total"], str(sorted(st.metrics)))
        del st
        st, opt = run("b_e2e_msuv", drivers.run_train,
                      recipe_argv(repo, "r5/e2e_msuv") + s2 + [
                          "--lambda_UVgrad", "500", "--load_pretrain_TransG",
                          os.path.join(ck, "b_uv_msuv"),
                          "--which_epoch_TransG", "latest"])
        smoke.require("b_e2e_msuv: JAX's loss keys (G_UVgrad, G_MSUV)",
                      sorted(st.metrics) == sorted(S2_KEYS + ["G_MSUV",
                                                              "G_UVgrad"]),
                      str(sorted(st.metrics)))
        stage2_numbers("b_e2e_msuv", st, opt, OPT_STEP_LAUNCHES)
        del st

        # ---- (c) the flagship, symmetric temporal mode, pool, flip, crop
        st, opt = run("c_symmetric", drivers.run_train,
                      recipe_argv(repo, "flagship", drop=("--no_flip",)) + s2
                      + ["--temporal_prev", "fake",
                         "--no_temporal_detach_prev", "--pool_size", "50",
                         "--resize_or_crop", "resize_and_crop",
                         "--loadSize", "576", "--fineSize", "512"])
        smoke.require("c_symmetric: JAX's loss keys", sorted(st.metrics)
                      == S2_KEYS, str(sorted(st.metrics)))
        smoke.require("c_symmetric: crop windows of the background in the "
                      "batch, flip on, the pool filled by 2 a step",
                      "bg" in hooks["keys"] and not opt.no_flip
                      and int(st.pool_n) == 2 * OPT_STEPS
                      and tuple(st.bg.shape[1:]) == (512, 512),
                      f"({sorted(hooks['keys'])}, pool {int(st.pool_n)})")
        stage2_numbers("c_symmetric", st, opt, OPT_STEP_LAUNCHES)
        # the symmetric step's only PyTorch backward on the path: the flow
        # warp's (the plain version's VJP, as the JAX package's)
        img, flow = flow_inputs(torch, 2, opt.train_size, 5, dev)
        img.requires_grad_()
        g = torch.randn_like(img)
        runs["c_symmetric"]["flow_warp_bwd_ms"] = cuda_ms(
            torch, lambda: torch.autograd.grad(
                fk.flow_warp_fwd_plain(img, flow), img, g), iters=10)
        print(f"[options] flow warp backward (plain VJP, B=2, C=5, "
              f"{opt.train_size}^2): {runs['c_symmetric']['flow_warp_bwd_ms']:.4f}"
              f" ms | {smi}", flush=True)
        del st, img, flow, g

        # ---- (d) pix2pixHD's 1024 px: --netG local, the trunk frozen for
        # the first epoch (3 steps), then moving
        frozen = {"trunk": [], "enh": []}
        ref = {}

        def split(st):
            trunk, enh = {}, {}
            for k, v in st.renderer.named_parameters():
                if "global_trunk" in k.split("."):
                    trunk[k] = v
                elif ".LocalEnhancer_0." in k:
                    enh[k] = v
            return trunk, enh

        def after(st):
            trunk, enh = split(st)
            frozen["trunk"].append(all(torch.equal(v, ref["trunk"][k])
                                       for k, v in trunk.items()))
            frozen["enh"].append(all(torch.equal(v, ref["enh"][k])
                                     for k, v in enh.items()))

        def first(st):
            # the state before its first step: run_train's own init
            trunk, enh = split(st)
            ref["trunk"] = {k: v.detach().clone() for k, v in trunk.items()}
            ref["enh"] = {k: v.detach().clone() for k, v in enh.items()}

        orig = drivers.run_training

        def run_training(opt, loader, step, st, *args, **kw):
            first(st)
            return orig(opt, loader, step, st, *args, **kw)

        hooks["after"] = after
        drivers.run_training = run_training
        try:
            d_flags = recipe_argv(repo, "flagship") + s2 + [
                "--netG", "local", "--ngf", "32", "--loadSize", str(OPT_S),
                "--niter_fix_global", "1"]
            st, opt = run("d_local_1024", drivers.run_train, d_flags)
        finally:
            drivers.run_training = orig
            hooks["after"] = None
        spe = OPT_FRAMES // opt.batchSize
        smoke.require("d_local_1024: JAX's loss keys", sorted(st.metrics)
                      == S2_KEYS, str(sorted(st.metrics)))
        smoke.require(
            f"d_local_1024: every global_trunk parameter bit-equal for the "
            f"first {spe} steps, moved after; the enhancers moved from step 1",
            frozen["trunk"] == [True] * spe + [False] * (OPT_STEPS - spe)
            and frozen["enh"] == [False] * OPT_STEPS
            and st.g_opt.frozen_steps == spe and len(ref["trunk"]) > 0,
            json.dumps(frozen))
        runs["d_local_1024"]["trunk_frozen_by_step"] = frozen["trunk"]
        runs["d_local_1024"]["trunk_parameters"] = sum(
            v.numel() for v in ref["trunk"].values())
        del ref
        stage2_numbers("d_local_1024", st, opt, OPT_STEP_LAUNCHES)
        del st
    finally:
        drivers.make_train_step = make

    # ---- (d) serving at batch 8, 1024^2 (random weights from --seed)
    torch.cuda.empty_cache()
    topt = TestOptions().parse(
        recipe_argv(repo, "flagship") + [
            "--netG", "local", "--ngf", "32", "--loadSize", str(OPT_S),
            "--pose_path", os.path.join(work, "kp"), "--results_dir",
            os.path.join(work, "results"), "--checkpoints_dir", ck,
            "--name", "serve", "--gpu_ids", "0", "--seed", "0",
            "--infer_batch", str(OPT_SERVE)], save=False)
    syn = write_driving_sequence(topt, os.path.join(work, "kp"),
                                 2 * OPT_SERVE)
    assets = (syn.texture_atlas(), syn.background())
    tk.reset_launch_counts()
    fk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    n = td.run_inference(topt, assets=assets)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t
    got = launch_counts()
    smoke.require(f"serving at {OPT_S}^2: {2 * OPT_SERVE} frames, the fused "
                  "forward once a batch, no other kernel",
                  n == 2 * OPT_SERVE and got == {
                      **none, "texture_warp_topk_fwd": 2}, str(got))
    renderer = td.build_renderer(topt, dev)
    fwd = make_forward_fn(topt, renderer)
    dev_assets = td.assets_to_device(topt, *assets, dev)
    jb = torch.from_numpy(syn.joints[:OPT_SERVE].astype(np.float32)).to(dev)
    out = fwd(dev_assets, jb)
    smoke.require(f"serving: fake ({OPT_SERVE}, 3, {OPT_S}, {OPT_S}), finite",
                  tuple(out["fake"].shape) == (OPT_SERVE, 3, OPT_S, OPT_S)
                  and bool(torch.isfinite(out["fake"]).all()))
    del out
    serve_ms = cuda_ms(torch, lambda: fwd(dev_assets, jb), iters=5,
                       warmup=2)
    trace = trace_forward(torch, lambda: fwd(dev_assets, jb), iters=2, top=5)
    runs["d_serving_1024"] = {
        "batch": OPT_SERVE, "ms_per_batch": serve_ms,
        "fps": OPT_SERVE * 1e3 / serve_ms,
        "run_inference_wall_s": serve_wall,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": got, "device_busy_ms": trace["device_busy_ms_per_call"],
        "device_busy_share": trace["device_busy_ms_per_call"] / serve_ms,
        "port_kernels_ms": trace["port_kernels_ms_per_call"]}
    print(f"[options] d_serving_1024: {json.dumps(runs['d_serving_1024'])} | "
          f"{smi}", flush=True)
    del renderer, fwd, dev_assets, jb

    # ---- the kernels against their plain versions at this phase's shapes
    P, T, K, EPS = 24, 64, 4, 1e-3
    S = OPT_S
    numbers = {}
    errs = {}
    for b, seed in ((OPT_SERVE, 21), (2, 22)):
        tex, uv, probs = warp_inputs(torch, b, P, S, S, T, seed, dev)
        e, w = compare_kernels(torch, tk, smoke, f"B={b} {S}px", tex, uv,
                               probs, K, 0, EPS)
        errs[f"texture_warp_topk_fwd B={b} {S}px"] = \
            e["texture_warp_topk_fwd"]
        if b == 2:
            errs[f"texture_warp_bwd B=2 {S}px"] = compare_bwd(
                torch, tk, smoke, f"B=2 {S}px", tex, uv, probs, K, EPS)
            numbers[f"B=2 {S}px keep w"] = kernel_numbers(
                torch, tk, fk, tex, uv, probs, w, K, EPS,
                ("texture_warp_topk_fwd", "texture_warp_bwd",
                 "flow_warp_fwd"), flow=flow_inputs(torch, 2, S, 5, dev),
                keep_w=True)
        else:
            numbers[f"B={b} {S}px serving"] = kernel_numbers(
                torch, tk, fk, tex, uv, probs, w, K, EPS,
                ("texture_warp_topk_fwd",))
        del tex, uv, probs, w
        torch.cuda.empty_cache()
    # the symmetric step's 2B = 4 at 512^2, a texture per sample
    tex, uv, probs = warp_inputs(torch, 4, P, OPT_SYM_S, OPT_SYM_S, T, 23,
                                 dev)
    tag = f"2B=4 {OPT_SYM_S}px"
    e, w = compare_kernels(torch, tk, smoke, tag, tex, uv, probs, K, 0, EPS)
    errs[f"texture_warp_topk_fwd {tag}"] = e["texture_warp_topk_fwd"]
    errs[f"texture_warp_bwd {tag}"] = compare_bwd(
        torch, tk, smoke, f"{tag} per-sample texture", tex, uv, probs, K,
        EPS)
    numbers[f"{tag} keep w"] = kernel_numbers(
        torch, tk, fk, tex, uv, probs, w, K, EPS,
        ("texture_warp_topk_fwd", "texture_warp_bwd"), keep_w=True)
    del tex, uv, probs, w
    img, flow = flow_inputs(torch, 2, S, 5, dev)
    errs[f"flow_warp_fwd {S}px"] = smoke.check(
        f"flow_warp_fwd C=5 {S}px", float(
            (fk.flow_warp_fwd(img, flow)
             - fk.flow_warp_fwd_plain(img, flow)).abs().max()), FLOW_TOL)
    del img, flow
    torch.cuda.empty_cache()

    # ---- tiny steps card vs CPU with the options
    for tag, extra in (
            ("local+uv_refine", ["--netG", "local", "--n_blocks_local", "1",
                                 "--uv_refine", "1", "--uv_refine_ngf", "8"]),
            ("ms_uv+uv_refine+UVgrad", ["--ms_uv", "1", "--uv_refine", "1",
                                        "--uv_refine_ngf", "8",
                                        "--lambda_UVgrad", "100"]),
            ("symmetric+pool", ["--temporal_prev", "fake",
                                "--no_temporal_detach_prev",
                                "--pool_size", "4"])):
        tiny_step_card_vs_cpu(torch, smoke, dev, work, extra, tag)
    phase_s = time.perf_counter() - t_phase
    print(json.dumps({"options": {"runs": runs, "kernels": numbers,
                                  "max_abs_err": errs, "phase_s": phase_s,
                                  "card": smi}}), flush=True)
    shutil.rmtree(ck, ignore_errors=True)
    return {"runs": runs, "kernels": numbers, "errs": errs}


# phase 11: the serving artifact and the HTTP server, a JAX run's resume,
# pix2pixHD weight import
SERVE_BATCH = 8
SERVE_REQUESTS = 10
SERVER_START_S = 300      # a fresh server process: imports, load, warm-up
IMPORT_TOL = 1e-4         # of max|original|: 9 residual blocks in float32
ADAM_TOL = 1e-6           # the same Adam arithmetic on two devices
FIXTURE = os.path.join("neural_human_video_rendering_tpu_torch", "testdata",
                       "jax_resume_tiny")


def http_json(url, body=None, timeout=300):
    """GET (body None) or POST a JSON body; the decoded answer."""
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def decode_frames(answer):
    """A /render answer's base64 PNGs -> (N, S, S, 3) uint8 RGB (OpenCV's
    decoder where cv2 imports, else the port's)."""
    import base64

    import numpy as np
    from neural_human_video_rendering_tpu_torch.utils.image import (_cv2,
                                                                     decode_png)
    cv2 = _cv2()
    out = []
    for f in answer["frames"]:
        data = base64.b64decode(f)
        if cv2 is None:
            out.append(decode_png(data))
        else:
            bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
            out.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    return np.stack(out)


LADDER_REQUESTS, LADDER = 12, "1,4"


def bench_serve_path(smoke, repo, model, opt, gpu, joints, served, smi):
    """Phase 11: the program in a fresh server process (bench_serve's
    start_server: `python -m ...serve --port 0`), whose frames of `joints`
    must equal the in-process ones (`served`) bit for bit; then (e)
    bench_serve's ladder on it (concurrency LADDER, LADDER_REQUESTS
    requests each; joints of a synthetic driving sequence). Checks: a
    finite positive ladder, the server's exit 0 on SIGINT, its launches:
    the fused forward without w once a request and once for each warm-up
    (the server's and the ladder's), no other kernel. Numbers: the
    server's start-up s, the ladder, concurrency 4 over 1 (above 1 where
    the PNG encodes of concurrent requests overlap the device calls)."""
    import math

    import numpy as np
    from neural_human_video_rendering_tpu_torch import bench_serve
    kp = os.path.join(repo, "build", "chip_smoke", "serve", "keypoints")
    write_driving_sequence(opt, kp, SERVE_BATCH)
    t0 = time.perf_counter()
    srv, base = bench_serve.start_server(model, 0, gpu, SERVER_START_S)
    try:
        health = bench_serve.wait_healthy(srv, base)
        start_s = time.perf_counter() - t0
        print("[serve] fresh process: " + " | ".join(
            ln.rstrip() for ln in srv.lines[-4:]), flush=True)
        fresh = decode_frames(http_json(base + "/render",
                                        {"joints": joints.tolist()}))
        smoke.require("the fresh process's frames equal the in-process ones "
                      "bit for bit", np.array_equal(fresh, served))
        t0 = time.perf_counter()
        payload = bench_serve.driving_payload(kp, health["batch"],
                                              health["frame"][1])
        result = {"artifact": os.path.basename(model),
                  "batch": health["batch"],
                  "ladder": bench_serve.ladder(base, payload, health["batch"],
                                               LADDER_REQUESTS, LADDER),
                  "n_requests": LADDER_REQUESTS}
        ladder_s = time.perf_counter() - t0
    finally:
        server = bench_serve.stop_server(srv)
    ladder = result["ladder"]
    levels = LADDER.split(",")
    smoke.require(f"bench_serve: its JSON keys, frames/s finite and > 0 at "
                  f"concurrency {LADDER}",
                  list(ladder) == levels and result["batch"] == SERVE_BATCH
                  and all(math.isfinite(v) and v > 0 for v in ladder.values()),
                  json.dumps(result))
    smoke.require("bench_serve: the server exits 0 on SIGINT",
                  server["rc"] == 0, json.dumps(server))
    want = {**{k: 0 for k in REPLACES}, "texture_warp_topk_fwd":
            3 + LADDER_REQUESTS * len(levels)}
    smoke.require("the server process launched the fused forward without w "
                  "once a request and a warm-up, no other kernel",
                  server["launches"] == want, json.dumps(server))
    out = {**result, "server": server, "ladder_s": ladder_s,
           "concurrency_4_over_1": ladder[levels[-1]] / ladder[levels[0]]}
    print(f"[serve] bench_serve: {json.dumps(out)} | {smi}", flush=True)
    return {"fresh_server_start_s": start_s, "bench_serve": out}


def export_path(torch, smoke, tk, fk, repo, dev, smi):
    """Phase 11(a): the flagship exported at batch 8 (uint8, sidecar),
    served in process and by a fresh server process; the --warp_block_parts
    program with its weights baked in, saved, loaded and called once. Both
    program files stay for phase 16 (``programs``)."""
    import threading

    import numpy as np
    from neural_human_video_rendering_tpu_torch import export_serving as es
    from neural_human_video_rendering_tpu_torch import serve as srv
    from neural_human_video_rendering_tpu_torch.config import TestOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.infer import test_driver as td
    from neural_human_video_rendering_tpu_torch.models.renderer import (
        init_params, renderer_from_options)
    from neural_human_video_rendering_tpu_torch.train.steps import \
        make_forward_fn
    gpu = "0" if dev.type == "cuda" else "-1"
    work = os.path.join(repo, "build", "chip_smoke", "serve")
    os.makedirs(work, exist_ok=True)
    flags = FLAGSHIP + ["--gpu_ids", gpu, "--checkpoints_dir",
                        os.path.join(work, "ckpt"), "--name", "none"]
    opt = TestOptions().parse(flags, save=False)
    S, B = opt.train_size, SERVE_BATCH
    numbers = {}

    def reset():
        tk.reset_launch_counts()
        fk.reset_launch_counts()

    # ---- export and save, then load
    model = os.path.join(work, "flagship.pt2")
    t0 = time.perf_counter()
    es.save_artifact(opt, B, model, bake_weights=False, out_uint8=True,
                     device=dev)
    torch.cuda.synchronize()
    numbers["export_s"] = time.perf_counter() - t0
    numbers["program_bytes"] = os.path.getsize(model)
    numbers["sidecar_bytes"] = os.path.getsize(model + es.SIDECAR)
    t0 = time.perf_counter()
    loaded = torch.export.load(model)
    numbers["load_program_s"] = time.perf_counter() - t0
    warp = sorted(str(n.target) for n in loaded.graph.nodes
                  if "nhvr_torch" in str(n.target))
    smoke.require("exported graph: one nhvr_torch.texture_warp_topk_fwd "
                  "node, no other warp", warp == [
                      "nhvr_torch.texture_warp_topk_fwd.default"], str(warp))
    gathers = sum("gather" in str(n.target) for n in loaded.graph.nodes)
    smoke.require("exported graph: no plain warp (no gather)", gathers == 0,
                  f"({gathers} gathers)")
    del loaded
    smoke.require("program smaller than its sidecar",
                  numbers["program_bytes"] < numbers["sidecar_bytes"],
                  f"({numbers['program_bytes']} vs {numbers['sidecar_bytes']})")

    # ---- the live forward of the same weights and assets
    ds = dsm.SyntheticDataset(opt, length=B)
    joints = np.stack([ds[i]["joints"] for i in range(B)]).astype(np.float32)
    renderer = es.load_weights(opt, init_params(renderer_from_options(opt),
                                                opt.seed)).to(dev).eval()
    fwd = make_forward_fn(opt, renderer)
    assets = td.assets_to_device(opt, ds.texture_atlas(), ds.background(),
                                 dev)
    jb = torch.from_numpy(joints).to(dev)
    live = es.quantize(fwd(assets, jb)["fake"]).permute(0, 2, 3, 1).cpu()
    for _ in range(3):
        fwd(assets, jb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVE_REQUESTS):
        fwd(assets, jb)
    torch.cuda.synchronize()
    numbers["live_forward_ms"] = (time.perf_counter() - t0) * 1e3 \
        / SERVE_REQUESTS
    numbers["live_device_ms"] = trace_forward(
        torch, lambda: fwd(assets, jb))["device_busy_ms_per_call"]
    del renderer, fwd, assets

    # ---- served in process, on a thread
    reset()
    t0 = time.perf_counter()
    httpd = srv.serve(model, port=0, device=dev)
    numbers["server_start_s"] = time.perf_counter() - t0
    numbers["warmup_s"] = httpd.model.warmup_s
    numbers["load_s"] = httpd.model.load_s
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        health = http_json(url + "/healthz")
        smoke.require("healthz", health == {
            "status": "ok", "batch": B, "joints": [B, 18, 3],
            "frame": [B, S, S, 3]}, json.dumps(health))
        answers, launches = {}, {}
        for n in (B, 1):
            reset()
            answers[n] = http_json(url + "/render",
                                   {"joints": joints[:n].tolist()})
            torch.cuda.synchronize()
            launches[n] = launch_counts()
            smoke.require(f"a request of {n}: texture_warp_topk_fwd once, no "
                          "other kernel", launches[n] == {
                              **{k: 0 for k in REPLACES},
                              "texture_warp_topk_fwd": 1}, str(launches[n]))
        served = decode_frames(answers[B])
        smoke.require("served frames: 8 of SxSx3",
                      served.shape == (B, S, S, 3), str(served.shape))
        diff = np.abs(served.astype(np.int16) - live.numpy().astype(np.int16))
        numbers["served_vs_live_max_levels"] = int(diff.max())
        numbers["served_vs_live_pixels_off"] = int((diff > 0).sum())
        smoke.check("served frames vs the live forward (uint8 levels)",
                    float(diff.max()), 1.0)
        smoke.require("the request of 1 is the first frame of 8", np.array_equal(
            decode_frames(answers[1])[0], served[0]))
        lat = {}
        split = {k: [] for k in ("forward_s", "transfer_s", "png_s",
                                 "json_s")}
        for n in (B, 1):
            times = []
            for _ in range(SERVE_REQUESTS):
                t0 = time.perf_counter()
                http_json(url + "/render", {"joints": joints[:n].tolist()})
                times.append(time.perf_counter() - t0)
                if n == B:
                    for k in split:
                        split[k].append(httpd.model.timing[k])
            lat[n] = sorted(times)[len(times) // 2] * 1e3
        numbers["request_ms_median"] = {str(n): v for n, v in lat.items()}
        numbers["http_frames_per_s"] = B * 1e3 / lat[B]
        numbers["live_frames_per_s"] = B * 1e3 / numbers["live_forward_ms"]
        numbers["request_split_ms_median_n8"] = {
            k: sorted(v)[len(v) // 2] * 1e3 for k, v in split.items()}
        # the loaded program called directly (no HTTP, no thread): wall
        # time a batch and its device time (profiler)
        prog, params = httpd.model.module, httpd.model.params

        def call():
            with torch.no_grad():
                return prog(params, jb)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_REQUESTS):
            call()
        torch.cuda.synchronize()
        numbers["program_forward_ms"] = (time.perf_counter() - t0) * 1e3 \
            / SERVE_REQUESTS
        trace = trace_forward(torch, call)
        numbers["program_device_ms"] = trace["device_busy_ms_per_call"]
        numbers["program_top_kernels_ms"] = trace["top_kernels_ms_per_call"][:5]
    finally:
        httpd.shutdown()
        httpd.server_close()
    del httpd
    torch.cuda.empty_cache()

    # ---- the same program from a fresh server process (bench_serve's),
    # then (e) bench_serve's ladder on it
    numbers.update(bench_serve_path(smoke, repo, model, opt, gpu, joints,
                                    served, smi))

    # ---- --warp_block_parts 8, the weights baked in: top-k with the cap,
    # then the forward with w given
    opt_bp = TestOptions().parse(flags + ["--warp_block_parts", "8"],
                                 save=False)
    model_bp = os.path.join(work, "flagship_bp.pt2")
    es.save_artifact(opt_bp, B, model_bp, bake_weights=True, out_uint8=True,
                     device=dev)
    exported = torch.export.load(model_bp)
    ej = torch.from_numpy(joints).to(dev)
    warp = sorted(str(n.target) for n in exported.graph.nodes
                  if "nhvr_torch" in str(n.target))
    smoke.require("block_parts program: topk_select and texture_warp_fwd "
                  "nodes", warp == ["nhvr_torch.texture_warp_fwd.default",
                                    "nhvr_torch.topk_select.default"],
                  str(warp))
    module = exported.module()
    reset()
    with torch.no_grad():
        frames_bp = module(ej)
    torch.cuda.synchronize()
    bp_launches = launch_counts()
    smoke.require("block_parts program: topk_select and texture_warp_fwd "
                  "once, no other kernel", bp_launches == {
                      **{k: 0 for k in REPLACES}, "topk_select": 1,
                      "texture_warp_fwd": 1}, str(bp_launches))
    smoke.require("block_parts frames uint8 and not flat",
                  frames_bp.dtype == torch.uint8
                  and float(frames_bp.float().std()) > 1.0)
    del exported, module, frames_bp
    torch.cuda.empty_cache()
    numbers["launches"] = {"request_8": launches[B], "request_1": launches[1],
                           "block_parts_batch": bp_launches}
    # phase 16 serves both programs graphed, then removes them
    numbers["programs"] = {"sidecar": model, "block_parts_baked": model_bp,
                           "files": [model, model + es.SIDECAR, model_bp]}
    return numbers


def jax_resume_path(torch, smoke, repo, dev):
    """Phase 11(b): the committed JAX run dir (testdata/jax_resume_tiny:
    weights and latest_state.msgpack) resumed on the card and on the CPU;
    the optimizer states equal; one step each on the same batch."""
    import numpy as np
    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.train import drivers
    from neural_human_video_rendering_tpu_torch.train.state import \
        create_train_state
    from neural_human_video_rendering_tpu_torch.train.steps import \
        make_train_step
    work = os.path.join(repo, "build", "chip_smoke", "jax_resume")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(os.path.join(repo, FIXTURE), os.path.join(work, "run"))
    with open(os.path.join(work, "run", "flags.json")) as f:
        fx = json.load(f)
    spe = fx["steps_per_epoch"]
    states, metrics = {}, {}
    cpu = torch.device("cpu")
    for name, d in (("cpu", cpu), ("card", dev), ("cpu_same_grads", cpu)):
        opt = TrainOptions().parse(fx["argv"] + [
            "--gpu_ids", "0" if d.type == "cuda" else "-1",
            "--checkpoints_dir", work, "--name", "run", "--continue_train"],
            save=False)
        syn = dsm.SyntheticDataset(opt, length=4, seed=opt.seed)
        st = create_train_state(opt, linear_atlas(np, opt.n_parts,
                                                  opt.tex_tile),
                                syn.background(), steps_per_epoch=spe,
                                device=d)
        start = drivers.resume_train(opt, st, spe)
        smoke.require(f"JAX run resumed on the {name}: epoch "
                      f"{fx['epoch'] + 1}, step {fx['step']}",
                      start == fx["epoch"] + 1 and st.step == fx["step"],
                      f"(epoch {start}, step {st.step})")
        states[name] = st
    batch = dsm.collate([syn[i] for i in (1, 2)])
    cpu_st, card = states["cpu"], states["card"]

    def opt_tensors(st):
        out = {}
        for tag, o in (("g_opt", st.g_opt), ("d_opt", st.d_opt)):
            sd = o.state_dict()
            out[f"{tag}.count"] = torch.tensor([sd["count"],
                                                sd["freeze_count"]])
            for i, s in sd["state"].items():
                for k, v in s.items():
                    out[f"{tag}.{i}.{k}"] = v.detach().cpu()
        return out

    a, b = opt_tensors(cpu_st), opt_tensors(card)
    smoke.require("resumed optimizer state: the card's equals the CPU's",
                  a.keys() == b.keys() and len(a) > 2
                  and all(torch.equal(a[k], b[k]) for k in a),
                  f"({len(a)} tensors)")
    before = {tag: {k: v.detach().clone() for k, v in
                    getattr(cpu_st, m).state_dict().items()}
              for tag, m in (("G", "renderer"), ("D", "disc"))}
    for name in ("cpu", "card"):
        st = states[name]
        step = make_train_step(opt, st.renderer, st.disc, None, st.g_opt,
                               st.d_opt)
        metrics[name] = {k: float(v) for k, v in step(st, batch).items()}
    worst = max(abs(metrics["card"][k] - v) / max(abs(v), 1e-12)
                for k, v in metrics["cpu"].items())
    smoke.check("resumed step losses card vs cpu (relative)", worst,
                STEP_LOSS_RTOL)
    errs = {"losses_rel": worst}
    for tag, m in (("G", "renderer"), ("D", "disc")):
        mod_cpu, mod_card = getattr(cpu_st, m), getattr(card, m)
        # the gradients card vs CPU: the tiny steps' check (SGD(1) deltas
        # are the gradients). The parameter changes are Adam's of them,
        # held below on the same gradients: Adam scales a gradient's
        # rounding by lr (1 - beta1) / sqrt(v), so the changes' own
        # difference (printed) outgrows tolerances made for gradients.
        grads = {k: p.grad for k, p in mod_cpu.named_parameters()}
        scale = max(float(g.abs().max()) for g in grads.values())
        ratio, worst_k = 0.0, None
        for (k, g), (_, q) in zip(grads.items(), mod_card.named_parameters()):
            err = float((q.grad.cpu() - g).abs().max())
            tol = STEP_SCALE_TOL * scale + STEP_TENSOR_TOL * float(
                g.abs().max())
            if err / tol >= ratio:
                ratio, worst_k = err / tol, k
        diff, change = 0.0, 0.0
        for (k, p), q in zip(mod_cpu.named_parameters(),
                             mod_card.parameters()):
            diff = max(diff, float((q.detach().cpu() - p.detach()).abs().max()))
            change = max(change, float((p.detach() - before[tag][k])
                                       .abs().max()))
        print(f"[jax_resume] {tag} gradients card vs cpu: worst err/tol "
              f"{ratio:.3e} ({worst_k}); parameter changes card vs cpu: "
              f"max abs {diff:.3e} of max|change| {change:.3e}", flush=True)
        errs[f"{tag}_grads_err_over_tol"] = ratio
        errs[f"{tag}_changes_max_abs_diff"] = diff
        smoke.check(f"resumed step {tag} gradients card vs cpu (err/tol)",
                    ratio, 1.0)
        # every parameter: the CPU's resumed Adam on the card's gradients
        same = getattr(states["cpu_same_grads"], m)
        for p, q in zip(same.parameters(), mod_card.parameters()):
            p.grad = q.grad.detach().cpu().clone()
    states["cpu_same_grads"].g_opt.step()
    states["cpu_same_grads"].d_opt.step()
    worst_same = 0.0
    for m in ("renderer", "disc"):
        for (_, p), (_, q) in zip(
                getattr(states["cpu_same_grads"], m).named_parameters(),
                getattr(card, m).named_parameters()):
            worst_same = max(worst_same,
                             float((p.detach() - q.detach().cpu()).abs().max()))
    errs["adam_same_grads_max_abs"] = worst_same
    smoke.check("resumed Adam, the card's gradients: the card's step vs "
                "the CPU's, every parameter (max abs)", worst_same, ADAM_TOL)
    print(f"[jax_resume] losses {json.dumps(metrics)}", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return errs


def import_path(torch, smoke, repo, dev):
    """Phase 11(c): a random pix2pixHD GlobalGenerator at the flagship
    TransG's width (64/4/9, parity topology) imported through the CLI and
    run on the card against the torch original, float32."""
    from neural_human_video_rendering_tpu_torch import \
        import_torch_checkpoint as itc
    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.models.renderer import (
        init_params, renderer_from_options)
    from neural_human_video_rendering_tpu_torch.utils import checkpoint as ckpt
    from neural_human_video_rendering_tpu_torch.utils.torch_import import \
        pix2pixhd_global_generator
    work = os.path.join(repo, "build", "chip_smoke", "import")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    flags = FLAGSHIP + ["--gpu_ids", "0" if dev.type == "cuda" else "-1"]
    opt = TrainOptions().parse(flags, save=False)
    torch.manual_seed(0)
    ref = pix2pixhd_global_generator(opt.pose_nc, opt.transg_out_nc, opt.ngf,
                                     opt.n_downsample_translate,
                                     opt.n_blocks_translate, final_tanh=False)
    src = os.path.join(work, "30_net_TransG.pth")
    torch.save(ref.state_dict(), src)
    t0 = time.perf_counter()
    rc = itc.main([src, "--label", "TransG", "--epoch", "30", "--out_dir",
                   os.path.join(work, "out")] + flags)
    import_s = time.perf_counter() - t0
    smoke.require("import_torch_checkpoint wrote the TransG", rc == 0 and
                  ckpt.find_net(os.path.join(work, "out"), "TransG", 30)
                  is not None)
    popt = itc.parity_options(TrainOptions().parse(flags + [
        "--dtype", "float32"], save=False))
    transg = init_params(renderer_from_options(popt).TransG, 1)
    ckpt.load_net_into(transg, os.path.join(work, "out"), "TransG", 30)
    transg, ref = transg.to(dev).eval(), ref.to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((1, opt.pose_nc, opt.train_size, opt.train_size),
                    generator=g, device=dev)
    with torch.no_grad():
        want = ref(x)
        got = transg.backbone(x)
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-12)
    smoke.check("imported TransG 64/4/9 vs the pix2pixHD original on the "
                "card (relative to max|original|)", err, IMPORT_TOL)
    del transg, ref, x, want, got
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"import_s": import_s, "max_err_rel": err}


def serving_path(torch, smoke, tk, fk, repo, dev, smi):
    """Phase 11: (a) export_path, (b) jax_resume_path, (c) import_path."""
    t_phase = time.perf_counter()
    numbers = export_path(torch, smoke, tk, fk, repo, dev, smi)
    numbers["jax_resume"] = jax_resume_path(torch, smoke, repo, dev)
    numbers["import"] = import_path(torch, smoke, repo, dev)
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"serving": numbers, "card": smi}), flush=True)
    return numbers


# phase 12: data parallel over ranks (two ranks share the one card)
PAR_ADAM = 2              # (a): Adam steps before the ranks' checksums
PAR_FRAMES = 6            # (b): 3 steps an epoch at global batch 2
PAR_NCCL_FRAMES = 6       # (c): 3 steps
PAR_INFER = 16            # (d): two batches of 8
PAR_ONE, PAR_TWO = "--gpu_ids=0", "--gpu_ids=0,0"     # one rank, two ranks
# (a): float32, all parts blended, no VGG (bf16 in both), a linear atlas
# with TexG's head at 0 (parallel/selfcheck.py)
PAR_EXACT = ("--dtype float32 --warp_topk 24 --warp_eps 0 "
             "--no_vgg_loss").split()
PAR_LOSS_RTOL = 1e-4
# the parity tests' form (_assert_deltas): the reference runs the ranks'
# own shapes (selfcheck.thread_ranks), so only the order of the final
# gradient sums differs
PAR_SCALE_TOL, PAR_TENSOR_TOL = 1e-5, 1e-4
STAGE2_KEYS = ["D_total", "G_FM", "G_GAN", "G_L2", "G_Mask", "G_Prob",
               "G_Temp", "G_UV", "G_VGG", "G_total"]
LOSS_LINE = re.compile(r"^\(epoch: (\d+), iters: (-?\d+), time: ([0-9.]+)\) "
                       r"(.*)$")


def fd_captured(fn, *args, **kw):
    """fn(*args, **kw) with file descriptor 1 sent to a file, so the ranks
    it spawns (which inherit it) are captured too; returns (its result,
    the text), the text echoed."""
    import tempfile
    sys.stdout.flush()
    with tempfile.TemporaryFile(mode="w+") as f:
        saved = os.dup(1)
        os.dup2(f.fileno(), 1)
        try:
            res = fn(*args, **kw)
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
        f.seek(0)
        text = f.read()
    print(text, end="", flush=True)
    return res, text


def loss_lines(text):
    """The loss lines of a run's log: [(epoch, it, seconds, {key: value})]."""
    out = []
    for ln in text.splitlines():
        m = LOSS_LINE.match(ln.strip())
        if m:
            vals = {k: float(v) for k, v in
                    re.findall(r"(\w+): (\S+)", m.group(4))}
            out.append((int(m.group(1)), int(m.group(2)),
                        float(m.group(3)), vals))
    return out


def rank_launches(text):
    """{rank: launches} from the ranks' '[kernels] rank r of w ...' prints
    (two processes' prints may share a line of the log)."""
    return {int(m.group(1)): json.loads(m.group(2)) for m in re.finditer(
        r"\[kernels\] rank (\d+) of \d+ [^\[]*?launches since the "
        r"counters' reset: (\{[^}]*\})", text)}


def parallel_parity(torch, smoke, work, dev):
    """Phase 12 (a): the flagship widths in float32, SGD(1), one global
    batch of 2: two ranks of one sample over gloo against the same two
    ranks run as threads of this process (selfcheck.thread_ranks: each
    rank's own shapes, so only the order of the final gradient sums
    differs), the ranks on make_train_step's graphed route and the threads
    eager, at the parity tests' form (PAR_SCALE_TOL), each rank with no
    caught out-of-memory error; then the ranks' parameters, Adam moments
    and EMA bit-equal after PAR_ADAM Adam steps."""
    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.parallel import selfcheck as sc
    from neural_human_video_rendering_tpu_torch.runtime import launch
    t0 = time.perf_counter()
    o2 = TrainOptions().parse(TRAIN + PAR_EXACT + [PAR_TWO], save=False)
    syn = dsm.SyntheticDataset(o2, length=12, seed=o2.seed)
    batch = dsm.collate([syn[i] for i in (1, 11)])
    atlas = sc.linear_atlas(o2.n_parts, o2.tex_tile)
    one_dir, two_dir = os.path.join(work, "a_one"), os.path.join(work, "a_two")
    sc.thread_ranks(o2, batch, atlas, syn.background(), one_dir, PAR_ADAM,
                    2, dev)
    torch.cuda.empty_cache()
    # the ranks take the route trainers run (a CUDA graph each); the
    # threads stay eager (two threads cannot capture at once)
    _, out_a = fd_captured(launch, sc.rank_step, o2, batch, atlas,
                           syn.background(), two_dir, PAR_ADAM, where=work,
                           batch=o2.batchSize)
    got = sc.compare(one_dir, two_dir, PAR_SCALE_TOL, PAR_TENSOR_TOL)
    print(f"[parallel] (a) {json.dumps(got)}", flush=True)
    for r, alloc in enumerate(got["allocator"]):
        alloc = alloc or {"num_ooms": None, "max_reserved_bytes": 0,
                          "capture": None}       # None: not on a card
        cap = alloc["capture"] or {}
        print(f"[parallel] (a) rank {r}: num_ooms {alloc['num_ooms']} "
              f"(capture {cap.get('num_ooms')}), peak reserved "
              f"{alloc['max_reserved_bytes'] / 1e9:.2f} GB", flush=True)
        smoke.require(f"(a) rank {r} graphed, no caught out-of-memory error",
                      alloc["capture"] is not None
                      and alloc["num_ooms"] == 0, json.dumps(alloc))
    smoke.require("(a) two ranks on cuda:0 over gloo",
                  "rank 1 of 2 on cuda:0 (gloo)" in out_a
                  and "NCCL refuses" in out_a)
    smoke.require("(a) two rank files, the same loss keys",
                  got["n_rank_files"] == 2 and got["same_loss_keys"])
    smoke.check("(a) step-1 losses 2 ranks vs 2 threads (relative)",
                got["loss_max_rel"], PAR_LOSS_RTOL)
    for m, r in got["delta_ratio"].items():
        smoke.check(f"(a) {m} changes 2 ranks vs 2 threads (err/tol, worst "
                    f"at {r['tensor']})", r["ratio"], 1.0)
    smoke.require(f"(a) ranks bit-equal after {PAR_ADAM} Adam steps "
                  "(parameters, moments, EMA)", got["ranks_bit_equal"],
                  json.dumps(got["checksums"]))
    return {**got, "s": time.perf_counter() - t0}


def parallel_path(torch, smoke, tk, fk, repo, dev, smi):
    """Phase 12: data parallel (parallel/mesh.py, runtime.py). Two ranks
    share cuda:0 through --gpu_ids 0,0 over gloo (NCCL refuses two ranks
    on one card); a world of 1 under torchrun runs NCCL. Their times are
    two processes time-sharing one card: no scaling number.
      (a) parallel_parity: two ranks of one sample against the same two
          ranks run as threads of this process, then the ranks bit-equal
          after PAR_ADAM Adam steps;
      (b) the flagship recipe (bf16) through run_train on a corpus of 6
          frames, 3 steps on two ranks: the loss keys, finite losses, one
          metrics.jsonl writer, the epoch's checkpoints, each rank's
          launches (one fused forward keeping w, one backward, one flow
          warp a step); then --continue_train on one rank from the
          two-rank save (epoch 2 at step 5), its launches and step ms;
      (c) the same run under torchrun at world 1 (NCCL), 3 steps;
      (d) run_inference of 16 frames at batch 8 on two ranks against one
          rank, in float32 with all parts blended (a top-k choice among
          near-equal random-init probabilities flips on the rounding of
          another batch split: ROADMAP hazard 3): the frames within 1
          uint8 level, each rank's fused forwards equal to one rank's (one
          a batch), one HTML;
      (e) profile_step at the flagship (tile 64): the top rows and the
          step's device busy share."""
    import numpy as np
    from neural_human_video_rendering_tpu_torch import profile_step
    from neural_human_video_rendering_tpu_torch.config import (TestOptions,
                                                               TrainOptions)
    from neural_human_video_rendering_tpu_torch.infer import test_driver as td
    from neural_human_video_rendering_tpu_torch.train import drivers
    from neural_human_video_rendering_tpu_torch.utils.image import read_png
    t_phase = time.perf_counter()
    work = os.path.join(repo, "build", "chip_smoke", "parallel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    numbers = {}
    per_step = {k: TRAIN_LAUNCHES_PER_STEP.get(k, 0) for k in REPLACES}

    # ---- (a) parity at the flagship widths
    numbers["a"] = parallel_parity(torch, smoke, work, dev)
    torch.cuda.empty_cache()

    # ---- (b) the flagship recipe through run_train on two ranks
    t0 = time.perf_counter()
    ob = TrainOptions().parse(TRAIN + [PAR_ONE], save=False)
    root = os.path.join(work, "corpus")
    d = write_corpus(ob, root, PAR_FRAMES)
    ck = os.path.join(work, "ckpt")
    data = ["--pose_path", d["openpose_json"], "--img_path", d["frames"],
            "--mask_path", d["mask"], "--densepose_path", d["densepose"],
            "--flow_path", d["flow"], "--flow_inv_path", d["flow_inv"],
            "--bg_path", os.path.join(root, "bg.png"), "--texture_path",
            os.path.join(root, "texture.png"), "--checkpoints_dir", ck,
            "--no_decay", "--save_latest_freq", "0"]
    b_argv = TRAIN + data + ["--name", "dp2"]
    _, out_b = fd_captured(drivers.run_train, TrainOptions().parse(
        b_argv + ["--niter", "1", PAR_TWO]))
    lines = loss_lines(out_b)
    launches_b = rank_launches(out_b)
    run_dir = os.path.join(ck, "dp2")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    steps_b = PAR_FRAMES // 2
    smoke.require("(b) two ranks on cuda:0 over gloo",
                  "rank 1 of 2 on cuda:0 (gloo)" in out_b)
    smoke.require(f"(b) {steps_b} loss lines with the stage-2 keys, finite",
                  len(lines) == steps_b and all(
                      sorted(v) == STAGE2_KEYS and np.isfinite(
                          list(v.values())).all() for *_, v in lines),
                  str([sorted(v) for *_, v in lines][:1]))
    smoke.require("(b) one metrics.jsonl writer",
                  [r["it"] for r in recs] == list(range(steps_b)),
                  str([r["it"] for r in recs]))
    smoke.require("(b) the epoch's checkpoints", all(os.path.isfile(
        os.path.join(run_dir, f)) for f in ("1_net_G.pth", "1_net_D.pth",
                                            "1_net_G_ema.pth",
                                            "latest_state.pth")))
    want = {k: v * steps_b for k, v in per_step.items()}
    smoke.require("(b) each rank launched the fused forward, the backward "
                  "and the flow warp once a step",
                  sorted(launches_b) == [0, 1] and all(
                      launches_b[r] == want for r in launches_b),
                  f"({launches_b}, want {want} each)")
    two_ms = [t * 1e3 for _, _, t, _ in lines]
    # --continue_train on one rank from the two-rank save
    tk.reset_launch_counts()
    fk.reset_launch_counts()
    st1, out_r = fd_captured(drivers.run_train, TrainOptions().parse(
        b_argv + ["--niter", "2", PAR_ONE, "--continue_train"]))
    torch.cuda.synchronize()
    one_launch = launch_counts()
    smoke.require("(b) one rank resumes the two-rank save at epoch 2, "
                  f"step {steps_b}", st1 is not None and st1.start_epoch == 2
                  and st1.step == 2 * steps_b
                  and f"resumed at epoch 2 (step {steps_b}" in out_r)
    smoke.require("(b) one rank's launches a step equal each rank's",
                  one_launch == want, f"({one_launch}, want {want})")
    one_ms = [t * 1e3 for t in st1.step_seconds]
    numbers["b"] = {
        "steps": steps_b, "launches_ranks": launches_b,
        "launches_one_rank": one_launch,
        "two_ranks_ms_between_loss_lines": two_ms,
        "one_rank_step_ms": one_ms,
        "two_ranks_median_ms": float(np.median(two_ms[1:])),
        "one_rank_median_ms": float(np.median(one_ms[1:])),
        "s": time.perf_counter() - t0}
    print(f"[parallel] (b) flagship step, 2 ranks time-sharing one card: "
          f"median {numbers['b']['two_ranks_median_ms']:.2f} ms (loss-line "
          f"interval, global batch 2) against 1 rank "
          f"{numbers['b']['one_rank_median_ms']:.2f} ms ({smi}); no scaling "
          "number", flush=True)
    del st1
    torch.cuda.empty_cache()

    # ---- (c) torchrun, world 1, NCCL
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m",
           "neural_human_video_rendering_tpu_torch.train", *b_argv,
           "--name", "nccl1", "--niter", "1", PAR_ONE,
           "--max_dataset_size", str(PAR_NCCL_FRAMES)]
    proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                          timeout=600)
    print(proc.stdout[-3000:], proc.stderr[-3000:], sep="\n", flush=True)
    lines_c = loss_lines(proc.stdout)
    smoke.require("(c) torchrun world 1: exit 0, backend nccl, 3 finite "
                  "loss lines", proc.returncode == 0
                  and "rank 0 of 1 on cuda:0 (nccl)" in proc.stdout
                  and len(lines_c) == PAR_NCCL_FRAMES // 2 and all(
                      np.isfinite(list(v.values())).all()
                      for *_, v in lines_c),
                  f"(rc {proc.returncode}, {len(lines_c)} lines)")
    numbers["c"] = {"rc": proc.returncode,
                    "ms_between_loss_lines": [t * 1e3 for _, _, t, _ in
                                              lines_c],
                    "s": time.perf_counter() - t0}

    # ---- (d) sharded inference
    t0 = time.perf_counter()
    kp_dir = os.path.join(work, "keypoints")

    def infer_opt(res, gpu):
        return TestOptions().parse(FLAGSHIP + PAR_EXACT + [
            "--pose_path", kp_dir, "--results_dir", os.path.join(work, res),
            "--checkpoints_dir", os.path.join(work, "none"), "--name", "x",
            gpu], save=False)
    io1 = infer_opt("res_one", PAR_ONE)
    syn = write_driving_sequence(io1, kp_dir, PAR_INFER)
    assets = (syn.texture_atlas(), syn.background())
    tk.reset_launch_counts()
    fk.reset_launch_counts()
    n1, out_1 = fd_captured(td.run_inference, io1, assets=assets)
    torch.cuda.synchronize()
    launch_1 = launch_counts()
    _, out_2 = fd_captured(td.run_inference, infer_opt("res_two", PAR_TWO),
                           assets=assets)
    launch_2 = rank_launches(out_2)

    def secs(text):
        m = re.search(r"\[infer\] wrote (\d+) frames -> .* \(([0-9.]+) s,",
                      text)
        return (int(m.group(1)), float(m.group(2))) if m else (0, None)
    frames = {}
    for tag in ("res_one", "res_two"):
        img_dir = os.path.join(work, tag, "images")
        frames[tag] = {f: read_png(os.path.join(img_dir, f)).astype(int)
                       for f in sorted(os.listdir(img_dir))}
    diff = max((int(np.abs(frames["res_one"][f] - frames["res_two"][f]).max())
                for f in frames["res_one"] if f in frames["res_two"]),
               default=999)
    smoke.require(f"(d) {PAR_INFER} frames on one rank and on two",
                  n1 == PAR_INFER and secs(out_2)[0] == PAR_INFER
                  and sorted(frames["res_one"]) == sorted(frames["res_two"])
                  and len(frames["res_one"]) == PAR_INFER)
    smoke.check("(d) two ranks' frames vs one rank's (uint8 levels)", diff,
                1)
    smoke.require("(d) each rank's fused forwards equal one rank's (one a "
                  "batch of 8)", sorted(launch_2) == [0, 1] and all(
                      launch_2[r] == launch_1 for r in launch_2)
                  and launch_1["texture_warp_topk_fwd"] == PAR_INFER // 8,
                  f"({launch_2}, one rank {launch_1})")
    smoke.require("(d) one HTML gallery", os.path.isfile(
        os.path.join(work, "res_two", "index.html")))
    numbers["d"] = {"one_rank_s": secs(out_1)[1], "two_ranks_s": secs(out_2)[1],
                    "launches_ranks": launch_2, "launches_one_rank": launch_1,
                    "max_level_diff": diff, "s": time.perf_counter() - t0}
    print(f"[parallel] (d) run_inference of {PAR_INFER} frames at batch 8: "
          f"2 ranks time-sharing one card {numbers['d']['two_ranks_s']} s "
          f"against 1 rank {numbers['d']['one_rank_s']} s ({smi}); no "
          "scaling number", flush=True)

    # ---- (e) profile_step
    t0 = time.perf_counter()
    _, out_e = fd_captured(profile_step.main, [
        "--steps", "2", "--tex_tile", "64", "--top", "12", PAR_ONE, "--out",
        os.path.join(work, "profile")])
    prof = json.loads([ln for ln in out_e.splitlines()
                       if ln.startswith("{")][-1])
    smoke.require("(e) profile_step: CUDA kernels attributed to the port's "
                  "lines, rows summing to the kernels' time",
                  prof["events"] == "cuda kernels" and 0 < prof["busy_share"]
                  <= 1 and abs(prof["rows_ms_total"] - prof.get(
                      "device_ms_per_step", -1) * prof["steps"]) < 1e-6 * max(
                      1.0, prof["rows_ms_total"]) and all(
                      r["frame"].startswith(profile_step.PACKAGE)
                      or r["frame"] == profile_step.NO_FRAME
                      for r in prof["rows"]))
    numbers["e"] = {k: v for k, v in prof.items() if k != "rows"}
    numbers["e"]["top"] = prof["rows"][:8]
    numbers["e"]["s"] = time.perf_counter() - t0
    shutil.rmtree(os.path.join(work, "profile"), ignore_errors=True)
    shutil.rmtree(ck, ignore_errors=True)
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"parallel": numbers, "card": smi}), flush=True)
    return numbers


# phase 13: the tools (bench_trained_regime, noisy_gt_ab + noisyab_anatomy,
# arm_ab64)
TR_WINDOWS, TR_STEPS = 4, 15
AB_FRAMES = 12            # --data_ratio 0.9: 1 held-out frame
AB64_FRAMES = 24
BENCH_STEP_LAUNCHES = {"topk_select": 0, "texture_warp_fwd": 0,
                       "texture_warp_topk_fwd": 2, "texture_warp_bwd": 1,
                       "flow_warp_fwd": 1}


def trained_regime_path(torch, smoke, tk, fk, dev, smi):
    """Phase 13 (a): bench_trained_regime.run at bench.bench_options (512
    px, batch 2, tile 128, bf16), TR_WINDOWS windows of TR_STEPS steps.
    Checks: G_Prob lower in the last window than in the first; each
    window's launches the bench step's (BENCH_STEP_LAUNCHES a step; the
    first window also holds the untimed first step). Numbers: each
    window's steps/s and G_Prob, and on the first and last windows'
    renderer tensors (the step's forward after the window) the fused
    forward keeping w and the backward by CUDA-graph replay, with the
    selected (pixel, part) pairs."""
    from neural_human_video_rendering_tpu_torch import bench
    from neural_human_video_rendering_tpu_torch import \
        bench_trained_regime as btr
    from neural_human_video_rendering_tpu_torch.data.wire import unpack_batch
    from neural_human_video_rendering_tpu_torch.ops import texture_warp as ttw
    from neural_human_video_rendering_tpu_torch.train.steps import \
        pose_from_batch
    opt = bench.bench_options(128, "bfloat16", "0")
    K, EPS = opt.warp_topk, opt.warp_eps
    per_window, tensors = [], {}

    def on_window(wi, state, batch):
        torch.cuda.synchronize()
        per_window.append(launch_counts())
        tk.reset_launch_counts()
        fk.reset_launch_counts()
        if wi not in (0, TR_WINDOWS - 1):
            return
        with torch.no_grad():
            b = unpack_batch(batch, dev)
            outs = state.renderer(pose_from_batch(opt, b), state.bg[None],
                                  state.static_tex[None], state.tex_mask)
            tex, fg, u, v = ttw._operands(outs["texture"], outs["uv"],
                                          outs["probs"], opt.warp_dtype)
            w = tk.topk_select(fg, K, 0, EPS)
            g = torch.randn((tex.shape[0], tex.shape[2], fg.shape[2]),
                            device=dev,
                            generator=torch.Generator(device=dev).manual_seed(9))
        tensors[wi] = {
            "fused_keep_w_ms": graph_ms(torch, lambda: tk.texture_warp_topk_fwd(
                tex, fg, u, v, K, EPS, return_w=True)),
            "fused_no_w_ms": graph_ms(torch, lambda: tk.texture_warp_topk_fwd(
                tex, fg, u, v, K, EPS)),
            "bwd_ms": graph_ms(torch, lambda: tk.texture_warp_bwd(
                tex, u, v, w, g)),
            "selected": int((w > 0).sum()),
            "selected_per_part_max": int((w > 0).sum(2).max())}
        tk.reset_launch_counts()
        fk.reset_launch_counts()

    torch.cuda.synchronize()
    tk.reset_launch_counts()
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    summary, lines = btr.run(opt, dev, TR_WINDOWS, TR_STEPS, on_window)
    secs = time.perf_counter() - t0
    probs = [x["G_Prob"] for x in lines]
    smoke.require("bench_trained_regime: G_Prob lower in the last window "
                  "than in the first", probs[-1] < probs[0], str(probs))
    want = [{k: v * (TR_STEPS + (wi == 0)) for k, v in
             BENCH_STEP_LAUNCHES.items()} for wi in range(TR_WINDOWS)]
    smoke.require("bench_trained_regime: a step launches the bench step's "
                  "kernels (2 fused forwards: w kept, and the t-1 render "
                  "without; the backward; the flow warp)",
                  per_window == want, json.dumps(per_window))
    out = {"summary": summary, "windows": lines, "s": secs,
           "renderer_tensors": {"first": tensors[0],
                                "last": tensors[TR_WINDOWS - 1]},
           "launches": {k: sum(x[k] for x in per_window) for k in REPLACES}}
    print(f"[tools] bench_trained_regime ({TR_WINDOWS} x {TR_STEPS} steps): "
          f"{json.dumps(out)} | {smi}", flush=True)
    return out


def stage2_launches(log_path):
    """The '[kernels] launches ...' lines of the stage-2 runs in a tool's
    run.log, in order."""
    with open(log_path) as f:
        return [json.loads(ln.split(": ", 1)[1]) for ln in f
                if ln.startswith("[kernels] launches")]


def ab_tools_path(torch, smoke, repo, work, smi):
    """Phase 13 (b) and (c): noisy_gt_ab at SIZES_FULL (512 px, tile 64; a
    subprocess: the arms' stages, then its --skip_train scoring) on
    AB_FRAMES frames, 1 pre-epoch and 1 epoch, --how_many 4; arm_ab64 (64
    px, --limb_coords, 1 + 1 epochs) in a subprocess beside it; then
    noisyab_anatomy on noisy_gt_ab's dir in this process. Checks: every
    summary number finite, IoUs in [0, 1], each arm's anchor_epoch equal
    to --epochs, every stage-2 run's launches (2 fused forwards, the
    backward and the flow warp a step, a fused forward a held-out batch),
    the anatomy's keys and finite values."""
    import math
    from neural_human_video_rendering_tpu_torch import noisyab_anatomy
    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    pkg = "neural_human_video_rendering_tpu_torch"
    ab, a64 = os.path.join(work, "noisy_gt_ab"), os.path.join(work, "ab64")
    kp, kp64 = os.path.join(work, "kp512"), os.path.join(work, "kp64")
    write_driving_sequence(TrainOptions().parse(TRAIN, save=False), kp,
                           AB_FRAMES)
    write_driving_sequence(TrainOptions().parse(TRAIN + ["--loadSize", "64"],
                                                save=False), kp64, AB64_FRAMES)
    os.makedirs(a64, exist_ok=True)
    numbers = {}
    t0 = time.perf_counter()
    with open(os.path.join(work, "arm_ab64.log"), "w") as log64:
        side = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.arm_ab64", "--name", "limb_coords",
             "--arm_flags=--limb_coords", "--arm_kw",
             '{"limb_coords": true}', "--out", os.path.join(a64, "limb.json"),
             "--keypoints", kp64, "--epochs", "1", "--pre_epochs", "1",
             "--how_many", "4", "--gpu_ids", "0", "--work", a64],
            stdout=log64, stderr=subprocess.STDOUT, cwd=repo)
        try:
            r = subprocess.run(
                [sys.executable, "-m", f"{pkg}.noisy_gt_ab", "--out", ab,
                 "--keypoints", kp, "--epochs", "1", "--pre_epochs", "1",
                 "--how_many", "4", "--gpu_ids", "0"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                cwd=repo)
            numbers["noisy_gt_ab_s"] = time.perf_counter() - t0
            rc64 = side.wait(timeout=900)
        finally:
            if side.poll() is None:
                side.kill()
                side.wait()
    numbers["arm_ab64_s"] = time.perf_counter() - t0
    print(r.stdout[-3000:], flush=True)
    with open(os.path.join(work, "arm_ab64.log")) as f:
        print(f.read()[-3000:], flush=True)
    smoke.require("noisy_gt_ab exits 0", r.returncode == 0)
    smoke.require("arm_ab64 exits 0", rc64 == 0)
    if r.returncode != 0 or rc64 != 0:
        return numbers
    with open(os.path.join(ab, "noisy_gt_ab.json")) as f:
        nab = json.load(f)
    with open(os.path.join(a64, "limb.json")) as f:
        lever = json.load(f)
    numbers.update(noisy_gt_ab=nab, arm_ab64=lever)
    for arm in ("clean", "noisy"):
        m = nab[arm]
        smoke.require(f"noisy_gt_ab {arm}: finite, IoUs in [0, 1], "
                      "anchor_epoch 1 (= --epochs)",
                      all(math.isfinite(v) for k, v in m.items()
                          if k != "anchor_epoch")
                      and all(0.0 <= m[k] <= 1.0 for k in m if "IoU" in k)
                      and m["anchor_epoch"] == 1 and m["held_out_frames"] > 0,
                      json.dumps(m))
    smoke.require("arm_ab64: both arms finite, anchor_epoch 1",
                  all(math.isfinite(v) for arm in ("base", "limb_coords")
                      for k, v in lever[arm].items() if k != "anchor_epoch")
                  and all(lever[arm]["anchor_epoch"] == 1
                          for arm in ("base", "limb_coords"))
                  and math.isfinite(lever["delta_PSNR"]), json.dumps(lever))
    # every stage-2 run: 2 fused forwards (t and the t-1 render), the
    # backward and the flow warp a step; a fused forward a held-out batch
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    launches = {}
    for name, log, data, runs in (
            ("noisy_gt_ab", os.path.join(ab, "run.log"),
             os.path.join(ab, "clean"),
             [os.path.join(ab, f"ckpt_{a}", "e2e") for a in ("clean",
                                                            "noisy")]),
            ("arm_ab64", os.path.join(a64, "run.log"),
             os.path.join(a64, "data"),
             [os.path.join(a64, f"ckpt_{a}", "e2e") for a in (
                 "base", "limb_coords")])):
        logged = stage2_launches(log)
        held = len(dsm.FrameDataset(TrainOptions().parse(
            ["--img_path", os.path.join(data, "frames"), "--data_ratio",
             "0.9", "--no_flip"], save=False), "test"))
        want = []
        for run in runs:
            with open(os.path.join(run, "metrics.jsonl")) as f:
                recs = [json.loads(ln) for ln in f if ln.strip()]
            steps = max(x["step"] for x in recs)
            evals = sum(1 for x in recs if "val_PSNR" in x)
            want.append({"topk_select": 0, "texture_warp_fwd": 0,
                         "texture_warp_topk_fwd": 2 * steps
                         + evals * -(-held // 2),
                         "texture_warp_bwd": steps, "flow_warp_fwd": steps})
        smoke.require(f"{name}: each stage-2 run's launches (2 fused forwards, "
                      "the backward, the flow warp a step; a fused forward a "
                      "held-out batch)", logged == want,
                      f"{json.dumps(logged)} vs {json.dumps(want)}")
        launches[name] = logged
    numbers["launches"] = launches
    # the anatomy of noisy_gt_ab's dir, in this process
    t0 = time.perf_counter()
    tk_counts = launch_counts()
    rc = noisyab_anatomy.main(["--ab", ab, "--size", "512", "--tile", "64",
                               "--n_eval", "4", "--gpu_ids", "0", "--out",
                               os.path.join(work, "anatomy.json")])
    torch.cuda.synchronize()
    numbers["anatomy_s"] = time.perf_counter() - t0
    numbers["anatomy_launches"] = {k: v - tk_counts[k]
                                   for k, v in launch_counts().items()}
    with open(os.path.join(work, "anatomy.json")) as f:
        anatomy = json.load(f)
    numbers["anatomy"] = anatomy
    smoke.require("noisyab_anatomy: both arms, saved epochs 1 and latest, "
                  "finite values, the three SSIM zones",
                  rc == 0 and sorted(anatomy) == ["clean", "noisy"] and all(
                      sorted(a["epochs"]) == ["1", "latest"]
                      and all(math.isfinite(v) for e in a["epochs"].values()
                              for v in e.values())
                      and sorted(a["ssim_zones_latest"]) == [
                          "background", "edge", "interior"]
                      for a in anatomy.values()), json.dumps(anatomy))
    print(f"[tools] noisy_gt_ab (SIZES_FULL 512 px tile 64, {AB_FRAMES} "
          f"frames, 1 + 1 epochs): {json.dumps(nab)}; arm_ab64 (64 px, "
          f"limb_coords, 1 + 1 epochs): {json.dumps(lever)}; anatomy: "
          f"{json.dumps(anatomy)} | {smi}", flush=True)
    return numbers


def tools_path(torch, smoke, tk, fk, repo, dev, smi):
    """Phase 13: (a) trained_regime_path, (b) + (c) ab_tools_path. Returns
    the numbers with the launches of each tool's main path."""
    t_phase = time.perf_counter()
    work = os.path.join(repo, "build", "chip_smoke", "tools")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    numbers = {"trained_regime": trained_regime_path(torch, smoke, tk, fk,
                                                     dev, smi)}
    torch.cuda.empty_cache()
    numbers["ab"] = ab_tools_path(torch, smoke, repo, work, smi)
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"tools": {k: v for k, v in numbers.items()},
                      "card": smi}), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return numbers


# phase 14: the native decode/prefetch runtime (data/native_loader.py +
# native/loader.cpp) and the stage-2 path reading its files through it
NATIVE_FRAMES = 8         # batch 2: 4 stage-2 steps an epoch
NATIVE_SRC = 1024         # the corpus's frames, masks and IUV
NATIVE_S = 512            # ... read at the flagship's loadSize
BG_W, BG_H = 1920, 1080   # the background JPEG: a non-integer ratio to 512
NATIVE_ULP = 1            # decode_image against decode_image_plain
NATIVE_NOTE = "[data] native loader unavailable:"


class _Tee:
    """A text stream that keeps what is written to it and passes it on."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, s):
        self.parts.append(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()

    def __getattr__(self, name):
        return getattr(self.stream, name)


def host_headers(gxx):
    """{header: whether g++ finds it} for the loader's two headers."""
    found = {}
    for h in ("png.h", "jpeglib.h"):
        found[h] = gxx is not None and subprocess.run(
            [gxx, "-E", "-x", "c++", "-", "-o", os.devnull],
            input=f"#include <{h}>\n", capture_output=True,
            text=True).returncode == 0
    return found


def max_ulp(a, b):
    """The largest difference of two float32 arrays in units in the last
    place of the second (0 where equal)."""
    import numpy as np
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return float((d / np.spacing(np.abs(b)).astype(np.float64)).max())


def native_corpus(opt, root):
    """write_corpus at NATIVE_SRC px (NATIVE_FRAMES frames) plus bg.jpg, a
    BG_W x BG_H JPEG of the corpus's background stretched with OpenCV."""
    import cv2
    import numpy as np
    from neural_human_video_rendering_tpu_torch.data.dataset import \
        SyntheticDataset
    from neural_human_video_rendering_tpu_torch.utils.image import to_uint8
    d = write_corpus(opt, root, NATIVE_FRAMES)
    bg = to_uint8(SyntheticDataset(opt, length=1, seed=opt.seed).background())
    bg = cv2.resize(bg, (BG_W, BG_H), interpolation=cv2.INTER_CUBIC)
    d["bg_jpg"] = os.path.join(root, "bg.jpg")
    cv2.imwrite(d["bg_jpg"], bg[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 95])
    return d


def native_exact(smoke, nl, d, S):
    """Phase 14 (b): decode_image against decode_image_plain in the three
    modes on a frame, a mask and an IUV PNG (NATIVE_SRC -> S) and on
    bg.jpg (BG_W x BG_H -> S); NativeBatcher (4 threads) against per-file
    decode_image on every frame, mask and IUV file; a bad path counted.
    Returns the numbers."""
    import numpy as np
    from neural_human_video_rendering_tpu_torch.utils import image as timg
    first = "frame00000.png"
    files = [os.path.join(d["frames"], first), os.path.join(d["mask"], first),
             os.path.join(d["densepose"], first), d["bg_jpg"]]
    worst = {}
    for path in files:
        pixels = (timg._jpeg_native(path, False) if path.endswith(".jpg")
                  else timg.read_png(path))
        for mode in (nl.MODE_RGB, nl.MODE_GRAY, nl.MODE_LABEL):
            got = nl.decode_image(path, S, mode)
            want = nl.decode_image_plain(pixels, S, mode)
            err = (max_ulp(got, want) if got.dtype == np.float32
                   else float((got != want).sum()))
            worst[f"{os.path.basename(os.path.dirname(path))}/"
                  f"{os.path.basename(path)} mode {mode}"] = err
    for name, err in worst.items():
        smoke.check(f"native decode_image vs decode_image_plain {name} "
                    f"(ulp; labels: values that differ)", err,
                    NATIVE_ULP if "mode 2" not in name else 0)
    batch_ms = {}
    for key, mode in (("frames", nl.MODE_RGB), ("mask", nl.MODE_GRAY),
                      ("densepose", nl.MODE_LABEL)):
        paths = [os.path.join(d[key], f) for f in sorted(os.listdir(d[key]))]
        t = time.perf_counter()
        single = np.stack([nl.decode_image(p, S, mode) for p in paths])
        t_single = time.perf_counter() - t
        b = nl.NativeBatcher(paths, S, mode, threads=4)
        try:
            t = time.perf_counter()
            b.submit(range(len(paths)))
            got = b.wait()
            t_batch = time.perf_counter() - t
            smoke.require(f"NativeBatcher (4 threads) == decode_image on the "
                          f"{len(paths)} {key} files", np.array_equal(got, single))
            batch_ms[key] = {"per_file_ms": t_single * 1e3 / len(paths),
                             "batcher_4_threads_ms": t_batch * 1e3 / len(paths)}
        finally:
            b.close()
    b = nl.NativeBatcher([files[0], os.path.join(d["frames"], "missing.png")],
                         S, nl.MODE_RGB, threads=4)
    try:
        b.submit([0, 1])
        try:
            b.wait()
            err = ""
        except IOError as e:
            err = str(e)
    finally:
        b.close()
    smoke.require("NativeBatcher counts one error for a bad path",
                  err.startswith("1 decode errors"), f"({err!r})")
    return {"max_ulp_or_labels": worst, "decode_ms_per_file": batch_ms}


def native_data_path(torch, smoke, tk, fk, repo, dev, smi):
    """Phase 14: (a) the host's g++ and headers and the native loader's
    build; (b) where it built, native_exact; (c) the flagship's stage-2
    recipe through train's main, one epoch of the NATIVE_FRAMES-frame
    NATIVE_SRC px corpus with --bg_path on bg.jpg: every frame, mask, IUV
    and the background decoded by the route (a) found (native where the
    loader built, else OpenCV's rules with the reason printed), per step
    the fused forward keeping w, the backward and the flow warp once. The
    epoch save is phase 7's: here it is recorded and writes nothing.
    Numbers: the build, decode ms of one stage-2 sample by each route the
    host has, the step, and the loader's share of it."""
    import numpy as np
    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.data import native_loader as nl
    from neural_human_video_rendering_tpu_torch.train import __main__ as train
    from neural_human_video_rendering_tpu_torch.train import drivers
    t_phase = time.perf_counter()
    work = os.path.join(repo, "build", "chip_smoke", "native")
    S = NATIVE_S
    # ---- (a) the host and the build
    gxx = shutil.which("g++")
    gxx_version = (subprocess.run([gxx, "--version"], capture_output=True,
                                  text=True).stdout.splitlines()[0]
                   if gxx else "no g++")
    headers = host_headers(gxx)
    nl._load.cache_clear()     # earlier phases' loads tried it first
    t = time.perf_counter()
    built = nl.available()     # g++ where the library is missing, else a load
    build_s = time.perf_counter() - t
    print(f"[native] {gxx_version} | png.h {headers['png.h']} | jpeglib.h "
          f"{headers['jpeglib.h']} | " + (
              f"built {nl.library_path()} ({build_s:.2f} s)" if built
              else f"not built: {nl.unavailable_reason()}"), flush=True)
    smoke.require("native loader built exactly where g++ finds both headers",
                  built == all(headers.values()))
    route = "native" if built else "cv2"
    base = TrainOptions().parse(TRAIN + ["--loadSize", str(NATIVE_SRC)],
                                save=False)
    t = time.perf_counter()
    d = native_corpus(base, os.path.join(work, "corpus"))
    corpus_s = time.perf_counter() - t
    numbers = {"host": {"gxx": gxx_version, "headers": headers,
                        "library": str(nl.library_path()) if built else None,
                        "unavailable_reason": nl.unavailable_reason(),
                        "build_or_load_s": build_s},
               "route": route, "corpus_write_s": corpus_s}
    # ---- (b) the loader against its plain version
    if built:
        numbers["exact"] = native_exact(smoke, nl, d, S)
    # ---- (c) the stage-2 path on this route
    ck = os.path.join(work, "ckpt")
    argv = TRAIN + [
        "--pose_path", d["openpose_json"], "--img_path", d["frames"],
        "--mask_path", d["mask"], "--densepose_path", d["densepose"],
        "--flow_path", d["flow"], "--flow_inv_path", d["flow_inv"],
        "--bg_path", d["bg_jpg"], "--texture_path",
        os.path.join(work, "corpus", "texture.png"), "--checkpoints_dir", ck,
        "--name", "native", "--niter", "1", "--no_decay", "--no_flip",
        "--display_freq", "10000"]
    saves = []
    save_orig = drivers.save_checkpoint
    drivers.save_checkpoint = lambda run_dir, st, epoch, completed=None: \
        saves.append(epoch)
    err_orig = sys.stderr
    tee = _Tee(err_orig)
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    fk.reset_launch_counts()
    dsm.reset_decode_routes()
    sys.stderr = tee
    try:
        t = time.perf_counter()
        st = through_main(train, "run_train", argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
    finally:
        sys.stderr = err_orig
        drivers.save_checkpoint = save_orig
    launches = launch_counts()
    routes = dict(dsm.decode_routes)
    steps = NATIVE_FRAMES // 2
    files = 3 * NATIVE_FRAMES + 1            # frames, masks, IUV, bg.jpg
    noted = NATIVE_NOTE in "".join(tee.parts)
    print(f"[native] stage 2 on the {route} route: {st.step} steps in "
          f"{run_s:.1f} s; decode routes {routes}; launches {launches}; "
          f"saves {saves}; reason printed: {noted}", flush=True)
    smoke.require(f"native data: {steps} stage-2 steps, finite losses",
                  st.step == steps and all(np.isfinite(float(v))
                                           for v in st.metrics.values()))
    smoke.require(f"native data: every frame, mask, IUV and the background "
                  f"on the {route} route (at least {files} files)",
                  set(routes) == {route} and routes[route] >= files,
                  str(routes))
    smoke.require("native data: the reason printed where the loader is "
                  "unavailable, and only there", noted == (not built))
    smoke.require("native data: per step 1 fused forward, 1 backward, 1 flow "
                  "warp", launches == {**{k: 0 for k in REPLACES},
                                       "texture_warp_topk_fwd": steps,
                                       "texture_warp_bwd": steps,
                                       "flow_warp_fwd": steps}, str(launches))
    times = sorted(st.step_seconds[1:])
    step_ms = times[len(times) // 2] * 1e3
    # decode ms of one stage-2 sample (frame t and t-1: images, masks, IUV,
    # flows) by each route the host has
    opt = TrainOptions().parse(argv, save=False)
    sample_ms = {}
    load_orig = nl._load
    try:
        for r in ("native", "cv2"):
            if r == "native" and not built:
                sample_ms[r] = "not available on this host"
                continue
            if r == "cv2":
                nl._load = lambda: (None, "switched off to time OpenCV's route")
            ds = dsm.FrameDataset(opt, "train")
            ds[1]
            t = time.perf_counter()
            for i in range(2, NATIVE_FRAMES):
                ds[i]
            sample_ms[r] = (time.perf_counter() - t) * 1e3 / (NATIVE_FRAMES - 2)
    finally:
        nl._load = load_orig
    # the decode work of a step's 2 samples over the step's median ms (the
    # loader's threads overlap it with the step)
    loader_ms = 2 * sample_ms[route]
    numbers.update({
        "stage2": {"steps": st.step, "run_s": run_s, "step_ms_median": step_ms,
                   "ms_steps": [x * 1e3 for x in st.step_seconds],
                   "decode_routes": routes, "launches": launches,
                   "saves_recorded": saves},
        "decode_ms_per_sample": sample_ms,
        "loader_ms_per_step": loader_ms,
        "loader_share_of_step": loader_ms / step_ms,
        "phase_s": time.perf_counter() - t_phase, "card": smi})
    print(json.dumps({"native_data": numbers}), flush=True)
    del st
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return numbers


COMPILED_STEPS = 5           # (a): steps eager and graphed
COMPILED_TIMED = 10          # (c): timed steps a route (after 3 warm-ups)
COMPILED_FWD_ITERS = 20      # (d): timed forwards a route
COMPILED_LOSS_RTOL = 1e-5    # (a): each step's losses graphed vs eager
COMPILED_GRAD_SEEDS = 2      # (a3): states and batches
# (a3): the bf16 recipe's step-1 gradients graphed vs eager, phase 12's
# form (scale_tol * the module's largest gradient + tensor_tol * the
# tensor's) at bf16's unit roundoff
COMPILED_GRAD_SCALE_TOL = COMPILED_GRAD_TENSOR_TOL = 2.0 ** -8


def step_times(torch, smi, step, state, batch, eager, tag):
    """(c) one route of a step on one packed batch: wall ms a step (host
    clock to a synchronise, median of COMPILED_TIMED after 3 warm-ups,
    a capture included in the first), device ms a step (the profiler's
    kernel time, and CUDA events around a step), the busy share, peak
    memory over the warm-ups and the timed steps (allocated above the
    state, and reserved), the capture seconds and the captures' caught
    out-of-memory errors."""
    import statistics
    from neural_human_video_rendering_tpu_torch.kernel_ab import wall_ms
    kw = {"mark": lambda name: None} if eager else {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    walls = wall_ms(torch, lambda: step(state, batch, **kw), 3,
                    COMPILED_TIMED)
    peak = torch.cuda.max_memory_allocated() - base
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        step(state, batch, **kw)
    end.record()
    end.synchronize()
    trace = trace_forward(torch, lambda: step(state, batch, **kw), iters=3)
    wall = statistics.median(walls)
    prog = getattr(step, "program", None)
    out = {"route": "eager" if eager else "graphed", "wall_ms_median": wall,
           "wall_ms_min": min(walls), "wall_ms_max": max(walls),
           "device_ms_profiler": trace["device_busy_ms_per_call"],
           "device_ms_events_5_steps": start.elapsed_time(end) / 5,
           "busy_share": trace["device_busy_ms_per_call"] / wall,
           "peak_mem_bytes_above_state": peak,
           "capture_s": (list(prog.capture_s) if prog is not None
                         and not eager else None),
           "num_ooms": (prog.num_ooms if prog is not None and not eager
                        else None),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "port_kernels_ms": trace["port_kernels_ms_per_call"],
           "card": smi}
    print(f"[compiled] (c) {tag} {json.dumps(out)}", flush=True)
    return out


def compiled_path(torch, smoke, tk, fk, repo, dev, smi):
    """Phase 15: the compiled step. make_train_step's graphed route
    against its eager route (a call with a mark) from one start, with
    cuDNN's deterministic algorithms. (a1) The gradients: the recipe in
    float32 with every part blended (PAR_EXACT), one SGD(1) step each
    route, the losses within COMPILED_LOSS_RTOL and the changes of G, D
    and the EMA in phase 12's form. (a2) The recipe as it trains (bf16,
    Adam with the schedule, the EMA, --pool_size 8), 5 steps each route
    and a second eager run: step 1's losses within COMPILED_LOSS_RTOL;
    every graphed step's update (Adam's parameters, moments and counts,
    the EMA) equal to the eager update on the gradients the graph made
    (graphed_update_err); the pool's draws and count equal. (a3) Step 1's
    gradients of G and D as the recipe trains, graphed against eager
    (COMPILED_GRAD_*_TOL), on (a2)'s start and more seeds, with a second
    eager run's beside them. The later
    steps' losses are printed against the eager-vs-eager floor:
    texture_warp_bwd adds dtex with float atomics, Adam turns the noise
    of the gradients of the biases ahead of instance norms into steps of
    lr, and two runs of either route part within a few steps. (b) The
    launches of each route over 3 steps, counted on the replays. (c) Both
    routes timed (step_times) at the recipe and at the bench's operating
    point. (d) The graphed forward at batch 8 against the eager forward,
    frames/s both ways and its launches. (e) A partial last batch
    captures a second graph."""
    import numpy as np
    from neural_human_video_rendering_tpu_torch import bench
    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.data.wire import pack_batch
    from neural_human_video_rendering_tpu_torch.infer import test_driver as td
    from neural_human_video_rendering_tpu_torch.kernel_ab import \
        graphed_update_err
    from neural_human_video_rendering_tpu_torch.parallel.selfcheck import \
        delta_ratio
    from neural_human_video_rendering_tpu_torch.train.graphs import WARMUP
    from neural_human_video_rendering_tpu_torch.train.state import (
        create_train_state, make_optimizer)
    from neural_human_video_rendering_tpu_torch.train.steps import (
        make_forward_fn, make_train_step)
    t_phase = time.perf_counter()
    work = os.path.join(repo, "build", "chip_smoke", "compiled")
    ckpt = ["--checkpoints_dir", os.path.join(work, "ckpt")]
    opt = TrainOptions().parse(TRAIN + ckpt + ["--name", "compiled",
                                               "--pool_size", "8"], save=False)
    ds = dsm.SyntheticDataset(opt, length=2 * COMPILED_STEPS + 1,
                              seed=opt.seed)
    batches = [pack_batch(dsm.collate([ds[2 * i], ds[2 * i + 1]]))
               for i in range(COMPILED_STEPS)]
    atlas, bg = ds.texture_atlas(), ds.background()
    out = {"card": smi}

    def cpu(sd):
        return {k: v.detach().float().cpu().clone() for k, v in sd.items()}

    def snapshot(st):
        return {"G": cpu(st.renderer.state_dict()),
                "D": cpu(st.disc.state_dict()), "EMA": cpu(st.g_ema)}

    def load(st, snap):
        st.renderer.load_state_dict(snap["G"])
        st.disc.load_state_dict(snap["D"])
        st.g_ema = {k: v.to(dev, copy=True) for k, v in snap["EMA"].items()}

    def moved(run, snap, m):
        return {k: v - snap[m][k] for k, v in run["end"][m].items()}

    # ---- (a1) the gradients: one SGD(1) step each route, float32
    o32 = TrainOptions().parse(TRAIN + PAR_EXACT + ckpt + [
        "--name", "compiled_sgd"], save=False)
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    sgd, start = {}, None
    ooms = {}               # (f): each capture's caught out-of-memory errors
    for name in ("eager", "graphed"):
        st = create_train_state(o32, atlas, bg, device=dev)
        if start is None:
            start = snapshot(st)
        else:
            load(st, start)
        step = make_train_step(
            o32, st.renderer, st.disc, None,
            torch.optim.SGD(st.renderer.parameters(), lr=1.0),
            torch.optim.SGD(st.disc.parameters(), lr=1.0))
        kw = {} if name == "graphed" else {"mark": lambda n: None}
        sgd[name] = {"losses": {k: float(v) for k, v in
                                step(st, batches[0], **kw).items()},
                     "end": snapshot(st)}
        ooms["(a1)"] = step.program.num_ooms
        del st, step
        torch.cuda.empty_cache()
    ratios = {m: delta_ratio(moved(sgd["graphed"], start, m),
                             moved(sgd["eager"], start, m),
                             PAR_SCALE_TOL, PAR_TENSOR_TOL)
              for m in ("G", "D", "EMA")}
    loss_rel = max(abs(sgd["graphed"]["losses"][k] - v) / max(abs(v), 1e-12)
                   for k, v in sgd["eager"]["losses"].items())
    print(f"[compiled] (a1) one SGD(1) step float32, graphed vs eager: "
          f"losses max rel {loss_rel:.3e}, changes (err/tol, phase 12's "
          f"form) {json.dumps(ratios)}", flush=True)
    smoke.check("(a1) the SGD step's losses graphed vs eager (relative)",
                loss_rel, COMPILED_LOSS_RTOL)
    for m, r in ratios.items():
        smoke.check(f"(a1) {m} changes (gradients) graphed vs eager "
                    f"(err/tol, worst at {r['tensor']})", r["ratio"], 1.0)
    out["a1"] = {"loss_max_rel": loss_rel, "ratios": ratios}
    del sgd, start

    # ---- (a2) the recipe's Adam, EMA and pool, 5 steps each route, all
    # from one state put back to its start (the graphed run last: its
    # state and step go on to (b) and (e))
    def restart(st, o, snap, gen0, n):
        """st back at its start: weights, EMA, fresh optimizers, the pool
        and its generator, the step counts."""
        load(st, snap)
        st.g_opt = make_optimizer(o, st.renderer.named_parameters(), n)
        st.d_opt = make_optimizer(o, st.disc.named_parameters(), n)
        st.pool_buf.zero_()
        st.pool_n.zero_()
        st.pool_gen.set_state(gen0)
        st.step, st.step_t, st.step_t_at = 0, None, -1

    def grads(st):
        """Each parameter's .grad of G and D, float32 on the host."""
        return {m: {k: p.grad.detach().float().cpu().clone()
                    for k, p in mod.named_parameters() if p.grad is not None}
                for m, mod in (("G", st.renderer), ("D", st.disc))}

    runs, step1 = {}, {}
    st = create_train_state(opt, atlas, bg, steps_per_epoch=len(batches),
                            device=dev)
    start, gen0 = snapshot(st), st.pool_gen.get_state()
    for name in ("eager", "eager_again", "graphed"):
        if name != "eager":
            restart(st, opt, start, gen0, len(batches))
        step = make_train_step(opt, st.renderer, st.disc, st.vgg, st.g_opt,
                               st.d_opt)
        losses, update_err = [], []
        for b in batches:
            if name == "graphed":
                m, err = graphed_update_err(torch, st, step, b,
                                            opt.ema_decay)
                update_err.append(err)
            else:
                m = step(st, b, mark=lambda n: None)
            losses.append({k: float(v) for k, v in m.items()})
            if b is batches[0]:
                step1[name] = grads(st)
        torch.cuda.synchronize()
        runs[name] = {"losses": losses, "update_err": update_err,
                      "pool_n": int(st.pool_n),
                      "gen": st.pool_gen.get_state().clone(),
                      "steps": st.step, "step_t": int(st.step_t),
                      "captures": (step.program.captures
                                   if name == "graphed" else 0)}
        torch.cuda.empty_cache()
    graphed_state, graphed_step = st, step
    del st, step

    # ---- (a3) the recipe's gradients at step 1 (bf16, VGG, the pool of
    # 8), graphed against eager, beside eager against eager: (a2)'s start
    # and COMPILED_GRAD_SEEDS - 1 more seeds' states and batches
    by_seed = {opt.seed: step1}
    for seed in range(opt.seed + 1, opt.seed + COMPILED_GRAD_SEEDS):
        o = TrainOptions().parse(TRAIN + ckpt + [
            "--name", "compiled_grads", "--pool_size", "8",
            "--seed", str(seed)], save=False)
        d = dsm.SyntheticDataset(o, length=2, seed=seed)
        b = pack_batch(dsm.collate([d[0], d[1]]))
        st = create_train_state(o, d.texture_atlas(), d.background(),
                                steps_per_epoch=1, device=dev)
        snap, g0 = snapshot(st), st.pool_gen.get_state()
        by_seed[seed] = {}
        for name in ("eager", "eager_again", "graphed"):
            restart(st, o, snap, g0, 1)
            step = make_train_step(o, st.renderer, st.disc, st.vgg,
                                   st.g_opt, st.d_opt)
            step(st, b, **({} if name == "graphed"
                           else {"mark": lambda n: None}))
            by_seed[seed][name] = grads(st)
            ooms[f"(a3) seed {seed} {name}"] = step.program.num_ooms
            del step
        del st
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    a3 = {}
    for seed, got in by_seed.items():
        a3[seed] = {f"{r} vs eager": {m: delta_ratio(
            got[r][m], got["eager"][m], COMPILED_GRAD_SCALE_TOL,
            COMPILED_GRAD_TENSOR_TOL) for m in ("G", "D")}
            for r in ("graphed", "eager_again")}
    print(f"[compiled] (a3) step-1 gradients, bf16 recipe (err/tol, scale "
          f"{COMPILED_GRAD_SCALE_TOL} + tensor {COMPILED_GRAD_TENSOR_TOL}) "
          f"{json.dumps(a3)}", flush=True)
    for seed, row in a3.items():
        for m, r in row["graphed vs eager"].items():
            smoke.check(f"(a3) seed {seed}: {m} step-1 gradients graphed vs "
                        f"eager, bf16 recipe (err/tol, worst at "
                        f"{r['tensor']})", r["ratio"], 1.0)
    out["a3"] = a3
    del by_seed, step1
    e, g, e2 = runs["eager"], runs["graphed"], runs["eager_again"]

    def rel(a, b):
        return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b)

    first = rel(g["losses"][0], e["losses"][0])
    later = [rel(lg, le) for lg, le in zip(g["losses"], e["losses"])]
    floor = [rel(l2, le) for l2, le in zip(e2["losses"], e["losses"])]
    print(f"[compiled] (a2) {COMPILED_STEPS} Adam steps: losses graphed vs "
          f"eager (max rel a step) {json.dumps(later)}, eager vs eager "
          f"{json.dumps(floor)}; the update on the graph's own gradients "
          f"(max abs a step) {json.dumps(g['update_err'])}", flush=True)
    smoke.require("(a2) the same loss keys each step", all(
        sorted(a) == sorted(b) for a, b in zip(e["losses"], g["losses"])))
    smoke.check("(a2) step 1's losses graphed vs eager (relative; the same "
                "state and batch)", first, COMPILED_LOSS_RTOL)
    smoke.check("(a2) Adam, the EMA and the counts of every graphed step "
                "equal the eager update on its gradients (max abs)",
                max(g["update_err"]), 0.0)
    smoke.require("(a2) the pool's draws and count equal",
                  g["pool_n"] == e["pool_n"] == 8
                  and torch.equal(g["gen"], e["gen"]),
                  f"(pool_n {g['pool_n']} / {e['pool_n']})")
    smoke.require("(a2) step and device counter advanced",
                  g["steps"] == e["steps"] == COMPILED_STEPS
                  and g["step_t"] == COMPILED_STEPS)
    smoke.require("(a2) one capture for the batch shape", g["captures"] == 1,
                  str(g["captures"]))
    smoke.require("(a2) finite losses every step", all(
        np.isfinite(v) for r in (e, g) for ls in r["losses"]
        for v in ls.values()))
    out["a2"] = {"loss_rel_step1": first, "loss_rel_by_step": later,
                 "loss_rel_eager_vs_eager": floor,
                 "update_max_abs": g["update_err"],
                 "captures": g["captures"]}
    del runs, start

    # ---- (b) launches on the replays, each route
    launches = {}
    for name, kw in (("graphed", {}), ("eager", {"mark": lambda n: None})):
        tk.reset_launch_counts()
        fk.reset_launch_counts()
        for b in batches[:3]:
            graphed_step(graphed_state, b, **kw)
        torch.cuda.synchronize()
        launches[name] = launch_counts()
    want = {k: 3 * v for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
    print(f"[compiled] (b) launches over 3 steps {json.dumps(launches)}",
          flush=True)
    smoke.require("(b) the graphed step launches what the eager one does",
                  launches["graphed"] == launches["eager"] == want,
                  json.dumps(launches))
    out["b"] = launches

    # ---- (e) a partial last batch: its own capture
    part = pack_batch(dsm.collate([ds[2 * COMPILED_STEPS]]))
    metrics = graphed_step(graphed_state, part)
    torch.cuda.synchronize()
    caps = graphed_step.program.captures
    warm = graphed_step.program.warmup_launches
    print(f"[compiled] (e) a batch of 1 after batches of 2: {caps} captures "
          f"({len(graphed_step.program.entries)} held), capture s "
          f"{json.dumps(graphed_step.program.capture_s)}, the warm-ups' "
          f"launches (not in the counters) {json.dumps(warm)}", flush=True)
    smoke.require("(e) each capture's warm-up launched the step's kernels "
                  f"{WARMUP} times", all(
                      warm.get(k, 0) == 2 * WARMUP * v
                      for k, v in TRAIN_LAUNCHES_PER_STEP.items()),
                  json.dumps(warm))
    smoke.require("(e) a partial batch captures a second graph", caps == 2)
    smoke.require("(e) its losses finite", all(
        np.isfinite(float(v)) for v in metrics.values()))
    out["e"] = {"captures": caps, "warmup_launches": warm,
                "capture_s": list(graphed_step.program.capture_s)}
    ooms["(a2), (b), (e)"] = graphed_step.program.num_ooms
    del graphed_state, graphed_step
    torch.cuda.empty_cache()

    # ---- (c) times, both routes, in this process
    recipe = TrainOptions().parse(TRAIN + ckpt + ["--name", "compiled_c"],
                                  save=False)
    points = {"recipe": recipe,
              "bench": bench.bench_options(64, "float32", "0")}
    out["c"] = {}
    for tag, o in points.items():
        d = dsm.SyntheticDataset(o, length=2, seed=0)
        b = pack_batch(dsm.collate([d[0], d[1]]))
        o.checkpoints_dir = os.path.join(work, "ckpt")
        st = create_train_state(o, d.texture_atlas(), d.background(),
                                device=dev)
        res = {}
        for eager in (True, False):
            step = make_train_step(o, st.renderer, st.disc, st.vgg, st.g_opt,
                                   st.d_opt)
            res["eager" if eager else "graphed"] = step_times(
                torch, smi, step, st, b, eager, tag)
            if not eager:
                ooms[f"(c) {tag}"] = step.program.num_ooms
            del step
        res["wall_ratio_graphed_over_eager"] = (
            res["graphed"]["wall_ms_median"] / res["eager"]["wall_ms_median"])
        out["c"][tag] = res
        smoke.require(f"(c) {tag}: both routes timed, finite",
                      all(np.isfinite(r["wall_ms_median"]) for r in
                          (res["eager"], res["graphed"])))
        del st
        torch.cuda.empty_cache()

    # ---- (d) the forward at batch 8
    renderer = td.build_renderer(recipe, dev)
    fwd = make_forward_fn(recipe, renderer)
    assets = td.assets_to_device(recipe, atlas, bg, dev)
    joints = torch.from_numpy(np.stack([ds[i % len(ds)]["joints"]
                                        for i in range(8)])).to(dev)
    want_f = fwd.eager(assets, joints)
    got_f = fwd(assets, joints)
    torch.cuda.synchronize()
    diffs = {k: float((got_f[k].float() - want_f[k].float()).abs().max())
             for k in ("fake", "fg", "mask", "uv", "probs")}
    print(f"[compiled] (d) graphed vs eager forward at batch 8, max abs "
          f"{json.dumps(diffs)}", flush=True)
    smoke.require("(d) the graphed frames equal the eager forward's",
                  all(v == 0.0 for v in diffs.values()), json.dumps(diffs))
    fps = {}
    for name, fn in (("eager", fwd.eager), ("graphed", fwd)):
        for _ in range(3):
            fn(assets, joints)
        tk.reset_launch_counts()
        fk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(COMPILED_FWD_ITERS):
            fn(assets, joints)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / COMPILED_FWD_ITERS
        counts = launch_counts()
        trace = trace_forward(torch, lambda: fn(assets, joints))
        fps[name] = {"ms_per_batch": ms, "fps": 8e3 / ms,
                     "device_ms_profiler": trace["device_busy_ms_per_call"],
                     "busy_share": trace["device_busy_ms_per_call"] / ms,
                     "texture_warp_topk_fwd_launches": counts[
                         "texture_warp_topk_fwd"], "card": smi}
        smoke.require(f"(d) {name} forward: one fused launch a batch",
                      counts == {**{k: 0 for k in counts},
                                 "texture_warp_topk_fwd": COMPILED_FWD_ITERS},
                      json.dumps(counts))
    print(f"[compiled] (d) {json.dumps(fps)}", flush=True)
    out["d"] = {"max_abs": diffs, **fps}
    ooms["(d)"] = fwd.program.num_ooms
    print(f"[compiled] (f) caught out-of-memory errors by capture "
          f"{json.dumps(ooms)}", flush=True)
    smoke.require("(f) no capture of phase 15 caught an out-of-memory "
                  "error", all(v == 0 for v in ooms.values()),
                  json.dumps(ooms))
    out["f"] = ooms
    del fwd, renderer
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_phase
    print(f"[compiled] phase 15 {out['s']:.1f} s", flush=True)
    return out


# phase 16: the compiled pretrains and server
PRE_STEPS = 3             # (a2), (b2): Adam steps a route
PRE_UV = ["--batchSize", "6"]          # launchers/pretrain_trans.sh's batch
# launchers/pretrain_tex.sh's point: 200 px, batch 2, TexG 64/2/5 over the
# LaplaceProj input (--input_nc 81), the texel mask
PRE_TEX = ("--loadSize 200 --batchSize 2 --ngf_global 64 "
           "--n_downsample_global 2 --n_blocks_global 5 --use_mask_texture "
           "--use_laplace --input_nc 81").split()
SERVE_GRAPH_REQUESTS = 10  # (d): requests of 8 a route, timed


def pretrain_parity(torch, smoke, tk, fk, kind, base, dev, smi):
    """Phase 16 (a) / (b) for one pretrain step, each route from one
    start with cuDNN's deterministic algorithms: (1) one SGD(1) step in
    float32, the losses within COMPILED_LOSS_RTOL and the net's change
    (its gradient) in phase 12's form; (2) PRE_STEPS steps of the run's
    ScheduledAdam at the flags' dtype: step 1's losses within
    COMPILED_LOSS_RTOL, every graphed update equal to the eager update on
    the graph's own gradients (graphed_update_err), the step, update and
    freeze counts equal, one capture, no kernel launched; then (c) both
    routes timed (step_times) in this process."""
    import numpy as np
    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.kernel_ab import \
        graphed_update_err
    from neural_human_video_rendering_tpu_torch.parallel.selfcheck import \
        delta_ratio
    from neural_human_video_rendering_tpu_torch.profile_step import \
        pretrain_case
    from neural_human_video_rendering_tpu_torch.train.state import (
        PretrainState, make_optimizer)
    tag = {"uv": "(a)", "tex": "(b)"}[kind]
    eager_kw = {"mark": lambda n: None}
    out = {}

    def cpu(sd):
        return {k: v.detach().float().cpu().clone() for k, v in sd.items()}

    # ---- (1) the gradient: one SGD(1) step each route, float32
    o32 = TrainOptions().parse(base + ["--dtype", "float32"], save=False)
    net, make, batches = pretrain_case(o32, kind, dev, 1)
    start = cpu(net.state_dict())
    sgd = {}
    for name in ("eager", "graphed"):
        net.load_state_dict(start)
        o = torch.optim.SGD(net.parameters(), lr=1.0)
        st = PretrainState(step=0, net=net, optimizer=o, device=dev)
        step = make(net, o)
        m = step(st, batches[0], **({} if name == "graphed" else eager_kw))
        end = cpu(net.state_dict())
        sgd[name] = ({k: float(v) for k, v in m.items()},
                     {k: v - start[k] for k, v in end.items()})
        if name == "graphed":
            out["sgd_capture"] = step.program.memory[-1]
        del step, st, o
        net.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
    ratio = delta_ratio(sgd["graphed"][1], sgd["eager"][1], PAR_SCALE_TOL,
                        PAR_TENSOR_TOL)
    loss_rel = max(abs(sgd["graphed"][0][k] - v) / max(abs(v), 1e-12)
                   for k, v in sgd["eager"][0].items())
    print(f"[compiled16] {tag}1 {kind}: one SGD(1) step float32, graphed vs "
          f"eager: losses max rel {loss_rel:.3e}, change (err/tol, phase "
          f"12's form) {json.dumps(ratio)}", flush=True)
    smoke.check(f"{tag}1 {kind}: the SGD step's losses graphed vs eager "
                "(relative)", loss_rel, COMPILED_LOSS_RTOL)
    smoke.check(f"{tag}1 {kind}: the change (gradient) graphed vs eager "
                f"(err/tol, worst at {ratio['tensor']})", ratio["ratio"], 1.0)
    out["a1"] = {"loss_max_rel": loss_rel, "ratio": ratio}
    del net, make, batches, sgd, start
    torch.cuda.empty_cache()

    # ---- (2) the run's Adam, PRE_STEPS steps each route
    o = TrainOptions().parse(base, save=False)
    net, make, batches = pretrain_case(o, kind, dev, PRE_STEPS)
    start = cpu(net.state_dict())
    runs = {}
    for name in ("eager", "graphed"):
        net.load_state_dict(start)
        st = PretrainState(step=0, net=net, device=dev,
                           optimizer=make_optimizer(
                               o, net.named_parameters(), len(batches)))
        step = make(net, st.optimizer)
        tk.reset_launch_counts()
        fk.reset_launch_counts()
        losses, errs = [], []
        for b in batches:
            if name == "graphed":
                m, err = graphed_update_err(torch, st, step, b)
                errs.append(err)
            else:
                m = step(st, b, **eager_kw)
            losses.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        runs[name] = {"losses": losses, "update_err": errs,
                      "launches": launch_counts(),
                      "counts": (st.step, st.optimizer.count,
                                 st.optimizer.freeze_count),
                      "state": st, "step": step}
    e, g = runs["eager"], runs["graphed"]
    prog = g["step"].program
    first = max(abs(g["losses"][0][k] - v) / max(abs(v), 1e-12)
                for k, v in e["losses"][0].items())
    print(f"[compiled16] {tag}2 {kind}: {PRE_STEPS} Adam steps ({o.dtype}): "
          f"step-1 losses max rel {first:.3e}; the update on the graph's "
          f"own gradients (max abs a step) {json.dumps(g['update_err'])}; "
          f"losses eager {json.dumps(e['losses'])} graphed "
          f"{json.dumps(g['losses'])}; capture {json.dumps(prog.memory)}",
          flush=True)
    smoke.check(f"{tag}2 {kind}: step 1's losses graphed vs eager "
                "(relative)", first, COMPILED_LOSS_RTOL)
    smoke.check(f"{tag}2 {kind}: every graphed update equals the eager "
                "update on its gradients (max abs)", max(g["update_err"]),
                0.0)
    smoke.require(f"{tag}2 {kind}: step, update and freeze counts equal",
                  e["counts"] == g["counts"] == (PRE_STEPS,) * 3,
                  f"{e['counts']} / {g['counts']}")
    smoke.require(f"{tag}2 {kind}: one capture", prog.captures == 1,
                  str(prog.captures))
    smoke.require(f"{tag}2 {kind}: no kernel launched", all(
        v == 0 for r in (e, g) for v in r["launches"].values()),
        json.dumps([e["launches"], g["launches"]]))
    smoke.require(f"{tag}2 {kind}: finite losses", all(
        np.isfinite(v) for r in (e, g) for ls in r["losses"]
        for v in ls.values()))
    out["a2"] = {"loss_rel_step1": first, "update_max_abs": g["update_err"],
                 "capture": prog.memory}

    # ---- (c) both routes timed in this process, on one packed batch
    st = g["state"]
    out["c"] = {}
    for eager in (True, False):
        step = make(net, st.optimizer) if eager else g["step"]
        out["c"]["eager" if eager else "graphed"] = step_times(
            torch, smi, step, st, batches[0], eager, f"16{tag} {kind}")
    out["c"]["wall_ratio_graphed_over_eager"] = (
        out["c"]["graphed"]["wall_ms_median"]
        / out["c"]["eager"]["wall_ms_median"])
    out["num_ooms"] = prog.num_ooms + (
        out.get("sgd_capture") or {}).get("num_ooms", 0)
    del runs, e, g, st, step, prog, net, batches
    torch.cuda.empty_cache()
    return out


def served_graph(torch, smoke, tk, fk, path, want_launches, joints, dev,
                 tag):
    """Phase 16 (d) for one exported program: serve._Model on the card
    graphs it at its batch; the frames of a request of 8 and of 1 equal
    the module's eager call on the same padded joints, both replay the
    one capture, and each request launches ``want_launches``; forward_s
    graphed (the copy in, the replay, the clone out, a synchronise) and
    eager (the upload, the module's call, a synchronise), medians of
    SERVE_GRAPH_REQUESTS."""
    import statistics

    import numpy as np
    from neural_human_video_rendering_tpu_torch import serve as srv
    model = srv._Model(path, dev)
    B = model.batch
    out = {"warmup_s": model.warmup_s, "route": model.route,
           "capture": model.program.memory if model.program else None}
    smoke.require(f"(d) {tag}: the program graphed at load",
                  model.program is not None and model.program.captures == 1,
                  model.route)
    for n in (B, 1):
        padded = np.concatenate([joints[:n]] + [joints[n - 1:n]] * (B - n))
        want = model.forward(torch.from_numpy(padded).to(dev))[:n].cpu()
        tk.reset_launch_counts()
        fk.reset_launch_counts()
        got = model.render(joints[:n])
        torch.cuda.synchronize()
        launches = launch_counts()
        diff = np.abs(got.astype(np.int16) - want.numpy().astype(np.int16))
        smoke.require(f"(d) {tag}: a request of {n} bit-equal to the eager "
                      "module", int(diff.max()) == 0, f"max {int(diff.max())}")
        smoke.require(f"(d) {tag}: a request of {n} launches "
                      f"{json.dumps(want_launches)} on the replay",
                      launches == {**{k: 0 for k in launches},
                                   **want_launches}, json.dumps(launches))
        out[f"launches_request_{n}"] = launches
    smoke.require(f"(d) {tag}: both requests replay the one capture",
                  model.program.captures == 1)
    graphed = []
    for _ in range(SERVE_GRAPH_REQUESTS):
        model.render(joints[:B])
        graphed.append(model.timing["forward_s"])
    eager = []
    for _ in range(SERVE_GRAPH_REQUESTS):
        t0 = time.perf_counter()
        model.forward(torch.from_numpy(joints[:B]).to(dev))
        torch.cuda.synchronize()
        eager.append(time.perf_counter() - t0)
    out.update(forward_ms_graphed=statistics.median(graphed) * 1e3,
               forward_ms_eager=statistics.median(eager) * 1e3,
               num_ooms=model.program.num_ooms)
    model.device_thread.shutdown()
    del model
    torch.cuda.empty_cache()
    return out


def compiled_pretrain_path(torch, smoke, tk, fk, repo, dev, smi, programs):
    """Phase 16: the compiled pretrains and server. (a) Stage 1 at
    launchers/pretrain_trans.sh's point (512 px, batch 6, the flagship's
    TransG 64/4/9, bf16) and (b) the texture pretrain at
    launchers/pretrain_tex.sh's (200 px, batch 2, TexG 64/2/5, LaplaceProj
    input, texel mask), each by pretrain_parity with its (c) times; (d)
    the served programs phase 11 exported at batch 8 (the sidecar one:
    the fused forward once a request; the --warp_block_parts 8 one, its
    weights baked in: top-k and the forward with w given once each)
    graphed by serve._Model (served_graph); (e) no capture of the phase
    caught an out-of-memory error."""
    import numpy as np
    from neural_human_video_rendering_tpu_torch.config import TestOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    t_phase = time.perf_counter()
    work = os.path.join(repo, "build", "chip_smoke", "compiled16")
    ckpt = ["--checkpoints_dir", os.path.join(work, "ckpt"), "--name", "p16"]
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    out = {"card": smi}
    try:
        out["a"] = pretrain_parity(torch, smoke, tk, fk, "uv",
                                   TRAIN + ckpt + PRE_UV, dev, smi)
        out["b"] = pretrain_parity(torch, smoke, tk, fk, "tex",
                                   TRAIN + ckpt + PRE_TEX, dev, smi)
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = det
    opt = TestOptions().parse(FLAGSHIP + ckpt, save=False)
    ds = dsm.SyntheticDataset(opt, length=SERVE_BATCH)
    joints = np.stack([ds[i]["joints"] for i in range(SERVE_BATCH)]).astype(
        np.float32)
    out["d"] = {
        "sidecar": served_graph(torch, smoke, tk, fk, programs["sidecar"],
                                {"texture_warp_topk_fwd": 1}, joints, dev,
                                "sidecar program"),
        "block_parts_baked": served_graph(
            torch, smoke, tk, fk, programs["block_parts_baked"],
            {"topk_select": 1, "texture_warp_fwd": 1}, joints, dev,
            "--warp_block_parts 8 program, weights baked")}
    for f in programs["files"]:
        os.remove(f)
    print(f"[compiled16] (d) {json.dumps(out['d'])}", flush=True)
    ooms = {"(a) stage 1": out["a"]["num_ooms"],
            "(b) texture": out["b"]["num_ooms"],
            **{f"(d) {k}": v["num_ooms"] for k, v in out["d"].items()}}
    print(f"[compiled16] (e) caught out-of-memory errors by capture "
          f"{json.dumps(ooms)}", flush=True)
    smoke.require("(e) no capture of phase 16 caught an out-of-memory error",
                  all(v == 0 for v in ooms.values()), json.dumps(ooms))
    out["s"] = time.perf_counter() - t_phase
    print(f"[compiled16] phase 16 {out['s']:.1f} s", flush=True)
    return out


def caught_oom_path(torch, smoke, dev, smi):
    """Phase 17: the refusal under a blocker and the clean capture after
    it (graph_memory_probe.blocked_capture), and the check's host cost a
    call (graph_memory_probe.region_us). Only this phase catches the
    refusal, to require it."""
    from neural_human_video_rendering_tpu_torch.parallel import \
        graph_memory_probe as gmp
    got = gmp.blocked_capture(torch, dev)
    first = (got["refusal"] or "").split("\n")[0]
    caught = re.search(r"refused: (\d+) out-of-memory", first)
    print(f"[caught_oom] (a) under the blocker "
          f"({got['free_left_bytes'] / 2**20:.1f} MiB left free): "
          f"{got['refusal']}", flush=True)
    smoke.require("(a) graphs.CaughtOutOfMemory under the blocker, naming "
                  f"the conv's line ({got['conv_line']}), count above 0",
                  caught is not None and int(caught.group(1)) > 0
                  and got["conv_line"] in first, first)
    smoke.require("(a) the refused capture is not stored",
                  got["entries_after_refusal"] == 0)
    smoke.require("(b) the blocker freed: batch N + 1 captures with "
                  "num_ooms 0 and replays bit-equal to its eager call",
                  got["clean_num_ooms"] == 0 and got["captures"] == 1
                  and got["bit_equal"], json.dumps(
                      {k: v for k, v in got.items() if k != "refusal"}))
    got["region_us"] = gmp.region_us(torch, dev)
    numbers = {k: v for k, v in got.items() if k != "refusal"}
    print(f"[caught_oom] {json.dumps(numbers)} | {smi}", flush=True)
    return got


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
        from neural_human_video_rendering_tpu_torch.ops import \
            flow_warp_kernel as fk
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
    phase_s = {}
    lap = [T0]

    def done(phase):
        """The wall seconds of the phase that ends here (printed now, and
        with the total at the end)."""
        now = time.perf_counter()
        phase_s[phase] = now - lap[0]
        lap[0] = now
        print(f"[phase] {phase}: {phase_s[phase]:.1f} s", flush=True)

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
            if "entry function" in line:
                fn = line.split("'")[1] if "'" in line else line
                print(f"[ptxas {name}] {fn[:90]}", flush=True)
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)

    done("1 device")
    # ------------------------------------------ 2. kernel vs plain version
    B, P, S, T, K, EPS = 8, 24, 512, 64, 4, 1e-3
    tex, uv, probs = warp_inputs(torch, B, P, S, S, T, 0, dev)
    errs, w_main = compare_kernels(torch, tk, smoke, "main k=4", tex, uv,
                                   probs, K, 0, EPS)
    compare_kernels(torch, tk, smoke, "k=P", tex, uv, probs, P, 0, 0.0)
    compare_kernels(torch, tk, smoke, "block_parts=8", tex, uv, probs, K, 8, EPS)
    tex128, uv128, probs128 = warp_inputs(torch, 2, P, 256, 256, 128, 1, dev)
    compare_kernels(torch, tk, smoke, "tile 128", tex128, uv128, probs128,
                    K, 0, EPS)
    # phase 8's shapes: tile 128 on 512x512 frames, serving at B=8 and the
    # train step's forward keeping w at B=2
    for b, seed in ((8, 6), (2, 7)):
        tex128, uv128, probs128 = warp_inputs(torch, b, P, S, S, 128, seed, dev)
        compare_kernels(torch, tk, smoke, f"tile 128 B={b} {S}px", tex128,
                        uv128, probs128, K, 0, EPS)
    compare_kernels(torch, tk, smoke, "bf16 texture",
                    tex.bfloat16().float(), uv, probs, K, 0, EPS)
    del tex128, uv128, probs128
    # the train step's shapes: batch 2
    tex2, uv2, probs2 = warp_inputs(torch, 2, P, S, S, T, 2, dev)
    errs["texture_warp_bwd"] = compare_bwd(torch, tk, smoke, "main k=4",
                                           tex2, uv2, probs2, K, EPS)
    compare_bwd(torch, tk, smoke, "k=P", tex2, uv2, probs2, P, 0.0)
    compare_bwd(torch, tk, smoke, "texture batch 1", tex2[:1], uv2, probs2,
                K, EPS)
    bf16_grads(torch, tk, smoke, tex2, uv2, probs2, K, EPS)
    tex128, uv128, probs128 = warp_inputs(torch, 2, P, 256, 256, 128, 3, dev)
    compare_bwd(torch, tk, smoke, "tile 128", tex128, uv128, probs128, K, EPS)
    tex128, uv128, probs128 = warp_inputs(torch, 2, P, S, S, 128, 8, dev)
    compare_bwd(torch, tk, smoke, f"tile 128 B=2 {S}px", tex128, uv128,
                probs128, K, EPS)
    img, flow = flow_inputs(torch, 2, S, 5, dev)
    out_k = fk.flow_warp_fwd(img, flow)
    out_p = fk.flow_warp_fwd_plain(img, flow)
    torch.cuda.synchronize()
    errs["flow_warp_fwd"] = smoke.check(
        "flow_warp_fwd C=5 flow ~8px", float((out_k - out_p).abs().max()),
        FLOW_TOL)
    outside = float((out_p == 0).all(1).float().mean())
    print(f"[check] flow warp: {outside:.3f} of the samples fall outside",
          flush=True)
    smoke.require("some flow samples leave the image", outside > 0.01)
    cat = torch.cat([img[:, :3], flow.flip(1)], dim=1)   # a strided 5-ch view
    want = fk.flow_warp_fwd_plain(cat[:, 1:].contiguous(), flow)
    smoke.check("flow_warp_fwd strided channels (relative: flow channels)",
                float((fk.flow_warp_fwd(cat[:, 1:], flow) - want).abs().max())
                / max(1.0, float(want.abs().max())), FLOW_TOL)
    sm = smooth_flow(torch, flow)
    smoke.check("flow_warp_fwd smooth flow", float(
        (fk.flow_warp_fwd(img, sm) - fk.flow_warp_fwd_plain(img, sm)).abs().max()),
        FLOW_TOL)
    img_o, flow_o = img[..., :510].contiguous(), flow[..., :510].contiguous()
    smoke.check("flow_warp_fwd W=510", float(
        (fk.flow_warp_fwd(img_o, flow_o)
         - fk.flow_warp_fwd_plain(img_o, flow_o)).abs().max()), FLOW_TOL)
    del img_o, flow_o
    del tex2, uv2, probs2, tex128, uv128, probs128, img, flow, out_k, out_p, cat

    done("2 kernels")
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
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    n = td.run_inference(opt, assets=assets)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = launch_counts()
    batches = -(-16 // opt.infer_batch)
    print(f"[main] run_inference wrote {n} frames in {e2e_s:.2f} s; "
          f"launches {launches} for {batches} batches", flush=True)
    smoke.require("16 frames written", n == 16)
    frames = sorted(os.listdir(os.path.join(res_dir, "images")))
    smoke.require("16 PNGs on disk", len(frames) == 16)
    imgs = [read_png(os.path.join(res_dir, "images", f)) for f in frames]
    smoke.require("frames are SxS RGB and not flat",
                  all(i.shape == (S, S, 3) and i.std() > 1.0 for i in imgs))
    smoke.require("serving: texture_warp_topk_fwd once per batch, no other "
                  "kernel", launches == {**{k: 0 for k in launches},
                                         "texture_warp_topk_fwd": batches},
                  f"({launches}, {batches} batches)")
    # the lossy block_parts route: top-k with the cap, then the forward
    # with w given, once per batch
    opt_bp = TestOptions().parse(FLAGSHIP + [
        "--pose_path", kp_dir, "--results_dir", os.path.join(work, "results_bp"),
        "--checkpoints_dir", os.path.join(work, "ckpt"), "--name", "smoke",
        "--warp_block_parts", "8"], save=False)
    tk.reset_launch_counts()
    fk.reset_launch_counts()
    n_bp = td.run_inference(opt_bp, max_frames=8, assets=assets)
    torch.cuda.synchronize()
    bp_launches = launch_counts()
    print(f"[main] --warp_block_parts 8: {n_bp} frames, launches "
          f"{bp_launches}", flush=True)
    smoke.require("block_parts route: 8 frames, topk_select and "
                  "texture_warp_fwd once, no other kernel",
                  n_bp == 8 and bp_launches == {
                      **{k: 0 for k in bp_launches}, "topk_select": 1,
                      "texture_warp_fwd": 1}, str(bp_launches))

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
    rend8 = (out["texture"], out["uv"], out["probs"])
    _, w_real = compare_kernels(torch, tk, smoke, "renderer tensors", *rend8,
                                K, 0, EPS)
    print(f"[main] selection of the renderer batch "
          f"{json.dumps(selection_shape(w_real))}, of random inputs "
          f"{json.dumps(selection_shape(w_main))}", flush=True)
    # the backward at batch 2 on the renderer's own tensors: smooth uv, so
    # neighbouring pixels hit the same texels
    rend2 = (out["texture"][:2], out["uv"][:2], out["probs"][:2])
    compare_bwd(torch, tk, smoke, "renderer tensors B=2", *rend2, K, EPS)

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

    done("3 main path")
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

    serving = kernel_numbers(torch, tk, fk, tex, uv, probs, w_main, K, EPS,
                             ("topk_select", "texture_warp_fwd",
                              "texture_warp_topk_fwd"))
    # the forward on the renderer's own tensors (batch 8): the serving
    # route, the parent's two launches, and the forward with w given
    fg8, u8, v8 = planes(rend8[1], rend8[2])
    w8 = tk.topk_select(fg8, K, 0, EPS)
    rend_fwd = {
        "renderer_tensors_ms": graph_ms(torch, lambda: tk.texture_warp_topk_fwd(
            rend8[0], fg8, u8, v8, K, EPS)),
        "renderer_tensors_topk_then_fwd_ms": graph_ms(
            torch, lambda: tk.texture_warp_fwd(
                rend8[0], u8, v8, tk.topk_select(fg8, K, 0, EPS))),
        "renderer_tensors_w_given_ms": graph_ms(
            torch, lambda: tk.texture_warp_fwd(rend8[0], u8, v8, w8)),
        "renderer_tensors_selected": int((w8 > 0).sum())}
    print(f"[numbers] the forward on the renderer's tensors (B=8): "
          f"{json.dumps(rend_fwd)}", flush=True)
    fg_r, u_r, v_r = planes(rend2[1], rend2[2])
    w_r = tk.topk_select(fg_r, K, 0, EPS)
    g_r = torch.randn((2, rend2[0].shape[2], fg_r.shape[2]), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(9))
    rend_bwd = {"renderer_tensors_ms": graph_ms(
        torch, lambda: tk.texture_warp_bwd(rend2[0], u_r, v_r, w_r, g_r)),
        "renderer_tensors_selected": int((w_r > 0).sum()),
        # selected pixels per (part, batch): the backward's clusters split
        # pixels, not selected pairs, so a few full parts set its time
        "renderer_tensors_selected_per_part_max": int(
            (w_r > 0).sum(2).max()),
        "renderer_tensors_parts_with_half_the_pairs": int(
            ((w_r > 0).sum(2).flatten().sort(descending=True).values.cumsum(0)
             < (w_r > 0).sum() / 2).sum() + 1)}
    print(f"[numbers] texture_warp_bwd on the renderer's tensors (B=2): "
          f"{json.dumps(rend_bwd)}", flush=True)
    del tex, uv, probs, w_main, fwd, renderer, state_assets, rend2, fg_r, \
        u_r, v_r, w_r, g_r, rend8, fg8, u8, v8, w8

    done("4 numbers")
    # ------------------------------------------------------ 5. train path
    train = train_path(torch, smoke, tk, fk, repo, dev, smi)
    done("5 train path")

    # -------------------------------------------------- 6. train numbers
    B2 = 2
    tex, uv, probs = warp_inputs(torch, B2, P, S, S, T, 4, dev)
    w_train = tk.topk_select(planes(uv, probs)[0], K, 0, EPS)
    train_k = kernel_numbers(torch, tk, fk, tex, uv, probs, w_train, K, EPS,
                             tuple(REPLACES), flow=flow_inputs(torch, B2, S, 5, dev),
                             keep_w=True)
    done("6 train numbers")
    # ------------------------------------------------------- 7. pipeline
    pipe = pipeline_path(torch, smoke, tk, fk, repo, dev, smi)
    done("7 pipeline")
    # -------------------------------------------- 8. the reference launchers
    launch_e2e = launchers_path(torch, smoke, tk, fk, repo, dev, smi)
    done("8 launchers")
    # ----------------------------------------------------------- 9. measure
    launch_bench = measure_path(torch, smoke, tk, fk, repo, dev, smi)
    done("9 measure")
    # ---------------------------------------------------------- 10. options
    options = options_path(torch, smoke, tk, fk, repo, dev, smi)
    done("10 options")
    # ------------------------------- 11. export, serve, JAX resume, import
    serving11 = serving_path(torch, smoke, tk, fk, repo, dev, smi)
    done("11 serving")
    # ------------------------------------------------------- 12. parallel
    parallel = parallel_path(torch, smoke, tk, fk, repo, dev, smi)
    done("12 parallel")
    # ---------------------------------------------------------- 13. tools
    tools = tools_path(torch, smoke, tk, fk, repo, dev, smi)
    done("13 tools")
    # ------------------------------------------------------ 14. native data
    native14 = native_data_path(torch, smoke, tk, fk, repo, dev, smi)
    done("14 native data")
    # ------------------------------------------------- 15. the compiled step
    compiled = compiled_path(torch, smoke, tk, fk, repo, dev, smi)
    done("15 compiled step")
    # ------------------------------- 16. the compiled pretrains and server
    compiled16 = compiled_pretrain_path(torch, smoke, tk, fk, repo, dev, smi,
                                        serving11["programs"])
    done("16 compiled pretrains and server")
    # ------------------------- 17. the refusal of a caught out-of-memory
    caught_oom_path(torch, smoke, dev, smi)
    done("17 caught out-of-memory refused")
    ab_launches = tools["ab"].get("launches", {})
    launches_tools = {
        "quality_profile (phase 9 g)": launch_bench.pop("quality_profile"),
        "bench_serve server (phase 11 e)":
            serving11["bench_serve"]["server"]["launches"] or {},
        "bench_trained_regime (phase 13 a)":
            tools["trained_regime"]["launches"],
        **{f"{tool} stage 2, arm {i} (phase 13)": counts
           for tool, runs in ab_launches.items()
           for i, counts in enumerate(runs)},
        "noisyab_anatomy (phase 13 b)": tools["ab"].get("anatomy_launches",
                                                        {})}

    # launches: each kernel's count from the main path that runs it
    bp_path = "run_inference --warp_block_parts 8, 1 batch of 8"
    train_run = f"run_train, {TRAIN_WARMUP + TRAIN_TIMED} steps"
    main_run = {name: (bp_launches[name], bp_path)
                if name in ("topk_select", "texture_warp_fwd")
                else (train["launches"][name], train_run)
                for name in REPLACES}
    kernels = []
    for name in REPLACES:
        row = serving.get(name) or train_k[name]
        entry = {"name": name, "route": "cuda", "source": SOURCE[name],
                 "replaces": REPLACES[name], "launches": main_run[name][0],
                 "launches_path": main_run[name][1],
                 "launches_per_train_step": train["per_step"][name],
                 "launches_pipeline_stage2_epoch": pipe["stage2_epoch"][name],
                 "launches_train_e2e_sh_epoch": launch_e2e[name],
                 "launches_bench": {k: v[name] for k, v in launch_bench.items()},
                 "launches_options": {k: v["launches"][name]
                                      for k, v in options["runs"].items()},
                 "max_abs_err": errs[name], **row, "card": smi}
        if name in serving:
            entry["launches_serving"] = launches[name]
            entry["shapes"] = "serving: B=8, P=24, 512x512, T=64, k=4, eps=1e-3"
            entry["train_shapes"] = train_k[name]
        else:
            entry["shapes"] = "train step: B=2, P=24, 512x512, T=64, k=4, eps=1e-3"
        if name == "texture_warp_topk_fwd":
            entry["also_replaces"] = REPLACES["topk_select"]
            entry["modes"] = ("serving shapes: the selection in registers, "
                              "no w; train_shapes: w kept")
            entry.update(rend_fwd)
        if name == "texture_warp_bwd":
            entry.update(rend_bwd)
        entry["launches_export_serving"] = {
            k: v[name] for k, v in serving11["launches"].items()}
        entry["launches_parallel"] = {
            f"run_train, 2 ranks on cuda:0, {parallel['b']['steps']} steps":
                {f"rank{r}": v[name]
                 for r, v in parallel["b"]["launches_ranks"].items()},
            f"run_inference, 2 ranks on cuda:0, {PAR_INFER} frames at "
            "batch 8": {f"rank{r}": v[name]
                        for r, v in parallel["d"]["launches_ranks"].items()}}
        entry["options_shapes"] = {k: v[name] for k, v in
                                   options["kernels"].items() if name in v}
        entry["launches_tools"] = {k: v.get(name, 0)
                                   for k, v in launches_tools.items()}
        entry["launches_native_data"] = native14["stage2"]["launches"][name]
        entry["launches_compiled_3_steps"] = {
            k: v[name] for k, v in compiled["b"].items()}
        entry["launches_served_program_graphed"] = {
            f"{prog}, request of {n}": v[f"launches_request_{n}"][name]
            for prog, v in compiled16["d"].items() for n in (SERVE_BATCH, 1)}
        entry["timing"] = ("ms, library_ms: device time, CUDA graph of 20 "
                           "calls replayed (warm L2 where the inputs fit); "
                           "host_us: host clock per call, no sync")
        kernels.append(entry)
    done("the kernels' line")
    print(json.dumps({"chip_smoke_s": {
        "total": time.perf_counter() - T0, "phases": phase_s,
        "card": smi}}), flush=True)
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
