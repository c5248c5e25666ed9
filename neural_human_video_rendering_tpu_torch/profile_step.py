"""Per-source-line profile of the flagship stage-2 step (or the inference
forward): the port of the JAX package's ``tools/profile_step.py``.

Runs the step under ``torch.profiler`` (CPU and CUDA activity,
``with_stack=True``), each step in a ``profile_step`` span that ends with
a device synchronise, and writes the Chrome trace to {out}/trace.json.
The analysis sums the time of every CUDA kernel (and memcpy / memset) by
the innermost frame of this package on the Python stack that launched it
(the launch is matched to its kernel by the CUPTI correlation id; a
backward kernel by the frame of the forward op whose autograd node
launched it, marked "(backward)"), and
prints one JSON line: the rows (ms a step and share), the kernels' ms a
step, the step's ms and the device's busy share of it (the union of the
kernels' intervals over the steps' spans). A trace of the CPU alone (no
kernels) is summed by its top-level CPU ops instead, under names that say
so.

The table is the eager step's (a call with a mark) or the eager forward's:
the trainers run the captured program on the card (train/graphs.py), whose
kernels a CUDA graph replay launches with no Python stack of their own. On
the card the tool then traces that route too and adds its device ms a
step and busy share as ``graphed``. ``--stage uv`` / ``tex`` profiles a
pretrain step (``pretrain_case``) at the same flags instead of the
stage-2 step.

    python -m neural_human_video_rendering_tpu_torch.profile_step \\
        [--infer | --stage uv|tex] [--steps 3] [--out DIR] [--gpu_ids 0]
    python -m neural_human_video_rendering_tpu_torch.profile_step --analyze DIR

--analyze also reads the trainers' --profile_dir traces
(``steps_A-B.trace.json``, recorded with stacks). The options are the JAX
tool's (its 512 px model: TransG 64/4/9, TexG 48/2/10, tile 128, bf16,
the recipe's losses, batch 2).
"""

from __future__ import annotations

import argparse
import bisect
import glob
import gzip
import json
import os
import sys
from collections import defaultdict
from typing import Dict, List, Optional

PACKAGE = "neural_human_video_rendering_tpu_torch/"
STEP_SPAN = "profile_step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_FRAME = "<no frame of the package>"


def profile_options(a: argparse.Namespace):
    """The JAX tool's operating point from its flags."""
    from .config import Options
    return Options(
        loadSize=a.loadSize, batchSize=a.batchSize, tex_tile=a.tex_tile,
        ngf=a.ngf, n_downsample_translate=4, n_blocks_translate=9,
        ngf_global=a.ngf_global, n_downsample_global=2, n_blocks_global=10,
        n_downsample_bg=2, n_blocks_bg=2, num_D=2, n_layers_D=3, ndf=64,
        netG=a.netG, lambda_L2=500, lambda_UV=1000, lambda_Prob=10,
        lambda_Temp=500, use_densepose_loss=True, dtype="bfloat16",
        warp_dtype=a.warp_dtype, gpu_ids=a.gpu_ids)


def synthetic_laplace(joints, size: int, channels: int):
    """(channels, size, size) float32 numpy LaplaceProj stand-in in
    [-1, 1] from one frame's (18, 3) joints: the limb-local channels at
    two envelope widths and the joint heatmaps, cut to ``channels``."""
    import torch

    from .data.rasterize import joint_heatmaps, limb_coord_maps
    j = torch.from_numpy(joints[None].astype("float32"))
    sig = size / 40.0
    planes = torch.cat([limb_coord_maps(j, size, size, sigma=sig),
                        limb_coord_maps(j, size, size, sigma=2 * sig),
                        joint_heatmaps(j, size, size, sigma=sig) * 2 - 1], 1)
    return planes[0, :channels].clamp(-1, 1).numpy()


def pretrain_case(opt, stage: str, device, n: int = 1):
    """(net, make(net, optimizer) -> step, n packed batches of
    --batchSize) of a pretrain step at ``opt`` on ``device``: 'uv' TransG
    on the synthetic DensePose pseudo-GT; 'tex' TexG against per-frame
    part textures and a pose texture (with --use_laplace the LaplaceProj
    stand-in), the atlas as static_tex and its texel mask. The nets are
    initialised from --seed as the drivers initialise them."""
    import numpy as np

    from .data import dataset as dsm
    from .data.wire import pack_batch
    from .models.renderer import init_params, renderer_from_options
    from .train import drivers
    from .train.state import to_nchw
    from .train.steps import make_pretrain_tex_step, make_pretrain_uv_step
    B = opt.batchSize
    syn = dsm.SyntheticDataset(opt, length=n * B, seed=opt.seed)
    samples = [syn[i] for i in range(n * B)]
    if stage == "uv":
        net = init_params(renderer_from_options(opt).TransG, opt.seed)

        def make(net, optimizer):
            return make_pretrain_uv_step(opt, net, optimizer)
    else:
        atlas = syn.texture_atlas()
        static = to_nchw(atlas, device)
        mask = to_nchw(drivers._tex_mask(opt, atlas), device)
        rng = np.random.default_rng(opt.seed)
        for i, s in enumerate(samples):
            s["part_texture"] = np.clip(atlas + 0.1 * np.sin(0.3 * i), -1,
                                        1).astype(np.float32)
            s["pose_texture"] = np.clip(
                atlas + rng.normal(0, 0.1, atlas.shape), -1, 1).astype(
                    np.float32)
            if opt.use_laplace:
                s["laplace"] = np.moveaxis(synthetic_laplace(
                    s["joints"], opt.train_size, opt.laplace_nc_eff), 0, -1)
        net = init_params(drivers.texg_from_options(opt), opt.seed)

        def make(net, optimizer):
            return make_pretrain_tex_step(opt, net, optimizer, static, mask)
    batches = [pack_batch(dsm.collate(samples[i * B:(i + 1) * B]))
               for i in range(n)]
    return net.to(device).train(), make, batches


def run_trace(opt, out_dir: str, steps: int, infer: bool,
              graphed: bool = False, stage: str = "e2e") -> str:
    """Profile ``steps`` steps (or inference forwards) of ``opt`` on its
    device after one warm-up; returns the trace's path. The stage-2 step
    (``stage`` e2e), or a pretrain step (uv, tex: ``pretrain_case``). The
    eager step (a call with a mark; the forward's eager closure) by
    default, whose kernels the analysis attributes to lines; with
    ``graphed`` the captured program the steps and make_forward_fn run on
    the card (trace_graphed.json; its kernels are launched by a graph
    replay and carry no Python stack of their own)."""
    import torch

    from .config import resolve_device
    from .data import dataset as dsm
    from .train.state import create_train_state
    from .train.steps import make_forward_fn, make_train_step

    device = resolve_device(opt.gpu_ids)
    kw = {} if graphed else {"mark": lambda name: None}
    if stage != "e2e":
        from .train.state import PretrainState, make_optimizer
        net, make, batches = pretrain_case(opt, stage, device)
        pst = PretrainState(step=0, net=net, device=device,
                            optimizer=make_optimizer(
                                opt, net.named_parameters(), 1))
        pstep = make(net, pst.optimizer)

        def one():
            pstep(pst, batches[0], **kw)
        return _trace(one, device, steps, out_dir, graphed)
    ds = dsm.SyntheticDataset(opt, length=opt.batchSize, seed=opt.seed)
    batch = dsm.collate([ds[i] for i in range(opt.batchSize)])
    st = create_train_state(opt, ds.texture_atlas(), ds.background(),
                            device=device)
    if infer:
        fwd = make_forward_fn(opt, st.renderer.eval())
        assets = (st.static_tex, st.bg, st.tex_mask)
        joints = torch.from_numpy(batch["joints"]).to(device)

        run = fwd if graphed else fwd.eager

        def one():
            run(assets, joints)
    else:
        step = make_train_step(opt, st.renderer, st.disc, st.vgg, st.g_opt,
                               st.d_opt)

        def one():
            step(st, batch, **kw)
    return _trace(one, device, steps, out_dir, graphed)


def _trace(one, device, steps: int, out_dir: str, graphed: bool) -> str:
    """``steps`` calls of ``one`` under the profiler after one warm-up,
    each in a STEP_SPAN span ended by a synchronise; the trace's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    one()
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, with_stack=True) as prof:
        for _ in range(steps):
            with record_function(STEP_SPAN):
                one()
                sync()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace_graphed.json" if graphed
                        else "trace.json")
    prof.export_chrome_trace(path)
    return path


def _load(path: str) -> dict:
    if os.path.isdir(path):
        cands = glob.glob(os.path.join(path, "*.json")) + glob.glob(
            os.path.join(path, "*.json.gz"))
        if not cands:
            raise FileNotFoundError(f"no trace (*.json) under {path}")
        preferred = os.path.join(path, "trace.json")
        path = preferred if preferred in cands else max(cands,
                                                       key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _frame_label(name: str) -> str:
    """'.../neural_human_video_rendering_tpu_torch/x.py(12): f' ->
    'neural_human_video_rendering_tpu_torch/x.py(12): f'."""
    return name[name.index(PACKAGE):]


def _top_level(events: List[dict]) -> List[dict]:
    """The events not nested inside another of the list on their thread."""
    out, end = [], {}
    for ev in sorted(events, key=lambda e: (e["tid"], e["ts"], -e["dur"])):
        if ev["ts"] >= end.get(ev["tid"], float("-inf")):
            out.append(ev)
            end[ev["tid"]] = ev["ts"] + ev["dur"]
    return out


class _Nested:
    """Events of each thread that nest like a call stack (Python frames,
    autograd's backward nodes), for 'which of them enclose time t'."""

    def __init__(self, events: List[dict]):
        by_tid: Dict[object, List[dict]] = defaultdict(list)
        for ev in events:
            by_tid[ev["tid"]].append(ev)
        self.events, self.starts, self.parent = {}, {}, {}
        for tid, evs in by_tid.items():
            evs.sort(key=lambda e: (e["ts"], -e["dur"]))
            parent, stack = [], []
            for i, ev in enumerate(evs):
                while stack and evs[stack[-1]]["ts"] + evs[stack[-1]]["dur"] \
                        < ev["ts"]:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(i)
            self.events[tid], self.parent[tid] = evs, parent
            self.starts[tid] = [e["ts"] for e in evs]

    def innermost(self, tid, t: float) -> Optional[dict]:
        """The innermost event of ``tid`` that holds time t, or None."""
        evs = self.events.get(tid)
        if not evs:
            return None
        i = bisect.bisect_right(self.starts[tid], t) - 1
        while i >= 0 and evs[i]["ts"] + evs[i]["dur"] < t:
            i = self.parent[tid][i]
        return evs[i] if i >= 0 else None


def _attribution(events: List[dict]):
    """origin (tid, ts) -> the row label: the innermost package frame on
    the Python stack there. Work inside a backward node of autograd (its
    own thread on the card) goes to the frame of the forward op that
    recorded the node (the same sequence number), marked (backward)."""
    frames = _Nested([e for e in events if e.get("cat") == "python_function"
                      and PACKAGE in e["name"]])
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and "Sequence number" in e.get("args", {})]
    backward = _Nested([e for e in ops if e["args"].get("Fwd thread id")])
    forward = {}
    for e in sorted(ops, key=lambda e: e["ts"]):
        if not e["args"].get("Fwd thread id"):
            forward.setdefault(e["args"]["Sequence number"], e)

    def label(tid, ts) -> str:
        node = backward.innermost(tid, ts)
        fwd = node and forward.get(node["args"]["Sequence number"])
        if fwd:
            frame = frames.innermost(fwd["tid"], fwd["ts"])
            return (_frame_label(frame["name"]) if frame else NO_FRAME) + \
                " (backward)"
        frame = frames.innermost(tid, ts)
        return _frame_label(frame["name"]) if frame else NO_FRAME

    return label


def _union_ms(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def analyze(path: str, top: int = 30) -> dict:
    """The rows and totals of a trace (a file, or a directory holding one);
    see the module docstring."""
    events = [e for e in _load(path).get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e and "ts" in e]
    spans = [e for e in events if e.get("name") == STEP_SPAN
             and e.get("cat") == "user_annotation"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    label = _attribution(events)
    if device:
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in LAUNCH_CATS
                    and "correlation" in e.get("args", {})}

        def origin(ev):
            launch = launches.get(ev.get("args", {}).get("correlation"))
            return (launch["tid"], launch["ts"]) if launch else (None, None)
    else:       # the CPU alone: its top-level ops are the work
        device = _top_level([e for e in events if e.get("cat") == "cpu_op"])

        def origin(ev):
            return ev["tid"], ev["ts"]
    if spans:
        lo = min(s["ts"] for s in spans)
        hi = max(s["ts"] + s["dur"] for s in spans)
        device = [e for e in device if lo <= e["ts"] <= hi]
        window_ms = sum(s["dur"] for s in spans) / 1e3
        steps = len(spans)
    else:
        lo = min(e["ts"] for e in events)
        window_ms = (max(e["ts"] + e["dur"] for e in events) - lo) / 1e3
        steps = 1
    rows: Dict[str, float] = defaultdict(float)
    for ev in device:
        tid, ts = origin(ev)
        rows[label(tid, ts) if tid is not None else NO_FRAME] += \
            ev["dur"] / 1e3
    total = sum(e["dur"] for e in device) / 1e3
    busy = _union_ms((e["ts"], e["ts"] + e["dur"]) for e in device)
    kind = "device" if device and device[0].get("cat") in DEVICE_CATS \
        else "cpu_op"
    ranked = sorted(rows.items(), key=lambda kv: -kv[1])
    return {
        "events": "cuda kernels" if kind == "device" else "cpu ops",
        "steps": steps,
        f"{kind}_ms_per_step": total / steps,
        "step_ms": window_ms / steps,
        "busy_share": busy / window_ms if window_ms > 0 else 0.0,
        "n_rows": len(rows),
        "rows_ms_total": sum(rows.values()),
        "rows": [{"frame": k, "ms_per_step": v / steps,
                  "share": v / total if total > 0 else 0.0}
                 for k, v in ranked[:top]],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="build/profile_step")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--infer", action="store_true")
    p.add_argument("--stage", default="e2e", choices=["e2e", "uv", "tex"],
                   help="the stage-2 step (e2e) or a pretrain step")
    p.add_argument("--loadSize", type=int, default=512)
    p.add_argument("--netG", default="global", choices=["global", "local"])
    p.add_argument("--tex_tile", type=int, default=128)
    p.add_argument("--warp_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--batchSize", type=int, default=2)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--ngf_global", type=int, default=48)
    p.add_argument("--gpu_ids", default="0")
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--analyze", default="",
                   help="skip the run; analyze this trace (file or dir)")
    a = p.parse_args(argv)
    if a.analyze:
        path = a.analyze
    else:
        opt = profile_options(a)
        path = run_trace(opt, a.out, a.steps, a.infer, stage=a.stage)
    out = analyze(path, a.top)
    out["trace"] = path
    if not a.analyze:
        out["mode"] = "infer" if a.infer else "train"
        out["stage"] = a.stage
        out["route"] = "eager"
        import torch
        card = a.gpu_ids.strip() and int(a.gpu_ids.split(",")[0]) >= 0
        out["device"] = torch.cuda.get_device_name(0) if card else "cpu"
        out["graphed"] = None
        if card:        # the route the trainers take, beside the table
            g = analyze(run_trace(opt, a.out, a.steps, a.infer, True,
                                  a.stage))
            out["graphed"] = {
                k: g[k] for k in ("events", "steps", "device_ms_per_step",
                                  "step_ms", "busy_share") if k in g}
            out["graphed"]["note"] = (
                "CUDA graph replays: the kernels carry no Python stack, so "
                "this trace has no by-line rows; the rows above are the "
                "eager step's")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
