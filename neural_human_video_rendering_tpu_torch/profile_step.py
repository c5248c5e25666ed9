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

    python -m neural_human_video_rendering_tpu_torch.profile_step \\
        [--infer] [--steps 3] [--out DIR] [--gpu_ids 0]
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


def run_trace(opt, out_dir: str, steps: int, infer: bool) -> str:
    """Profile ``steps`` steps (or inference forwards) of ``opt`` on its
    device after one warm-up; returns the trace's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .config import resolve_device
    from .data import dataset as dsm
    from .train.state import create_train_state
    from .train.steps import make_forward_fn, make_train_step

    device = resolve_device(opt.gpu_ids)
    cuda = device.type == "cuda"
    ds = dsm.SyntheticDataset(opt, length=opt.batchSize, seed=opt.seed)
    batch = dsm.collate([ds[i] for i in range(opt.batchSize)])
    st = create_train_state(opt, ds.texture_atlas(), ds.background(),
                            device=device)
    if infer:
        fwd = make_forward_fn(opt, st.renderer.eval())
        assets = (st.static_tex, st.bg, st.tex_mask)
        joints = torch.from_numpy(batch["joints"]).to(device)

        def one():
            fwd(assets, joints)
    else:
        step = make_train_step(opt, st.renderer, st.disc, st.vgg, st.g_opt,
                               st.d_opt)

        def one():
            step(st, batch)

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
    path = os.path.join(out_dir, "trace.json")
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
        path = run_trace(profile_options(a), a.out, a.steps, a.infer)
    out = analyze(path, a.top)
    out["trace"] = path
    if not a.analyze:
        out["mode"] = "infer" if a.infer else "train"
        import torch
        out["device"] = (torch.cuda.get_device_name(0) if a.gpu_ids.strip()
                         and int(a.gpu_ids.split(",")[0]) >= 0 else "cpu")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
