"""Traffic kind ``render``: offline pose transfer in fixed batches.

Set-up draws the person's assets, G's weights and a driving sequence of
``sequence`` batches of ``batch`` poses from the seed, builds the
renderer and its forward (``make_forward_fn``, graphed on the card) and
renders the first batch, which captures the program. The window renders
the sequence over and over as the port's inference loop pipelines it:
each batch's joints uploaded from the host, the forward, the frames
quantised to uint8 on the card and copied to pinned host memory
asynchronously, at most ``in_flight`` batches waiting for their copy. A
frame counts once it is on the host; the rate is all such frames over
the window's time. ``sample`` batches of the window, drawn from the seed
(a reservoir over the batches rendered), are kept and, once the window
has closed and the program is freed, rendered again by the reference.
"""

from __future__ import annotations

import collections
import random
import time

import torch

from ..harness import compare, counts, data, port
from ..harness.bench import Result, Run, log
from ..harness.trace import Tracer, span
from ..harness.window import rate
from ..reference import nets
from ..reference.config import reference_config
from ..reference.step import quantize, render as ref_render
from .train import _release, _sync


class Program:
    def __init__(self, run: Run, cfg, weights, tex, bg):
        opt = port.options(run.flags, train=False)
        self.g = port.renderer(opt, weights, run.device).eval()
        self.fn = port.forward_fn(opt, self.g)
        self.assets = (tex, bg, None)

    def frames(self, joints: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC frames on the device."""
        return quantize(self.fn(self.assets, joints)["fake"])

    def capture_s(self) -> float:
        prog = self.fn.program
        return float(sum(prog.capture_s)) if prog is not None else 0.0


class Reference:
    def __init__(self, cfg, weights, tex, bg, device, fp8: bool):
        self.cfg, self.tex, self.bg = cfg, tex, bg
        self.g = nets.build(cfg, device, vgg=False)["G"]
        self.g.load_state_dict(weights)
        nets.set_precision(self.g, "float8" if fp8 else "float32")

    def frames(self, joints: torch.Tensor) -> torch.Tensor:
        return ref_render(self.cfg, self.g, self.tex, self.bg, joints)

    def capture_s(self) -> float:
        return 0.0


class HalfBatch(Program):
    """Fault: the second half of each batch not rendered, the first half's
    frames given in its place."""

    def frames(self, joints):
        out = super().frames(joints)
        half = out.shape[0] // 2
        return torch.cat([out[:half], out[:out.shape[0] - half]])


class Altered(Program):
    """Fault: one frame of each batch altered where it is produced."""

    def frames(self, joints):
        out = super().frames(joints).clone()
        out[0] = 255 - out[0]
        return out


SYSTEMS = {"program": Program, "fault:half_batch": HalfBatch,
           "fault:altered": Altered}


def g_weights(cfg, seed: int, device):
    return data.generator_weights(nets.build(cfg, "meta", vgg=False)["G"],
                                  seed, device)


def make_system(run: Run, cfg, weights, tex, bg):
    if run.side == "control":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return Reference(cfg, weights, tex, bg, run.device, fp8=True)
    return SYSTEMS[run.side](run, cfg, weights, tex, bg)


def reference_frames(run: Run, cfg, joints_list):
    """The reference's frames of each joints batch, float32, TF32 off."""
    with compare.float32_exact():
        tex, bg = data.assets(run.seed, cfg.size, cfg.tex_tile, cfg.n_parts,
                              run.device)
        ref = Reference(cfg, g_weights(cfg, run.seed, run.device), tex, bg,
                        run.device, fp8=False)
        return [ref.frames(torch.from_numpy(j).to(run.device)).cpu()
                for j in joints_list]


def run(run: Run) -> Result:
    cfg = reference_config(run.flags)
    tr, dev = run.traffic, run.device
    B, S = tr["batch"], cfg.size
    seq = data.driving_sequence(run.seed, tr["sequence"], B, S, dev)
    tex, bg = data.assets(run.seed, S, cfg.tex_tile, cfg.n_parts, dev)
    system = make_system(run, cfg, g_weights(cfg, run.seed, dev), tex, bg)
    pinned = dev.type == "cuda"
    slots = [torch.empty((B, S, S, 3), dtype=torch.uint8, pin_memory=pinned)
             for _ in range(tr["in_flight"] + 1)]
    system.frames(torch.from_numpy(seq[0]).to(dev))
    _sync(dev)
    setup_s = time.perf_counter() - run.t0
    log(f"[render] set-up {setup_s:.3f} s")

    rng = random.Random(run.seed)
    kept = []                  # reservoir of (sequence index, frames)
    pending = collections.deque()
    done = 0

    def drain() -> None:
        nonlocal done
        i, slot, ready = pending.popleft()
        if ready is not None:
            ready.synchronize()
        done += 1
        if len(kept) < tr["sample"]:
            kept.append((i, slot.clone()))
        else:
            j = rng.randrange(done)
            if j < tr["sample"]:
                kept[j] = (i, slot.clone())

    tracer, summary, traced = Tracer(dev) if run.trace else None, None, 0
    n = 0
    _sync(dev)
    t_start = time.perf_counter()
    while (time.perf_counter() - t_start < run.seconds
           or (tracer is not None and summary is None)):
        i = n % len(seq)
        with span("perfbench.batch"):
            frames = system.frames(torch.from_numpy(seq[i]).to(dev))
            slot = slots[n % len(slots)]
            slot.copy_(frames, non_blocking=pinned)
            ready = None
            if pinned:
                ready = torch.cuda.Event()
                ready.record()
            pending.append((i, slot, ready))
            if len(pending) > tr["in_flight"] - 1:
                drain()
        n += 1
        if tracer is not None:
            if n == tr["trace_from"]:
                while pending:
                    drain()
                tracer.start()
                traced = n
            elif traced and n == traced + tr["trace_batches"]:
                while pending:
                    drain()
                summary = tracer.stop()
    while pending:
        drain()
    elapsed = time.perf_counter() - t_start
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    capture_s = system.capture_s()
    system = None
    _release(dev)

    ref = reference_frames(run, cfg, [seq[i] for i, _ in kept])
    mad = max(compare.frame_mad(f, r) for (_, f), r in zip(kept, ref))
    readings = {"kind": "render", "capture_s": capture_s, "batch": B}
    if summary is not None:
        f, _ = counts.warp_bounds(cfg, "render", B)
        readings.update(trace=summary, units=tr["trace_batches"],
                        flops=counts.model_flops(cfg, "render", B),
                        warp_fwd_bound_s=f)
    return Result(
        e2e={"render_frames_per_s": rate(done * B, elapsed),
             "setup_s": setup_s},
        numbers={"frame_mad": mad}, attempted=n, failed=0,
        memory_peak_bytes=peak, readings=readings)
