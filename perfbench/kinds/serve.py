"""Traffic kind ``serve``: single clients' requests to the served program,
open loop.

Set-up draws the assets and G's weights from the seed, exports the
serving program as ``export_serving`` does (the batch-``batch`` forward,
uint8 frames, the weights as its first input and in a ``.params``
sidecar, saved under the run's temporary directory), loads it with
``serve._Model`` (whose warm-up call captures it) and draws the requests:
``rate`` requests a second of ``frames`` poses each, for the window's
length. The arrivals are one Poisson trace, the same for every seed
(the exponential distribution's quantiles in an order drawn from the
traffic file's ``arrivals_seed``); the seed draws the poses and weights.

The window sends each request when it is due, from a pool of client
threads, whether or not earlier ones have finished; each is timed from
its due time to its frames on the host, and a failed request counts as
missing the tail and makes the run not correct (``failed_requests``).
``sample`` requests drawn from the seed keep their frames, which the
reference renders again once the program is freed.
"""

from __future__ import annotations

import math
import random
import shutil
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..harness import compare, data, port
from ..harness.bench import Result, Run, log
from ..harness.trace import Tracer
from ..harness.window import latencies_from_due, percentile
from ..reference.config import reference_config
from .render import Reference, g_weights, reference_frames
from .train import _release, _sync


class Timed(np.ndarray):
    """Host frames that carry the device call's timing."""
    call_start = 0.0
    forward_s = 0.0
    transfer_s = 0.0


def export(run: Run, cfg, batch: int, weights, tex, bg, where: Path) -> str:
    """The serving program of export_serving (weights as input, uint8
    NHWC frames) traced with the benchmark's weights and assets; returns
    its path, with the bf16 sidecar beside it."""
    from neural_human_video_rendering_tpu_torch import export_serving as ex
    opt = port.options(run.flags, train=False)
    g = port.renderer(opt, weights, run.device).eval()
    params = ex.sidecar_weights(opt, g)
    program = ex.ServingProgram(opt, g, (tex, bg, None), out_uint8=True,
                                weights_as_input=True)
    joints = torch.from_numpy(data.driving_sequence(
        run.seed, 1, batch, cfg.size, run.device)[0]).to(run.device)
    with torch.no_grad():
        exported = torch.export.export(program, (params, joints),
                                       strict=False)
    exported.example_inputs = None
    path = str(where / "serve.pt2")
    torch.export.save(exported, path)
    torch.save({k: v.cpu() for k, v in params.items()}, path + ex.SIDECAR)
    return path


class Served:
    """The loaded program, instrumented from outside: each device call's
    start and its forward and transfer seconds ride on the frames it
    returns."""

    def __init__(self, path: str, device, side: str):
        from neural_human_video_rendering_tpu_torch import serve
        self.model = serve._Model(path, device=device)
        call = self.model._call
        alter = side == "fault:altered"

        def timed(padded, n):
            t = time.perf_counter()
            host = call(padded, n)
            if alter:
                host = 255 - host
            out = host.view(Timed)
            out.call_start = t
            out.forward_s = self.model.timing["forward_s"]
            out.transfer_s = self.model.timing["transfer_s"]
            return out

        self.model._call = timed

    def render(self, joints: np.ndarray):
        return self.model.render(joints)

    def capture_s(self) -> float:
        prog = self.model.program
        return float(sum(prog.capture_s)) if prog is not None else 0.0


class Control:
    """The float8 reference in the served program's place."""

    def __init__(self, cfg, weights, tex, bg, device):
        self.ref = Reference(cfg, weights, tex, bg, device, fp8=True)
        self.device = device
        self.lock = threading.Lock()

    def render(self, joints: np.ndarray):
        with self.lock:
            t = time.perf_counter()
            host = self.ref.frames(torch.from_numpy(joints).to(
                self.device)).cpu().numpy()
        out = host.view(Timed)
        out.call_start = t
        out.forward_s = time.perf_counter() - t
        return out

    def capture_s(self) -> float:
        return 0.0


def gaps(arrivals_seed: int, rate: float, count: int) -> list:
    """`count` inter-arrival gaps of a Poisson process of `rate`: the
    exponential's quantiles at (i + 0.5) / count, in an order drawn from
    the traffic's own arrival seed."""
    g = [-math.log(1.0 - (i + 0.5) / count) / rate for i in range(count)]
    random.Random(arrivals_seed).shuffle(g)
    return g


def requests(run: Run, cfg, rate: float, seconds: float):
    """(due offsets, joints (count, frames, 18, 3)) of one window: one
    arrival trace for every run (the tail of a queue at four fifths of
    its capacity moves by a quarter between two Poisson traces of 700
    requests), the poses drawn from the run's seed."""
    tr = run.traffic
    count = max(1, round(rate * seconds))
    due = np.cumsum(gaps(tr["arrivals_seed"], rate, count)).tolist()
    joints = data.driving_sequence(run.seed, count, tr["frames"], cfg.size,
                                   run.device)
    return due, joints


def window(system, due, joints, clients: int, tracer=None, trace_at=None):
    """Sends every request at its due time (offsets in `due`); returns
    (latencies, outputs, lateness of the sends, traced summary, due
    times on the host's clock). With a tracer, the requests due from
    `trace_at` on are traced, up to the last one's completion: the trace
    is read after the window, never while requests are being sent."""
    n = len(due)
    done = [None] * n
    outs = [None] * n
    late = []
    summary = None

    def one(i: int) -> None:
        try:
            outs[i] = system.render(joints[i])
            done[i] = time.perf_counter()
        except Exception as e:     # a failed request misses the tail
            log(f"[serve] request {i} failed: {e!r}")

    with ThreadPoolExecutor(max_workers=clients) as pool:
        t0 = time.perf_counter()
        futures = []
        traced = False
        for i, d in enumerate(due):
            wait = t0 + d - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late.append(time.perf_counter() - (t0 + d))
            if tracer is not None and not traced and d >= trace_at:
                tracer.start()
                traced = True
            futures.append(pool.submit(one, i))
        for f in futures:
            f.result()
        if traced:
            summary = tracer.stop()
    due = [t0 + d for d in due]
    return latencies_from_due(due, done), outs, late, summary, due


def prepare(run: Run, cfg, where: Path):
    """The system the window sends to: the loaded program (or, for the
    control, the float8 reference)."""
    tr, dev = run.traffic, run.device
    tex, bg = data.assets(run.seed, cfg.size, cfg.tex_tile, cfg.n_parts, dev)
    weights = g_weights(cfg, run.seed, dev)
    if run.side == "control":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return Control(cfg, weights, tex, bg, dev)
    return Served(export(run, cfg, tr["batch"], weights, tex, bg, where),
                  dev, run.side)


def backlog(due, outs) -> tuple:
    """Mean wait before the device call (s) of the first and the last
    quarter of the window's requests: a growing backlog shows as the
    second far above the first."""
    waits = [o.call_start - d for d, o in zip(due, outs) if o is not None]
    q = max(1, len(waits) // 4)
    return sum(waits[:q]) / q, sum(waits[-q:]) / q


def run(run: Run) -> Result:
    cfg = reference_config(run.flags)
    tr, dev = run.traffic, run.device
    where = Path(tempfile.mkdtemp(prefix="perfbench_serve_"))
    try:
        system = prepare(run, cfg, where)
        due, joints = requests(run, cfg, tr["rate"], run.seconds)
        _sync(dev)
        setup_s = time.perf_counter() - run.t0
        log(f"[serve] set-up {setup_s:.3f} s, {len(due)} requests at "
            f"{tr['rate']} a second")
        tracer = Tracer(dev) if run.trace else None
        lat, outs, late, summary, due = window(
            system, due, joints, tr["clients"], tracer,
            run.seconds - tr["trace_s"])
    finally:
        shutil.rmtree(where, ignore_errors=True)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    capture_s = system.capture_s()
    system = None
    _release(dev)
    log(f"[serve] generator lateness: median {percentile(late, 50) * 1e3:.3f}"
        f" ms, max {max(late) * 1e3:.3f} ms; wait before the device call, "
        "first and last quarter: %.3f, %.3f s" % backlog(due, outs))

    ok = [i for i, o in enumerate(outs) if o is not None]
    pick = sorted(random.Random(run.seed + 1).sample(
        ok, min(tr["sample"], len(ok))))
    ref = reference_frames(run, cfg, [joints[i] for i in pick])
    mad = max((compare.frame_mad(torch.from_numpy(np.asarray(outs[i])), r)
               for i, r in zip(pick, ref)), default=math.inf)
    fwd = [outs[i].forward_s for i in ok]
    queue = [lat[i] - outs[i].forward_s - outs[i].transfer_s for i in ok]
    readings = {"kind": "serve", "capture_s": capture_s,
                "forward_s": fwd, "queue_s": queue}
    if summary is not None:
        readings["trace"] = summary
    failed = len(due) - len(ok)
    return Result(
        e2e={"serve_p95_ms": 1e3 * percentile(lat, 95), "setup_s": setup_s},
        numbers={"frame_mad": mad, "failed_requests": failed},
        attempted=len(due), failed=failed, memory_peak_bytes=peak,
        readings=readings)
