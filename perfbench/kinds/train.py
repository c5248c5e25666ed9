"""Traffic kind ``train``: the stage-2 train step, closed loop.

Set-up draws a pool of distinct wire batches, the assets and the weights
from the seed, builds the trainer's state and its step
(``make_train_step``, graphed on the card), and drives that step through
its first steps on the pool's first batches: those steps capture every
program the window replays, and their losses, the first gradients (read
from the optimizer's first moments) and the change of every parameter
after them are what the reference is held to. The window then dispatches
steps as the trainer does, cycling over the pool, with no synchronise
but the one at its end; the rate is all samples of all steps over the
window's time. Once the window has closed and the program's state is
freed, the reference runs the same first steps from the same weights.

Traffic parameters: ``pool`` batches, ``first_steps`` compared,
``trace_from`` and ``trace_steps`` of the traced window (``--trace 1``).
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from ..harness import compare, counts, data, port
from ..harness.window import rate
from ..harness.bench import Result, Run, log
from ..harness.trace import Tracer, span
from ..reference import nets
from ..reference.config import reference_config
from ..reference.step import Trainer


def draw_weights(cfg, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """G's weights as the rendering kinds draw them, D's and VGG's
    by ``make_weights``."""
    shapes = nets.build(cfg, "meta", vgg=not cfg.no_vgg_loss)
    out = {k: data.make_weights(m, seed, device, k)
           for k, m in shapes.items() if m is not None and k != "G"}
    out["G"] = data.generator_weights(shapes["G"], seed, device)
    return out


def _floats(metrics) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


class Program:
    """The port's trainer state and step."""

    def __init__(self, run: Run, cfg, weights, tex, bg):
        self.cfg = cfg
        self.opt = port.options(run.flags, train=True)
        self.state = port.train_state(self.opt, weights, tex, bg, run.device)
        self.fn = port.train_step(self.opt, self.state)

    def step(self, batch):
        return self.fn(self.state, batch)

    def first_grads(self) -> Dict[str, float]:
        """Each leaf's first gradient from Adam's state after one step:
        m1 = (1 - beta1) g."""
        moments = {}
        for tag, module, optim in (("G", self.state.renderer,
                                    self.state.g_opt),
                                   ("D", self.state.disc, self.state.d_opt)):
            for n, p in module.named_parameters():
                moments[f"{tag}.{n}"] = optim.state[p]["exp_avg"]
        return compare.norms(moments, 1.0 / (1.0 - self.cfg.beta1))

    def leaves(self) -> Dict[str, torch.Tensor]:
        out = {f"G.{n}": p for n, p in self.state.renderer.named_parameters()}
        out.update({f"D.{n}": p for n, p in
                    self.state.disc.named_parameters()})
        if self.state.g_ema is not None:
            out.update({f"E.{n}": t for n, t in self.state.g_ema.items()})
        return out

    def capture_s(self) -> float:
        prog = self.fn.program
        return float(sum(prog.capture_s)) if prog is not None else 0.0


class Reference:
    """The plain reference as a system: float32, or (control) with every
    convolution's operands rounded to float8."""

    def __init__(self, cfg, weights, tex, bg, device, fp8: bool):
        n = nets.build(cfg, device, vgg=not cfg.no_vgg_loss)
        for k, m in n.items():
            if m is not None:
                m.load_state_dict(weights[k])
                nets.set_precision(m, "float8" if fp8 else "float32")
        self.t = Trainer(cfg, n["G"], n["D"], n["VGG"], tex, bg)

    def step(self, batch):
        return self.t.step(batch)

    def first_grads(self) -> Dict[str, float]:
        return compare.norms(self.t.grads())

    def leaves(self) -> Dict[str, torch.Tensor]:
        out = {f"G.{n}": p for n, p in self.t.G.named_parameters()}
        out.update({f"D.{n}": p for n, p in self.t.D.named_parameters()})
        if self.t.ema is not None:
            out.update({f"E.{n}": t for n, t in self.t.ema.items()})
        return out

    def capture_s(self) -> float:
        return 0.0


class Frozen(Program):
    """Fault: a step that leaves the state as it found it."""

    def __init__(self, run, cfg, weights, tex, bg):
        super().__init__(run, cfg, weights, tex, bg)
        self.w0 = {k: {n: t.clone() for n, t in w.items()}
                   for k, w in weights.items()}

    def step(self, batch):
        out = super().step(batch)
        with torch.no_grad():
            for k, t in self.leaves().items():
                net, n = _of_g(k).split(".", 1)
                t.copy_(self.w0[net][n])
        return out


class HalfBatch(Program):
    """Fault: half of each batch left out, the means taken over the rest."""

    def step(self, batch):
        half = len(batch["joints"]) // 2
        return super().step({k: v[:half] for k, v in batch.items()})


SYSTEMS = {"program": Program, "fault:frozen": Frozen,
           "fault:half_batch": HalfBatch}


def make_system(run: Run, cfg, weights, tex, bg):
    if run.side == "control":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return Reference(cfg, weights, tex, bg, run.device, fp8=True)
    return SYSTEMS[run.side](run, cfg, weights, tex, bg)


def _of_g(k: str) -> str:
    """An EMA leaf's name as G's leaf of which it is the average."""
    return f"G.{k[2:]}" if k.startswith("E.") else k


def changes(leaves: Dict[str, torch.Tensor], weights) -> Dict[str, float]:
    """Each leaf's distance from the initial weights (G's EMA from G's)."""
    diff = {}
    for k, t in leaves.items():
        net, n = _of_g(k).split(".", 1)
        diff[k] = t.detach() - weights[net][n]
    return compare.norms(diff)


def first_steps(system, batches, weights):
    """(losses a step, first gradients, changes) of the first steps."""
    losses = [_floats(system.step(batches[0]))]
    grads = system.first_grads()
    losses += [_floats(system.step(b)) for b in batches[1:]]
    return losses, grads, changes(system.leaves(), weights)


def numbers(prog, ref) -> Dict[str, float]:
    """The three gaps of compare's module docstring."""
    p_loss, p_grad, p_change = prog
    r_loss, r_grad, r_change = ref
    moving = set(compare.moving_leaves(r_grad))
    keep = [k for k in r_change if _of_g(k) in moving]
    return {"loss_gap": compare.loss_gap(p_loss[0], r_loss[0]),
            "grad_gap": compare.worst_leaf(p_grad, r_grad, moving),
            "change_gap": compare.worst_leaf(p_change, r_change, keep)}


def detail(prog, ref, top: int = 4) -> dict:
    """The losses and the leaves that set each gap (for calibration)."""
    moving = set(compare.moving_leaves(ref[1]))
    vals = sorted(ref[1].values())
    out = {"losses": [[p["G_total"], r["G_total"], p["D_total"],
                       r["D_total"]] for p, r in zip(prog[0], ref[0])],
           "terms": {k: [prog[0][0][k], ref[0][0][k]] for k in ref[0][0]},
           "moving": len(moving), "leaves": len(ref[1]),
           "median_grad": vals[len(vals) // 2]}
    for name, i in (("grad", 1), ("change", 2)):
        vals = sorted(ref[i].values())
        med = vals[len(vals) // 2]
        rows = sorted(((abs(prog[i][k] - ref[i][k]) / max(ref[i][k], med),
                        k, prog[i][k], ref[i][k]) for k in ref[i]
                       if _of_g(k) in moving), reverse=True)
        out[name] = [list(r) for r in rows[:top]]
    return out


def _release(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def reference_readings(run: Run, cfg, batches):
    """The reference's first steps, float32 with TF32 off."""
    with compare.float32_exact():
        tex, bg = data.assets(run.seed, cfg.size, cfg.tex_tile, cfg.n_parts,
                              run.device)
        weights = draw_weights(cfg, run.seed, run.device)
        ref = Reference(cfg, weights, tex, bg, run.device, fp8=False)
        return first_steps(ref, batches, weights)


def run(run: Run) -> Result:
    cfg = reference_config(run.flags)
    tr, dev = run.traffic, run.device
    B, S, first = cfg.batchSize, cfg.size, tr["first_steps"]
    batches = data.train_batches(run.seed, tr["pool"], B, S, dev)
    tex, bg = data.assets(run.seed, S, cfg.tex_tile, cfg.n_parts, dev)
    weights = draw_weights(cfg, run.seed, dev)
    system = make_system(run, cfg, weights, tex, bg)
    prog = first_steps(system, batches[:first], weights)
    del weights
    _sync(dev)
    setup_s = time.perf_counter() - run.t0
    log(f"[train] set-up {setup_s:.3f} s, first losses "
        f"{[round(l['G_total'], 4) for l in prog[0]]}")

    tracer, summary, traced = Tracer(dev) if run.trace else None, None, 0
    n = 0
    _sync(dev)
    t_start = time.perf_counter()
    while (time.perf_counter() - t_start < run.seconds
           or (tracer is not None and summary is None)):
        with span("perfbench.step"):
            system.step(batches[(first + n) % len(batches)])
        n += 1
        if tracer is not None:
            if n == tr["trace_from"]:
                tracer.start()
                traced = n
            elif traced and n == traced + tr["trace_steps"]:
                summary = tracer.stop()
    _sync(dev)
    elapsed = time.perf_counter() - t_start
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    capture_s = system.capture_s()
    system = None
    _release(dev)

    ref = reference_readings(run, cfg, batches[:first])
    readings = {"kind": "train", "capture_s": capture_s, "batch": B,
                "detail": detail(prog, ref)}
    if summary is not None:
        f, b = counts.warp_bounds(cfg, "train", B)
        readings.update(trace=summary, units=tr["trace_steps"],
                        flops=counts.model_flops(cfg, "train", B),
                        warp_fwd_bound_s=f, warp_bwd_bound_s=b)
    return Result(
        e2e={"train_samples_per_s": rate(n * B, elapsed), "setup_s": setup_s},
        numbers=numbers(prog, ref), attempted=n, failed=0,
        memory_peak_bytes=peak, readings=readings)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
