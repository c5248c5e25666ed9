"""A self-check of data parallel on the stage-2 step: ranks that split one
fixed global batch, over a process group, against the same ranks run as
threads of one process.

    from neural_human_video_rendering_tpu_torch.runtime import launch
    launch(rank_step, opt, batch, atlas, bg, out_dir, adam_steps,
           where=out_dir, batch=opt.batchSize)
    thread_ranks(opt, batch, atlas, bg, ref_dir, adam_steps, world, device)
    compare(ref_dir, out_dir)

The reference (``thread_ranks``) runs each rank's rows at the rank's own
shapes, with the same global count share, and sums the gradients in rank
order and divides by the world once: the ranks' code with another
transport (``ThreadRank``), so only the order of the final sums may
differ. A reference that takes the global batch in one pass runs its
convolutions and reductions at other shapes, and their rounding flips the
sign of L1 terms within ~1e-6 of 0, each flip moving the gradient by
2 lambda / count through the whole generator.

Each rank builds the state from --seed (rank 0's weights broadcast),
zeroes TexG's head and takes its rows of the batch. It runs one step with
SGD(lr 1), so each parameter's change is its gradient averaged over the
ranks, and writes its losses and the changes of G, D and the EMA. Then it
runs ``adam_steps`` steps of the run's own Adam and EMA on the same rows,
timing the step's phases, and writes the checksums of its parameters,
Adam moments, EMA and pool (``parallel.mesh.tensor_checksum``): every
rank's must be the same.

The step runs in float32 without TF32, and with cuDNN's deterministic
algorithms: others sum some weight gradients in a run-dependent order,
which on the card moves D's changes between two runs of the same shapes
by more than the rounding of the final sums. Give it a texture linear in
the texel coordinates (``linear_atlas``): with TexG's head at zero the
warp's gradient is then the same in every texel cell, so the rounding
that a different batch split brings cannot move a sample across a texel
edge and change its gradient by far more than the rounding.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..train.state import create_train_state
from ..train.steps import make_train_step
from .mesh import DataParallel, module_tensors, optimizer_tensors


class _Threads:
    """The rendezvous of ``world`` ThreadRanks: each collective deposits
    every rank's tensor, then each rank reads them all in rank order."""

    def __init__(self, world: int):
        self.world = world
        self.slots: List[Optional[torch.Tensor]] = [None] * world
        self.barrier = threading.Barrier(world)

    def exchange(self, rank: int, x: torch.Tensor) -> List[torch.Tensor]:
        self.slots[rank] = x.detach().clone()
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()         # every rank has read before the next
        return got


class ThreadRank(DataParallel):
    """A rank of a world run as threads of one process: DataParallel's
    methods with the transport replaced (sums in rank order, rank 0's
    values broadcast)."""
    threads: Optional[_Threads] = None

    @property
    def parallel(self) -> bool:
        return True

    def _all_reduce(self, x, op=dist.ReduceOp.SUM) -> None:
        got = self.threads.exchange(self.rank, x)
        out = got[0]
        for g in got[1:]:
            out = (out + g if op == dist.ReduceOp.SUM else
                   torch.minimum(out, g) if op == dist.ReduceOp.MIN else
                   torch.maximum(out, g))
        x.copy_(out)

    def _broadcast(self, x) -> None:
        x.copy_(self.threads.exchange(self.rank, x)[0])

    def barrier(self) -> None:
        self.threads.exchange(self.rank, torch.zeros(()))


def thread_ranks(opt, batch: Dict[str, np.ndarray], atlas: np.ndarray,
                 bg: np.ndarray, out_dir: str, adam_steps: int, world: int,
                 device: torch.device) -> None:
    """``rank_step`` of each of ``world`` ranks as threads of this process
    on ``device`` (the reference of the module docstring); writes
    {out_dir}/rank{r}.pt, then restores the TF32 and cuDNN settings that
    rank_step sets. A rank's exception breaks the others' waits and is
    raised here."""
    threads = _Threads(world)
    errors: List[BaseException] = []
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)

    def run(rank):
        dp = ThreadRank(rank=rank, world=world, local_rank=rank,
                        device=torch.device(device), backend="threads")
        dp.threads = threads
        try:
            rank_step(opt, batch, atlas, bg, out_dir, adam_steps, dp=dp)
        except BaseException as e:          # noqa: BLE001 - raised below
            errors.append(e)
            threads.barrier.abort()

    workers = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    # rank_step's process-wide settings, back as they were
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = flags
    real = [e for e in errors if not isinstance(e, threading.BrokenBarrierError)]
    if errors:
        raise (real or errors)[0]


def linear_atlas(P: int, T: int, seed: int = 5) -> np.ndarray:
    """(P, T, T, 3) atlas linear in the texel coordinates."""
    yy, xx = np.mgrid[0:T, 0:T].astype(np.float32) / (T - 1)
    coef = np.random.default_rng(seed).uniform(-0.4, 0.4, (P, 3, 2))
    return (coef[:, None, None, :, 0] * xx[None, :, :, None]
            + coef[:, None, None, :, 1] * yy[None, :, :, None]
            ).astype(np.float32)


def _state(opt, atlas, bg, dp: DataParallel):
    st = create_train_state(opt, atlas, bg, device=dp.device, dp=dp)
    texg = st.renderer.TexG.backbone
    head = (texg.head if opt.netG == "local"
            else getattr(texg, texg.order[-1]))
    with torch.no_grad():          # TexG's head at 0: the texture stays linear
        head.Conv_0.weight.zero_()
    st.g_ema = {k: v.detach().clone()
                for k, v in st.renderer.named_parameters()}
    return st


def _cpu(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float().cpu().clone() for k, v in sd.items()}


def rank_step(opt, batch: Dict[str, np.ndarray], atlas: np.ndarray,
              bg: np.ndarray, out_dir: str, adam_steps: int,
              dp: Optional[DataParallel] = None) -> None:
    """This rank's part of the check (the module docstring); writes
    {out_dir}/rank{r}.pt."""
    dp = dp if dp is not None else DataParallel()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    rows = dp.shard_batch(batch)
    st = _state(opt, atlas, bg, dp)
    before = {"G": _cpu(st.renderer.state_dict()),
              "D": _cpu(st.disc.state_dict()), "EMA": _cpu(st.g_ema)}
    step = make_train_step(opt, st.renderer, st.disc, st.vgg,
                           torch.optim.SGD(st.renderer.parameters(), lr=1.0),
                           torch.optim.SGD(st.disc.parameters(), lr=1.0), dp)
    losses = {k: float(v) for k, v in step(st, rows).items()}
    after = {"G": _cpu(st.renderer.state_dict()),
             "D": _cpu(st.disc.state_dict()), "EMA": _cpu(st.g_ema)}
    deltas = {m: {k: after[m][k] - before[m][k] for k in before[m]}
              for m in before}

    # the same start again, with the state's own (unstepped) Adam
    st.renderer.load_state_dict(before["G"])
    st.disc.load_state_dict(before["D"])
    st.g_ema = {k: v.detach().clone()
                for k, v in st.renderer.named_parameters()}
    step = make_train_step(opt, st.renderer, st.disc, st.vgg, st.g_opt,
                           st.d_opt, dp)
    phases: Dict[str, list] = {}
    last = [0.0]

    def mark(name):
        if dp.device.type == "cuda":
            torch.cuda.synchronize(dp.device)
        now = time.perf_counter()
        phases.setdefault(name, []).append((now - last[0]) * 1e3)
        last[0] = now

    for _ in range(adam_steps):
        last[0] = time.perf_counter()
        step(st, rows, mark)
    parts = {"params": module_tensors(st.renderer) + module_tensors(st.disc),
             "adam": optimizer_tensors(st.g_opt) + optimizer_tensors(st.d_opt),
             "ema": list(st.g_ema.values())}
    if st.pool_buf is not None:
        parts["pool"] = [st.pool_buf, st.pool_n]
    checksums = {k: dp.check(f"{k} after {adam_steps} steps", v)
                 for k, v in parts.items()}
    os.makedirs(out_dir, exist_ok=True)
    torch.save({"rank": dp.rank, "world": dp.world, "losses": losses,
                "deltas": deltas if dp.is_lead else None,
                "checksums": checksums, "adam_steps": adam_steps,
                "phase_ms": {k: float(np.median(v[1:] or v))
                             for k, v in phases.items()}},
               os.path.join(out_dir, f"rank{dp.rank}.pt"))


def delta_ratio(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                scale_tol: float, tensor_tol: float) -> dict:
    """Two parameter changes against each other: ``ratio``, the worst
    err / tol over the tensors with tol = scale_tol * max|ref| over all
    tensors + tensor_tol * max|ref| of the tensor (the parity tests' form;
    <= 1 passes), the tensor where it is worst, and the worst err over
    max|ref| of all tensors."""
    scale = max(float(d.abs().max()) for d in ref.values())
    worst, where, err_scale = 0.0, "", 0.0
    for k, d in ref.items():
        err = float((got[k] - d).abs().max())
        tol = scale_tol * scale + tensor_tol * float(d.abs().max())
        r = err / tol if tol > 0 else (0.0 if err == 0 else float("inf"))
        if r >= worst:
            worst, where = r, k
        err_scale = max(err_scale, err / scale)
    return {"ratio": worst, "tensor": where, "err_over_scale": err_scale}


def compare(one_dir: str, ranks_dir: str, scale_tol: float = 1e-5,
            tensor_tol: float = 1e-4) -> dict:
    """The ranks' results against one rank's: the worst relative loss
    difference, each module's ``delta_ratio``, whether every rank's
    checksums are the same, and each run's median phase ms of its Adam
    steps (synchronised at each phase's end: grad_all_reduce is the
    ranks' gradient average)."""
    one = torch.load(os.path.join(one_dir, "rank0.pt"))
    ranks = [torch.load(os.path.join(ranks_dir, f)) for f in
             sorted(os.listdir(ranks_dir)) if f.startswith("rank")]
    lead = ranks[0]
    loss_rel = max(abs(lead["losses"][k] - v) / max(abs(v), 1e-12)
                   for k, v in one["losses"].items())
    return {
        "world": lead["world"], "n_rank_files": len(ranks),
        "same_loss_keys": sorted(lead["losses"]) == sorted(one["losses"]),
        "loss_max_rel": loss_rel,
        "delta_ratio": {m: delta_ratio(lead["deltas"][m], one["deltas"][m],
                                       scale_tol, tensor_tol)
                        for m in one["deltas"]},
        "ranks_bit_equal": all(r["checksums"] == lead["checksums"]
                               for r in ranks),
        "checksums": lead["checksums"],
        "phase_ms": {"one": one["phase_ms"],
                     "ranks": [r["phase_ms"] for r in ranks]},
    }
