"""Process start-up of the port's data-parallel runs: how many ranks, which
device each takes, and the backend. The JAX package starts its processes
with ``jax.distributed`` and takes every visible device into its mesh
(``runtime.py``, ``train/drivers.py:_maybe_mesh``); the port runs one
process per rank:

  * under ``torchrun`` (WORLD_SIZE / RANK / LOCAL_RANK in the environment)
    this process is one rank. It takes cuda:LOCAL_RANK, or the
    LOCAL_RANK-th id of --gpu_ids where the list holds one id per local
    rank, or the CPU with --gpu_ids -1. A --mesh_shape below the world is
    refused, as is a --batchSize the world does not divide;
  * a process given several ids in --gpu_ids (``--gpu_ids 0,1``; ``0,0``
    puts two ranks on one card; ``=-1,-1`` two CPU ranks) spawns one rank
    per id, at most --mesh_shape of them, with a ``file://`` rendezvous in
    the run's directory. The ranks take its TF32 settings and its
    intra-op threads (split between CPU ranks). A --batchSize the ranks do
    not divide runs one rank (the JAX mesh's rule) and says so;
  * one id: one rank in this process, with no process group.

The backend is NCCL between cards, gloo on the CPU and where two ranks of
a node share a card (NCCL refuses that); the run prints the one it took.
A backend that fails to start raises: nothing falls back to another
backend or to the CPU.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from .config import resolve_device
from .parallel.mesh import DataParallel

TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK")


def gpu_id_list(gpu_ids: str) -> List[int]:
    """--gpu_ids -> its ids; an empty list is the CPU's [-1]. Mixing the
    CPU with cards is refused."""
    ids = [int(t) for t in gpu_ids.replace(",", " ").split()] or [-1]
    if any(i < 0 for i in ids) and any(i >= 0 for i in ids):
        raise ValueError(f"--gpu_ids {gpu_ids!r} mixes the CPU (-1) with "
                         "cards; give CPU ranks as -1,-1")
    return [-1 if i < 0 else i for i in ids]


def mesh_cap(opt) -> Optional[int]:
    """--mesh_shape's first extent (the data axis), or None."""
    toks = [t for t in opt.mesh_shape.replace(",", " ").split() if t]
    return int(toks[0]) if toks else None


def under_torchrun() -> bool:
    return all(k in os.environ for k in TORCHRUN_ENV)


def backend_for(ids: List[int]) -> str:
    """gloo on the CPU and where two ranks share a card, else NCCL."""
    if ids[0] < 0 or len(set(ids)) < len(ids):
        return "gloo"
    return "nccl"


def _device(i: int) -> torch.device:
    return resolve_device(str(i))


def plan_ranks(opt, batch: Optional[int] = None) -> List[int]:
    """The device ids of the ranks a process spawns from --gpu_ids, capped
    by --mesh_shape; one id where ``batch`` (the global batch) does not
    split over them."""
    ids = gpu_id_list(opt.gpu_ids)
    cap = mesh_cap(opt)
    if cap is not None:
        ids = ids[:max(1, cap)]
    if len(ids) > 1 and batch is not None and batch % len(ids):
        print(f"[mesh] batchSize {batch} not divisible by {len(ids)} ranks "
              "-> one rank", flush=True)
        ids = ids[:1]
    return ids


def _start_group(rank: int, world: int, local_rank: int, device, backend: str,
                 init_method: str) -> DataParallel:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kw)
    dp = DataParallel(rank=rank, world=world, local_rank=local_rank,
                      device=device, group=dist.group.WORLD, backend=backend)
    why = (": two ranks share a card, which NCCL refuses"
           if backend == "gloo" and device.type == "cuda" else "")
    print(f"[mesh] {dp}{why}", flush=True)
    return dp


def init_distributed(opt, batch: Optional[int] = None) -> DataParallel:
    """This process's rank of a torchrun launch (env:// rendezvous; the
    group it already joined, if any). ``batch``: the global batch the
    ranks split, if any."""
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cap = mesh_cap(opt)
    if cap is not None and cap < world:
        raise ValueError(f"--mesh_shape {opt.mesh_shape} asks for {cap} "
                         f"ranks, torchrun started {world}: start torchrun "
                         f"with --nproc_per_node {cap}")
    if batch is not None and batch % world:
        raise ValueError(f"global batchSize {batch} does not split over "
                         f"torchrun's {world} ranks")
    ids = gpu_id_list(opt.gpu_ids)
    if len(ids) == local_world:
        dev_id, node_ids = ids[local], ids
    elif ids[0] < 0:
        dev_id, node_ids = -1, [-1] * local_world
    else:
        dev_id, node_ids = local, list(range(local_world))
    if dist.is_initialized():
        return DataParallel(rank=rank, world=world, local_rank=local,
                            device=_device(dev_id), group=dist.group.WORLD,
                            backend=dist.get_backend())
    return _start_group(rank, world, local, _device(dev_id),
                        backend_for(node_ids), "env://")


def _rank_main(rank: int, fn: Callable, opt, args, kw, ids: List[int],
               init_file: str, threads: int, tf32) -> None:
    """A spawned rank: the launching process's precision settings, start
    the group, run fn, leave the group."""
    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        tf32
    dp = _start_group(rank, len(ids), rank, _device(ids[rank]),
                      backend_for(ids), f"file://{init_file}")
    try:
        fn(opt, *args, dp=dp, **kw)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, opt, *args, where: str,
           batch: Optional[int] = None, **kw):
    """Run ``fn(opt, *args, dp=<this rank's DataParallel>, **kw)`` on every
    rank of this run (the module docstring's rules). ``where``: the
    directory of the spawned ranks' rendezvous file; ``batch``: the
    global batch the ranks split, if any. Returns fn's result where this
    process is the only rank or a torchrun rank, and None in a process
    that spawned its ranks (a rank that fails raises here)."""
    if under_torchrun():
        owned = not dist.is_initialized()
        dp = init_distributed(opt, batch)
        try:
            return fn(opt, *args, dp=dp, **kw)
        finally:
            if owned:
                dist.destroy_process_group()
    ids = plan_ranks(opt, batch)
    if len(ids) == 1:
        return fn(opt, *args, dp=DataParallel.solo(_device(ids[0])), **kw)
    for i in ids:
        _device(i)                      # refuses CUDA where there is none
    os.makedirs(where, exist_ok=True)
    init_file = os.path.join(os.path.abspath(where),
                             f".rendezvous_{os.getpid()}_{time.time_ns()}")
    threads = torch.get_num_threads()
    if ids[0] < 0:
        threads = max(1, threads // len(ids))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, opt, args, kw, ids, init_file, threads,
                              tf32),
            nprocs=len(ids), join=True)
    finally:
        if os.path.exists(init_file):
            os.remove(init_file)
    return None
