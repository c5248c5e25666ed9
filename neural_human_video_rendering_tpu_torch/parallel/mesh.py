"""Data parallel over ranks: the port of the JAX package's
``parallel/mesh.py``.

The JAX package trains on a 1-D ``data`` mesh: the global batch sharded
over the devices, the state replicated, and the gradient psum inserted by
XLA. The port runs one process (a rank) per device and keeps the same
semantics by hand:
  * one global batch of --batchSize, split evenly over the ranks (each
    rank's loader reads its own shard, or ``shard_batch`` takes a rank's
    rows of a batch the caller holds whole);
  * parameters, buffers, optimizer state and the EMA identical on every
    rank: ``replicate`` broadcasts rank 0's at start and ``check`` holds
    every rank's checksum against the others';
  * gradients summed over the ranks and divided by the world once
    (``all_reduce_grads``) before each optimizer step;
  * the masked means, whose denominators depend on the data, divide by
    the global count (``count_share``), so the average of the ranks'
    gradients is the gradient of the global batch's loss.

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: the
collectives that NCCL and gloo both support on CUDA tensors. A lone rank
(``solo``) has no process group, and each of its methods is the
identity. The reductions a train step makes are host points of a
captured step (``utils/host_point.py``): on the card each one ends a
CUDA graph, runs on the host, and the next graph goes on from it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.host_point import host_point

_INT_VIEW = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}


def tensor_checksum(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """An int64 checksum of the tensors' bits, in their order, on their
    device: each tensor's elements viewed as integers and summed (an int64
    sum wraps the same way everywhere), then weighted by position. Equal
    bits give equal checksums; a single changed element changes it."""
    total = None
    for i, t in enumerate(tensors):
        t = t.detach().contiguous().flatten()
        s = t.view(_INT_VIEW[t.element_size()]).long().sum() * (i + 1)
        total = s if total is None else total + s
    return total if total is not None else torch.zeros((), dtype=torch.int64)


def _memory_order(t: torch.Tensor) -> torch.Tensor:
    """t, or its NHWC view where t is channels_last (a conv's gradient:
    ``models/layers.py``): a view whose logical order is t's memory
    order, so a bucket's copies in and out transpose nothing."""
    if t.dim() == 4 and not t.is_contiguous() \
            and t.is_contiguous(memory_format=torch.channels_last):
        return t.permute(0, 2, 3, 1)
    return t


def module_tensors(module: torch.nn.Module) -> List[torch.Tensor]:
    """A module's parameters and buffers, in state_dict order."""
    return list(module.state_dict(keep_vars=True).values())


def optimizer_tensors(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    """An optimizer's state tensors (Adam's step counts and moments), in
    the order of its parameters."""
    out = []
    for group in optimizer.param_groups:
        for p in group["params"]:
            for v in optimizer.state.get(p, {}).values():
                if torch.is_tensor(v):
                    out.append(v)
    return out


@dataclasses.dataclass
class DataParallel:
    """This process's place in a data-parallel run: its rank, the world,
    its local rank on the node, its device, and the process group (None
    for a lone rank)."""
    rank: int = 0
    world: int = 1
    local_rank: int = 0
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    group: Optional[dist.ProcessGroup] = None
    backend: str = ""

    @classmethod
    def solo(cls, device: torch.device) -> "DataParallel":
        return cls(device=torch.device(device))

    @property
    def is_lead(self) -> bool:
        """Rank 0 alone writes shared artifacts: logs, checkpoints, HTML."""
        return self.rank == 0

    @property
    def parallel(self) -> bool:
        """In a process group (a torchrun world of 1 included: its
        collectives run), not a lone rank."""
        return self.group is not None

    def __str__(self) -> str:
        if not self.parallel:
            return f"one rank on {self.device}"
        return (f"rank {self.rank} of {self.world} on {self.device} "
                f"({self.backend})")

    # ---- rows of a global batch
    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of n (n divisible by world)."""
        if n % self.world:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.world} ranks")
        k = n // self.world
        return slice(self.rank * k, (self.rank + 1) * k)

    def shard_batch(self, batch: Mapping) -> Dict:
        """This rank's rows of every array of a global batch."""
        if not self.parallel:
            return dict(batch)
        return {k: v[self.rows(len(v))] for k, v in batch.items()}

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch of x: every rank's rows, in rank order, on every
        rank, by an all_reduce of a zero buffer that each rank fills at its
        own rows (adding zeros is exact)."""
        if not self.parallel:
            return x
        n = x.shape[0]
        buf = x.new_zeros((n * self.world,) + tuple(x.shape[1:]))
        buf[self.rank * n:(self.rank + 1) * n] = x
        self._reduce(buf)
        return buf

    # ---- reductions
    def all_reduce_grads(self, params: Iterable[torch.Tensor]) -> None:
        """Average the gradients over the ranks, in place: one flattened
        bucket (per dtype) summed, then divided by the world. Parameters
        without a gradient (frozen, or outside this step's graph: the same
        on every rank) are skipped."""
        if not self.parallel:
            return
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            views = [_memory_order(g) for g in grads]
            flat = torch.cat([v.reshape(-1) for v in views])
            self._reduce(flat)
            flat.div_(self.world)
            for v, r in zip(views, flat.split([v.numel() for v in views])):
                v.copy_(r.view(v.shape))

    def all_reduce_metrics(self, metrics: Mapping[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
        """The ranks' mean of each scalar (one collective for all): the
        global batch's loss, where each rank's is its share of it."""
        if not self.parallel or not metrics:
            return dict(metrics)
        names = list(metrics)
        flat = torch.stack([metrics[k].detach().float().reshape(())
                            for k in names])
        self._reduce(flat)
        flat.div_(self.world)
        return dict(zip(names, flat.unbind(0)))

    def global_count(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of a detached copy of x: a count (a
        masked mean's denominator), or sums to be averaged."""
        x = x.detach().clone()
        if self.parallel:
            self._reduce(x)
        return x

    def count_share(self, count: torch.Tensor) -> torch.Tensor:
        """The denominator of a masked mean on this rank: max(global count,
        1) / world. Each rank's loss is then local_sum * world / global
        count, and the ranks' mean of it (and of its gradient) is the
        global batch's global_sum / global_count, as the JAX step computes
        it on the whole batch. At world 1: max(count, 1)."""
        c = torch.clamp(self.global_count(count), min=1.0)
        return c / self.world if self.parallel else c

    # ---- replication
    def replicate(self, tensors: Sequence[torch.Tensor]) -> None:
        """Broadcast rank 0's values of every tensor to the others, in
        place, then check that the ranks agree."""
        if not self.parallel:
            return
        with torch.no_grad():
            for t in tensors:
                self._broadcast(t.data if isinstance(t, torch.nn.Parameter)
                                else t)
        self.check("replicate", tensors)

    def check(self, what: str, tensors: Sequence[torch.Tensor]
              ) -> Optional[int]:
        """Raise RuntimeError unless every rank holds the same bits in
        ``tensors`` (their checksums' min and max over the ranks agree);
        returns the checksum (None for a lone rank: nothing to check)."""
        if not self.parallel:
            return None
        s = tensor_checksum(tensors).to(self.device)
        lo, hi = s.clone(), s.clone()
        self._all_reduce(lo, dist.ReduceOp.MIN)
        self._all_reduce(hi, dist.ReduceOp.MAX)
        if int(lo) != int(hi):
            raise RuntimeError(
                f"[mesh] {what}: the ranks' checksums differ ({int(lo)} to "
                f"{int(hi)}; this is {self})")
        return int(s)

    def barrier(self) -> None:
        if self.parallel:
            dist.barrier(group=self.group)

    # ---- the transport (parallel.selfcheck.ThreadRank replaces it)
    def _reduce(self, x: torch.Tensor) -> None:
        """The sum over the ranks of x, in place, as a host point of a
        captured step."""
        host_point(lambda: self._all_reduce(x))

    def _all_reduce(self, x: torch.Tensor,
                    op: dist.ReduceOp = dist.ReduceOp.SUM) -> None:
        dist.all_reduce(x, op=op, group=self.group)

    def _broadcast(self, x: torch.Tensor) -> None:
        dist.broadcast(x, src=0, group=self.group)
