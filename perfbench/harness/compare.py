"""The numbers that decide ``correct``, each a gap between what the timed
path produced and what the reference works out from the same inputs.

Training (by the worst leaf: the gap between the program's norm and the
reference's, against the larger of the reference's norm of that leaf and
of the median leaf, since some gradients are all but zero):
  loss_gap    the largest relative gap over G's loss terms and G's and
              D's totals at the first step (the later steps' losses
              follow Adam's first, sign-like update, which turns rounding
              into gaps of a few percent in the program and the control
              alike);
  grad_gap    the first step's gradients, the program's read from its
              optimizer's first moments (m1 = (1 - beta1) g);
  change_gap  the change of every parameter (and of G's EMA) over the
              three steps.
Both leave out the leaves whose reference gradient is under a thousandth
of the median leaf's: gradients nought but for rounding (a conv's bias
before an instance norm), which Adam moves by round-off alone.
Frames (uint8 levels):
  frame_mad   the largest mean absolute difference of one frame.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional

import torch

SMALL_GRAD = 1e-3


@contextlib.contextmanager
def float32_exact():
    """TF32 off for convolutions and matrix products while the float32
    reference runs (a float32 product on the card may otherwise round its
    operands to TF32)."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keys: Optional[Iterable[str]] = None) -> float:
    keys = list(ref) if keys is None else list(keys)
    vals = sorted(ref[k] for k in ref)
    median = vals[len(vals) // 2] if vals else 0.0
    worst = 0.0
    for k in keys:
        den = max(ref[k], median)
        if den > 0:
            worst = max(worst, abs(prog[k] - ref[k]) / den)
    return worst


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    vals = sorted(ref_grad.values())
    median = vals[len(vals) // 2]
    return [k for k, v in ref_grad.items() if v >= SMALL_GRAD * median]


def loss_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The largest relative gap over one step's loss terms and totals."""
    return max(abs(prog[k] - ref[k]) / max(abs(ref[k]), 1e-12) for k in ref)


def norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0
          ) -> Dict[str, float]:
    """Leaf norms in float64 on the host, in one transfer."""
    keys = list(tensors)
    if not keys:
        return {}
    vals = torch.stack([tensors[k].detach().double().norm() for k in keys])
    return dict(zip(keys, (vals * scale).tolist()))


def frame_mad(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """uint8 (N, H, W, C) frames -> the largest per-frame mean absolute
    difference in levels."""
    d = (prog.to(torch.int16) - ref.to(torch.int16)).abs().float()
    return float(d.flatten(1).mean(1).max())


def check(numbers: Dict[str, float], limits: Dict[str, dict]
          ) -> Dict[str, dict]:
    """{name: {"value", "limit"}} for every number the cell holds; a
    number without a limit entry is refused."""
    out = {}
    for name, lim in limits.items():
        if name not in numbers:
            raise KeyError(f"limit for {name!r}, which the run did not read")
        out[name] = {"value": numbers[name], "limit": lim["limit"]}
    return out
