"""Carry a flax parameter tree of the JAX package into the port.

The port's modules carry the names flax gives its submodules, so a flax
path ``TransG/GlobalGenerator_0/ResnetBlock_3/ConvNormRelu_0/Conv_0/kernel``
is the state_dict key ``TransG.GlobalGenerator_0.ResnetBlock_3.
ConvNormRelu_0.Conv_0.weight``. Kernels change layout on the way:
  * Conv: flax HWIO -> torch OIHW;
  * ConvTranspose: flax (kh, kw, in, out) -> torch (in, out, kh, kw) with
    both spatial axes flipped (flax's transposed conv does not flip the
    kernel; torch's does).
Biases copy as they are. The input is the tree as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v)


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (a flax ``params`` tree of the renderer
    or of one subnet) -> a state_dict for the matching port module."""
    out = {}
    for path, arr in _flatten(tree):
        parent, leaf = path.rsplit(".", 1)
        kind = parent.rsplit(".", 1)[-1]
        if leaf == "bias":
            t = arr
        elif leaf == "kernel" and kind.startswith("ConvTranspose_"):
            t = np.flip(arr, (0, 1)).transpose(2, 3, 0, 1)
        elif leaf == "kernel" and kind.startswith("Conv_"):
            t = arr.transpose(3, 2, 0, 1)
        else:
            raise KeyError(f"no torch counterpart for flax parameter {path}")
        out[f"{parent}.{'weight' if leaf == 'kernel' else 'bias'}"] = \
            torch.from_numpy(np.array(t, dtype=np.float32, order="C"))
    return out
