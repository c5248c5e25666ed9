"""Carry a flax parameter tree of the JAX package into the port.

The port's modules carry the names flax gives its submodules, so a flax
path ``TransG/GlobalGenerator_0/ResnetBlock_3/ConvNormRelu_0/Conv_0/kernel``
is the state_dict key ``TransG.GlobalGenerator_0.ResnetBlock_3.
ConvNormRelu_0.Conv_0.weight``; the discriminator's ``scale_0/Conv_2``
and the VGG's ``conv7`` map the same way. Kernels change layout on the way:
  * Conv (flax ``Conv_{i}`` and the VGG's ``conv{i}``): HWIO -> OIHW;
  * ConvTranspose: flax (kh, kw, in, out) -> torch (in, out, kh, kw) with
    both spatial axes flipped (flax's transposed conv does not flip the
    kernel; torch's does);
and come out channels_last, the layout the port's convs hold their
weights in (``models/layers.py``). Biases copy as they are. The input is
the tree as nested dicts of numpy arrays (``jax.tree.map(np.asarray,
params)``, or a checkpoint file read by ``utils/flax_msgpack``), so this
module needs no JAX.

A whole checkpoint file of the JAX package becomes the state_dict of the
module of its label: ``G`` / ``G_ema`` (the renderer tree,
``TransG/TexG/BGNet``) of the renderer, ``TransG`` of ``renderer.TransG``,
``TexG`` of TexG, and ``D`` (``scale_i/Conv_j``) of the discriminator.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..utils import flax_msgpack


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        elif isinstance(v, torch.Tensor):          # a bfloat16 leaf
            yield path, v.float().numpy()
        else:
            yield path, np.asarray(v)


def _is_conv(kind: str) -> bool:
    return (kind.startswith("Conv_")
            or re.fullmatch(r"conv\d+", kind) is not None)


def leaf_from_jax(path: str, arr: np.ndarray):
    """One flax leaf by its dotted path -> (state_dict key, tensor): the
    layout change of its kind, a permutation of the values (bit-exact)."""
    parent, leaf = path.rsplit(".", 1)
    kind = parent.rsplit(".", 1)[-1]
    if leaf == "bias":
        return f"{parent}.bias", torch.from_numpy(
            np.array(arr, dtype=np.float32, order="C"))
    if leaf == "kernel" and kind.startswith("ConvTranspose_"):
        t = np.flip(arr, (0, 1)).transpose(2, 3, 0, 1)
    elif leaf == "kernel" and _is_conv(kind):
        t = arr.transpose(3, 2, 0, 1)
    else:
        raise KeyError(f"no torch counterpart for flax parameter {path}")
    return f"{parent}.weight", torch.from_numpy(
        np.array(t, dtype=np.float32, order="C")).contiguous(
            memory_format=torch.channels_last)


def flax_layout(key: str, shape) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """The inverse of leaf_from_jax's naming and shapes: a state_dict key
    and its tensor's shape -> (the flax path, the flax leaf's shape)."""
    parent, leaf = key.rsplit(".", 1)
    kind = parent.rsplit(".", 1)[-1]
    path = tuple(parent.split(".")) + ("kernel" if leaf == "weight"
                                       else "bias",)
    shape = tuple(shape)
    if leaf == "bias":
        return path, shape
    if leaf == "weight" and kind.startswith("ConvTranspose_"):
        return path, (shape[2], shape[3], shape[0], shape[1])
    if leaf == "weight" and _is_conv(kind):
        return path, (shape[2], shape[3], shape[1], shape[0])
    raise KeyError(f"no flax counterpart for parameter {key}")


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (a flax ``params`` tree of the renderer,
    of one subnet, of the discriminator or of the VGG) -> a state_dict for
    the matching port module."""
    return dict(leaf_from_jax(path, arr) for path, arr in _flatten(tree))


def state_dict_from_flax_file(path: str) -> Dict[str, torch.Tensor]:
    """One ``{epoch}_net_{label}.msgpack`` file of the JAX package -> the
    state_dict of the matching port module (load it with strict=True:
    ``utils/checkpoint.load_net_into``)."""
    return params_from_jax(flax_msgpack.restore(path))
