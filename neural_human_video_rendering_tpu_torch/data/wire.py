"""Compact host -> device wire format for training batches: the port of
the JAX package's ``data/wire.py``.

``pack_batch`` (host, numpy, the same numbers as the JAX package's) ships
every image-like field as uint8 and the flows as float16, 4x fewer bytes
than float32; ``unpack_batch`` uploads a batch (``host_tensors``) and
dequantises it (``dequantize``) with torch ops on the device as the train
step's first op; a captured step uploads into its static buffers and
captures the dequantisation. It is dtype-driven: float32 fields pass
through, so raw and packed batches both work.

Layout: the host batch is the dataset's NHWC (``(B, H, W, C)``);
``unpack_batch`` returns the port's NCHW: image / image_prev / bg
(B, 3, H, W), mask (B, 1, H, W), dp_uv / flow / flow_inv (B, 2, H, W),
dp_parts (B, H, W) int64, joints (B, 18, 3) float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# [-1, 1] images quantized on the decoder's own 8-bit grid
_U8_SYM = ("image", "image_prev", "bg", "pose_img", "pose_img_prev")
_U8_UNIT = ("mask", "dp_uv")          # [0, 1]
_F16 = ("flow", "flow_inv", "laplace")
_NHWC = _U8_SYM + _U8_UNIT + _F16


def pack_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """float32 host batch -> compact wire batch (uint8 / float16)."""
    out = {}
    for k, v in batch.items():
        if k in _U8_SYM:
            out[k] = np.round((v.astype(np.float32) + 1.0) * 127.5) \
                .astype(np.uint8)
        elif k in _U8_UNIT:
            out[k] = np.round(v.astype(np.float32) * 255.0).astype(np.uint8)
        elif k == "dp_parts":
            out[k] = v.astype(np.uint8)          # 0..24
        elif k in _F16:
            out[k] = v.astype(np.float16)
        else:
            out[k] = v
    return out


def host_tensors(batch) -> Dict[str, torch.Tensor]:
    """The host batch's arrays as CPU tensors (no copy): what the upload
    moves, packed or raw."""
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def dequantize(raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Uploaded wire (or raw float32) tensors -> float32 / int64 NCHW
    tensors on their device: the dequantisation and the layout change, a
    captured step's first device ops."""
    out = {}
    for k, t in raw.items():
        if k in _U8_SYM and t.dtype == torch.uint8:
            t = t.float() / 127.5 - 1.0
        elif k in _U8_UNIT and t.dtype == torch.uint8:
            t = t.float() / 255.0
        elif k == "dp_parts":
            t = t.long()
        elif k in _F16 and t.dtype == torch.float16:
            t = t.float()
        if k in _NHWC:
            t = t.permute(0, 3, 1, 2).contiguous()
        out[k] = t
    return out


def unpack_batch(batch, device) -> Dict[str, torch.Tensor]:
    """Wire (or raw float32) host batch -> float32 / int64 NCHW tensors on
    ``device``: one upload of the packed bytes, then the dequantisation and
    the layout change as device ops."""
    return dequantize({k: t.to(device, non_blocking=True)
                       for k, t in host_tensors(batch).items()})
