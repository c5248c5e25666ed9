"""Quality evaluation between two frame directories: the port of the JAX
package's ``infer/evaluate.py``.

Given rendered frames (``--results_dir`` of the serving driver) and the
ground truth (the real frames, or another framework's renders), it
reports PSNR, SSIM, the VGG distance and, on request, LPIPS (the uniform
head unless an official one is given, ``utils/lpips.py``) and temporal
flicker.

Frames pair by the last number in their basenames (numeric order, so
``frame7`` comes before ``frame10``; the port's ``frame00007_synthesized
.png`` pairs with ``frame00007.jpg``), in sorted order where either side
has no digits. Images load through ``data.dataset.load_image``; the
metrics run under torch.no_grad on the chosen device, a batch at a time,
the last batch padded and the padded entries dropped before averaging.

    python -m neural_human_video_rendering_tpu_torch.evaluate \\
        --results_dir OUT/images --gt_dir FRAMES [--metric lpips,temporal]

(--gpu_ids -1 for the CPU; the card otherwise.) It prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..data import dataset as dsm
from ..models.vgg import build_vgg
from ..utils import metrics as M
from ..utils.lpips import get_lin_weights, lpips_taps


def _frame_key(name: str) -> str:
    """The last digits of a basename, as the pairing key
    ('frame00007_synth' -> '00007'); the name itself where it has none."""
    digits = re.findall(r"\d+", os.path.splitext(name)[0])
    return digits[-1] if digits else name


def pair_frames(dir_a: str, dir_b: str) -> List[Tuple[str, str]]:
    """Pair the image files of two dirs by frame number (sorted-order
    fallback). Numeric order, not lexicographic: the temporal metric
    takes consecutive pairs, and frame1, frame10, frame2 is not a
    sequence."""
    fa, fb = dsm.list_images(dir_a), dsm.list_images(dir_b)
    if not fa or not fb:
        raise FileNotFoundError(f"no images in {dir_a if not fa else dir_b}")
    ka = {_frame_key(f): f for f in fa}
    kb = {_frame_key(f): f for f in fb}
    common = sorted(set(ka) & set(kb),
                    key=lambda k: (0, int(k)) if k.isdigit() else (1, k))
    if common:
        return [(ka[k], kb[k]) for k in common]
    n = min(len(fa), len(fb))
    return list(zip(fa[:n], fb[:n]))


def _load(d: str, names: List[str], size: int,
          device: torch.device) -> torch.Tensor:
    """(B, 3, size, size) float32 images in [-1, 1] on `device`."""
    arr = np.stack([dsm.load_image(os.path.join(d, n), size) for n in names])
    return torch.from_numpy(arr).permute(0, 3, 1, 2).contiguous().to(device)


def temporal_flicker(results_dir: str, gt_dir: str, pairs, size: int,
                     batch_size: int = 8,
                     device: Optional[torch.device] = None
                     ) -> Dict[str, float]:
    """Flicker over CONSECUTIVE frames: temporal_l1 = mean |f_t - f_{t-1}|
    of the renders, temporal_l1_gt the same of the ground truth (its own
    motion), flicker_ratio their ratio (1 = the GT's temporal variation,
    > 1 flicker, < 1 over-smoothing)."""
    device = device if device is not None else resolve_device("0")

    def seq_l1(d, names):
        total, n = 0.0, 0
        for s in range(0, len(names) - 1, batch_size):
            chunk = [(names[i], names[i + 1])
                     for i in range(s, min(s + batch_size, len(names) - 1))]
            a = _load(d, [p[0] for p in chunk], size, device)
            b = _load(d, [p[1] for p in chunk], size, device)
            total += float((a - b).abs().flatten(1).mean(1).sum())
            n += len(chunk)
        return total / max(n, 1)

    with torch.no_grad():
        res_l1 = seq_l1(results_dir, [p[0] for p in pairs])
        gt_l1 = seq_l1(gt_dir, [p[1] for p in pairs])
    return {"temporal_l1": res_l1, "temporal_l1_gt": gt_l1,
            "flicker_ratio": res_l1 / max(gt_l1, 1e-8)}


def evaluate_dirs(results_dir: str, gt_dir: str, size: int = 512,
                  batch_size: int = 8, max_frames: Optional[int] = None,
                  use_vgg: bool = True, use_lpips: bool = False,
                  lpips_weights: str = "", use_temporal: bool = False,
                  device: Optional[torch.device] = None) -> Dict[str, float]:
    """Mean PSNR / SSIM (and vgg_dist, lpips, the flicker metrics) over the
    paired frames, plus their count as ``frames``. ``device`` defaults to
    the card. The VGG is ``models.vgg.build_vgg`` in bfloat16 (a
    torchvision VGG19 at $VGG19_WEIGHTS, else seeded random features);
    with both distances asked for, one VGG pass feeds both."""
    device = device if device is not None else resolve_device("0")
    pairs = pair_frames(results_dir, gt_dir)
    if max_frames is not None:
        pairs = pairs[:max_frames]
    vgg = lin = None
    if use_vgg or use_lpips:
        vgg = build_vgg(dtype=torch.bfloat16).to(device)
    if use_lpips:
        lin = get_lin_weights(lpips_weights)

    sums: Dict[str, float] = {}
    with torch.no_grad():
        for start in range(0, len(pairs), batch_size):
            chunk = pairs[start:start + batch_size]
            # pad the tail to the batch size, as the JAX package does for
            # its compiled shape; padded entries are dropped below
            padded = chunk + [chunk[-1]] * (batch_size - len(chunk))
            a = _load(results_dir, [p[0] for p in padded], size, device)
            b = _load(gt_dir, [p[1] for p in padded], size, device)
            vals = {"psnr": M.psnr(a, b), "ssim": M.ssim(a, b)}
            if vgg is not None:
                fa, fb = vgg(a), vgg(b)
                if use_vgg:
                    vals["vgg_dist"] = M.vgg_distance_taps(fa, fb)
                if use_lpips:
                    vals["lpips"] = lpips_taps(fa, fb, lin)
            for k, v in vals.items():
                sums[k] = sums.get(k, 0.0) + float(v[:len(chunk)].sum())
    out = {k: v / len(pairs) for k, v in sums.items()}
    if use_temporal and len(pairs) > 1:
        out.update(temporal_flicker(results_dir, gt_dir, pairs, size,
                                    batch_size, device))
    out["frames"] = float(len(pairs))
    return out


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(
        description="PSNR / SSIM / perceptual parity between two frame "
                    "directories (PyTorch port)")
    p.add_argument("--results_dir", required=True,
                   help="rendered frames (the serving driver's images dir)")
    p.add_argument("--gt_dir", required=True,
                   help="ground-truth / reference frames")
    p.add_argument("--loadSize", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_frames", type=int, default=0, help="0 = all")
    p.add_argument("--no_vgg", action="store_true",
                   help="skip the VGG perceptual distance")
    p.add_argument("--metric", default="",
                   help="extra metrics, comma list: 'lpips' adds LPIPS (the "
                        "uniform linear head unless --lpips_weights or "
                        "$LPIPS_WEIGHTS names the official one), "
                        "'temporal' the consecutive-frame flicker against "
                        "the GT's own motion")
    p.add_argument("--lpips_weights", default="",
                   help="LPIPS linear-head checkpoint (.pth of the lpips "
                        "package, or .npz with lin{i} arrays)")
    p.add_argument("--out", default="", help="also write the JSON line here")
    p.add_argument("--gpu_ids", default="0",
                   help="the CUDA device index; -1 for the CPU")
    a = p.parse_args(argv)

    extra = {m.strip() for m in a.metric.split(",") if m.strip()}
    unknown = extra - {"lpips", "temporal"}
    if unknown:
        p.error(f"--metric accepts 'lpips' and/or 'temporal' (got "
                f"{sorted(unknown)}); PSNR/SSIM are always computed and "
                "the VGG distance is controlled by --no_vgg")
    res = evaluate_dirs(a.results_dir, a.gt_dir, a.loadSize, a.batch_size,
                        a.max_frames or None, use_vgg=not a.no_vgg,
                        use_lpips="lpips" in extra,
                        lpips_weights=a.lpips_weights,
                        use_temporal="temporal" in extra,
                        device=resolve_device(a.gpu_ids))
    line = json.dumps({k: round(v, 5) for k, v in res.items()})
    print(line, flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return res
