"""Pseudo-GT corruption: the port of the JAX package's
``data/corruption.py`` (the same calls, so the same numbers).

The frames of a fabricated corpus are observations and stay true; the
pseudo-ground-truth its preprocessing tools would produce is corrupted the
way each tool fails:
  * masks: segmentation errors (dilation or erosion of the silhouette,
    interior holes, false-positive blobs outside it);
  * DensePose IUV: a smooth random displacement of parts and UV together,
    UV quantisation, background dropped along the part boundaries;
  * background: ``cv2.inpaint`` over the region the person covers (the
    artefact an inpainting estimate leaves), plus a low-frequency cast.

Every corruption is deterministic in (seed, frame) and scales with one
``strength`` in [0, 1]; each modality draws its own
``np.random.RandomState`` stream (``_rng``), as the JAX package does, so
both packages write bit-equal corpora.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _rng(seed: int, frame: int, salt: int = 0) -> np.random.RandomState:
    """Per-(seed, frame, modality) stream. The salt keeps the mask / IUV /
    bg corrupters on INDEPENDENT noise — the real preprocessing tools fail
    independently, and a shared stream would couple segmentation errors to
    DensePose wobble across the whole corpus."""
    return np.random.RandomState(
        (seed * 9973 + frame * 7919 + salt * 524287) % (2 ** 31))


def _smooth_field(rng, size: int, cells: int, amp: float) -> np.ndarray:
    """(S, S, 2) smooth random displacement field, |d| <= amp pixels."""
    import cv2
    coarse = rng.uniform(-amp, amp, (cells, cells, 2)).astype(np.float32)
    return cv2.resize(coarse, (size, size), interpolation=cv2.INTER_CUBIC)


def corrupt_mask(mask: np.ndarray, seed: int, frame: int,
                 strength: float) -> np.ndarray:
    """Segmentation-style corruption of a (S, S) {0,1} float mask."""
    import cv2
    if strength <= 0:
        return mask
    S = mask.shape[0]
    rng = _rng(seed, frame, salt=1)
    out = (mask > 0.5).astype(np.uint8)

    # global over/under-segmentation: dilate by up to ~2% of S, or erode by
    # a thinner rim (real segmenters miss a boundary strip, they don't
    # destroy whole limbs — and the capsule person's limbs are only
    # ~3.5% of S wide)
    if rng.rand() < 0.5:
        k = int(round(1 + strength * 0.02 * S + rng.randint(0, 2)))
        kern = cv2.getStructuringElement(cv2.MORPH_ELLIPSE,
                                         (2 * k + 1, 2 * k + 1))
        out = cv2.dilate(out, kern)
    else:
        k = max(1, int(round(strength * 0.006 * S)))
        kern = cv2.getStructuringElement(cv2.MORPH_ELLIPSE,
                                         (2 * k + 1, 2 * k + 1))
        out = cv2.erode(out, kern)

    # interior dropout holes (limbs the segmenter missed)
    ys, xs = np.where(out > 0)
    n_holes = rng.poisson(3 * strength)
    for _ in range(n_holes):
        if len(ys) == 0:
            break
        i = rng.randint(len(ys))
        r = int(rng.uniform(0.01, 0.04 * strength + 0.015) * S)
        cv2.circle(out, (int(xs[i]), int(ys[i])), max(r, 2), 0, -1)

    # false-positive blobs (background clutter segmented as person)
    n_blobs = rng.poisson(1.5 * strength)
    for _ in range(n_blobs):
        cx, cy = rng.randint(0, S), rng.randint(0, S)
        r = int(rng.uniform(0.01, 0.03 * strength + 0.01) * S)
        cv2.circle(out, (cx, cy), max(r, 2), 1, -1)
    return out.astype(np.float32)


def corrupt_iuv(parts: np.ndarray, uv: np.ndarray, seed: int, frame: int,
                strength: float) -> Tuple[np.ndarray, np.ndarray]:
    """DensePose-style corruption of (S,S) int parts + (S,S,2) float UV."""
    import cv2
    if strength <= 0:
        return parts, uv
    S = parts.shape[0]
    rng = _rng(seed, frame, salt=2)

    # detector spatial wobble: one smooth displacement field for all maps
    # (parts and UV move together, like a mislocalized detection)
    amp = strength * 0.015 * S
    field = _smooth_field(rng, S, cells=6, amp=amp)
    ys, xs = np.mgrid[0:S, 0:S].astype(np.float32)
    map_x = np.clip(xs + field[..., 0], 0, S - 1)
    map_y = np.clip(ys + field[..., 1], 0, S - 1)
    parts_c = cv2.remap(parts.astype(np.float32), map_x, map_y,
                        cv2.INTER_NEAREST).astype(np.int32)
    uv_c = cv2.remap(uv, map_x, map_y, cv2.INTER_NEAREST)

    # UV quantization: real DensePose UV is coarse; quantize to q levels
    q = max(int(round(48 * (1 - strength) + 8 * strength)), 4)
    uv_c = np.round(uv_c * (q - 1)) / (q - 1)

    # boundary erosion: thin strip at part boundaries drops to background
    # (the detector's uncertain rim)
    body = (parts_c > 0).astype(np.uint8)
    k = max(int(round(strength * 0.008 * S)), 1)
    kern = cv2.getStructuringElement(cv2.MORPH_ELLIPSE,
                                     (2 * k + 1, 2 * k + 1))
    eroded = cv2.erode(body, kern)
    rim = (body > 0) & (eroded == 0)
    drop = rim & (rng.rand(S, S) < 0.5 * strength)
    parts_c[drop] = 0
    uv_c[parts_c == 0] = 0.0
    return parts_c, uv_c.astype(np.float32)


def occupancy(masks_sum: np.ndarray, n_frames: int) -> np.ndarray:
    """(S, S) uint8 region the person ever covers (for bg inpainting)."""
    import cv2
    occ = (masks_sum > max(1, 0.02 * n_frames)).astype(np.uint8)
    k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (9, 9))
    return cv2.dilate(occ, k)


def corrupt_bg(bg: np.ndarray, occ: np.ndarray, seed: int,
               strength: float) -> np.ndarray:
    """Inpainting-estimate corruption of a (S,S,3) [-1,1] background.

    Runs real cv2.inpaint over the occupancy region — the bg estimate the
    reference consumes is EXACTLY such an inpaint (README.md:52) — then
    adds a low-frequency color cast scaled by strength."""
    import cv2
    if strength <= 0:
        return bg
    S = bg.shape[0]
    rng = _rng(seed, 0, salt=3)
    u8 = ((np.clip(bg, -1, 1) + 1) * 127.5).astype(np.uint8)
    inpainted = cv2.inpaint(u8, (occ > 0).astype(np.uint8), 7,
                            cv2.INPAINT_TELEA)
    out = inpainted.astype(np.float32) / 127.5 - 1.0
    cast = _smooth_field(rng, S, cells=4, amp=0.12 * strength)
    out += np.concatenate([cast, cast[..., :1] * 0.5], axis=-1)
    return np.clip(out, -1, 1).astype(np.float32)
