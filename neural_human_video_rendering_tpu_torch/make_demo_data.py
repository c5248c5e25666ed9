"""Fabricate a learnable corpus in the reference's data layout from a
keypoint sequence: the port of the JAX package's tools/make_demo_data.py
(the same flags; ``data/synthetic_video.py`` has the construction).

    python -m neural_human_video_rendering_tpu_torch.make_demo_data \\
        --keypoints KEYPOINT_DIR --out DATA [--size 512 --tile 64 \\
        --sampling bilinear --corrupt 0.5]

The stage-1 and stage-2 trainers and the serving driver read the tree it
writes with path flags only. The JAX tool defaults --keypoints to the
reference checkout's demo keypoints; here the directory is given.
Host work only (numpy and OpenCV): no device.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .data import synthetic_video as sv


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--tile", type=int, default=64)
    p.add_argument("--keypoints", required=True,
                   help="driving OpenPose JSON dir (the reference demo's "
                        "keypoints, or any sequence)")
    p.add_argument("--repeat", type=int, default=1,
                   help="loop the sequence N times for a longer corpus")
    p.add_argument("--people", type=int, default=1,
                   help="pool N body-proportion variants of the sequence "
                        "(a person-agnostic stage-1 corpus)")
    p.add_argument("--laplace_ch", type=int, default=0)
    p.add_argument("--corrupt", type=float, default=0.0,
                   help="0..1: corrupt the pseudo-GT (mask / densepose / bg) "
                        "at this strength while the frames stay true "
                        "(data/corruption.py)")
    p.add_argument("--corrupt_seed", type=int, default=0)
    p.add_argument("--sampling", default="nearest",
                   choices=["nearest", "bilinear"],
                   help="atlas sampling of the true frames: bilinear makes "
                        "float-precision reconstruction reachable by the "
                        "(bilinearly warping) model; nearest caps it near "
                        "45 dB")
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = parse(argv)
    if not os.path.isdir(a.keypoints):
        raise FileNotFoundError(f"--keypoints: no directory {a.keypoints}")
    joints = sv.load_reference_joints(a.keypoints, a.size)
    if a.repeat > 1:
        joints = np.concatenate([joints] * a.repeat)
    cuts = ()
    if a.people > 1:
        pool = [sv.person_variant(joints, a.size, p_) for p_ in range(a.people)]
        cuts = tuple(len(joints) * p_ for p_ in range(1, a.people))
        joints = np.concatenate(pool)
    os.makedirs(a.out, exist_ok=True)
    paths = sv.write_corpus(a.out, joints, size=a.size, tile=a.tile,
                            laplace_ch=a.laplace_ch, cuts=cuts,
                            corrupt=a.corrupt, corrupt_seed=a.corrupt_seed,
                            sampling=a.sampling)
    print(f"wrote {len(joints)} frames -> {a.out}")
    for k, v in sorted(paths.items()):
        print(f"  {k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
