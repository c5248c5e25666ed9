"""Fabricate a "source person" keypoint set for the pose-transfer check:
the port of the JAX package's tools/round4/fabricate_source.py (the same
flags; the same bytes out).

Every OpenPose JSON in --src is re-expressed as another person on another
canvas by the affine map (x, y) -> scale * (x, y) + shift, confidences
kept and absent joints (0, 0) left at 0. graph_posenorm and the serving
driver's --pose_tgt_path must then recover the inverse transform.
Defaults: scale 1.3, shift (30, 120) (expected inverse: scale 1/1.3,
translation -(30, 120)/1.3).

    python -m neural_human_video_rendering_tpu_torch.fabricate_source \\
        --src KEYPOINT_DIR --out OUT_DIR [--scale 1.3 --shift 30 120]

Host only: no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="dir of OpenPose JSONs")
    ap.add_argument("--out", required=True)
    ap.add_argument("--scale", type=float, default=1.3)
    ap.add_argument("--shift", type=float, nargs=2, default=(30.0, 120.0))
    ns = ap.parse_args(argv)
    os.makedirs(ns.out, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(ns.src)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(ns.src, name)) as f:
            data = json.load(f)
        for person in data.get("people", []):
            for key, val in person.items():
                if not key.endswith("_keypoints_2d") or not val:
                    continue
                out = list(val)
                for i in range(0, len(out) - 2, 3):
                    if out[i] or out[i + 1]:   # absent joints stay at 0
                        out[i] = out[i] * ns.scale + ns.shift[0]
                        out[i + 1] = out[i + 1] * ns.scale + ns.shift[1]
                person[key] = out
        with open(os.path.join(ns.out, name), "w") as f:
            json.dump(data, f)
        n += 1
    print(f"[fabricate_source] {n} JSONs -> {ns.out} "
          f"(scale {ns.scale}, shift {ns.shift})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
