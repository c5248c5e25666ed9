"""Generic 64 px two-arm A/B gate, base against base + a lever's flags on
the same corpus: the port of the JAX package's tools/round5/arm_ab64.py
(the same flags and JSON keys, plus --keypoints and --gpu_ids), on
ms_uv_ab64's training and scoring.

    python -m neural_human_video_rendering_tpu_torch.arm_ab64 \\
        --name limb_coords --arm_flags=--limb_coords \\
        --arm_kw '{"limb_coords": true}' --out limb_coords_64px.json \\
        --keypoints KEYPOINT_DIR [--gpu_ids -1]

--arm_flags (given with "=": its value starts with "--") are appended to
the lever arm's pre_train and train; --arm_kw is the matching Options
override of its scoring forward (a lever that changes input channels
changes parameter shapes). Both arms are trained
before either is scored, so the A/B is symmetric and a killed run leaves
no arm scored before the other was trained. --work (default: beside
--out) holds the corpus, the run dirs and run.log.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import ms_uv_ab64 as ab
from . import noisy_gt_ab as nab


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ab.add_common(p)
    p.add_argument("--name", required=True, help="lever arm name")
    p.add_argument("--arm_flags", default="",
                   help="space-separated CLI flags for the lever arm")
    p.add_argument("--arm_kw", default="{}",
                   help="JSON Options overrides for scoring the lever arm")
    p.add_argument("--work", default=None,
                   help="work dir (default: ab64_NAME beside --out)")
    a = p.parse_args(argv)
    a.work = a.work or os.path.join(
        os.path.dirname(os.path.abspath(a.out)), f"ab64_{a.name}")

    os.makedirs(a.work, exist_ok=True)
    log = os.path.join(a.work, "run.log")
    data = os.path.join(a.work, "data")
    nab.build_corpus(data, a.size, a.tile, a.keypoints, log)

    arms = {"base": ([], {}),
            a.name: (a.arm_flags.split(), json.loads(a.arm_kw))}
    summary = {"config": {"size": a.size, "epochs": a.epochs,
                          "pre_epochs": a.pre_epochs, "seed": a.seed,
                          "arm_flags": a.arm_flags, "sizes": ab.SIZES}}
    ab.run_arms(a, arms, summary, log, data)
    ab.finish(a, summary, a.name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
