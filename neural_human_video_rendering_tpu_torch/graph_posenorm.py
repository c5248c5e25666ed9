"""Cross-person pose retargeting, the port's graph_posenorm.py:

    python -m neural_human_video_rendering_tpu_torch.graph_posenorm \\
        --target_keypoints TGT --source_keypoints SRC --results OUT \\
        [--target_shape H W C] [--source_shape H W C] \\
        [--target_spread MIN MAX] [--source_spread MIN MAX] \\
        [--source_frames FRAMES] [--calculate_scale_translation]

The flags of the reference's run_alignPose.sh (launchers/run_align_pose.sh
runs unchanged). Fits a global scale + translation from the two keypoint
corpora and rewrites the source keypoint JSONs into the target frame
(``data/pose_align.py``), with align_meta.json beside them.
"""

import argparse
import sys

from .data import pose_align


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--target_keypoints", required=True)
    p.add_argument("--source_keypoints", required=True)
    p.add_argument("--target_shape", type=int, nargs=3, default=[1024, 1024, 3])
    p.add_argument("--source_shape", type=int, nargs=3, default=[1024, 1024, 3])
    p.add_argument("--source_frames", default="")
    p.add_argument("--results", required=True)
    p.add_argument("--target_spread", type=float, nargs=2, default=[0.0, 1e9])
    p.add_argument("--source_spread", type=float, nargs=2, default=[0.0, 1e9])
    p.add_argument("--calculate_scale_translation", action="store_true")
    args = p.parse_args(argv)

    s, t = pose_align.fit_scale_translation(
        args.target_keypoints, args.source_keypoints,
        tuple(args.target_spread), tuple(args.source_spread),
        target_shape=tuple(args.target_shape[:2]),
        source_shape=tuple(args.source_shape[:2]))
    print(f"scale: {s:.4f}  translation: ({t[0]:.2f}, {t[1]:.2f})")
    n = pose_align.align_pose_dir(args.source_keypoints, args.results, s, t)
    print(f"wrote {n} aligned keypoint files -> {args.results}")
    pose_align.write_align_meta(args.results, s, t,
                                tuple(args.target_shape[:2]),
                                tuple(args.source_shape[:2]))
    if args.source_frames:
        m = pose_align.write_debug_overlays(args.source_frames, args.results,
                                            tuple(args.target_shape[:2]))
        print(f"wrote {m} debug overlays -> {args.results}/overlay")
    return 0


if __name__ == "__main__":
    sys.exit(main())
