"""Retroactively dedupe run dirs' metrics.jsonl (superseded series): the
port of the JAX package's tools/round5/dedup_metrics.py.

    python -m neural_human_video_rendering_tpu_torch.dedup_metrics \\
        RUN_DIR [RUN_DIR ...]

Applies the resume-prune rule over each whole file
(``utils.visualizer.dedup_metrics``): records superseded by a later
restart of the same epochs are dropped, so a curve holds one record set
an epoch. Only for run dirs with no live trainer attached.
"""

from __future__ import annotations

import sys

from .utils.visualizer import dedup_metrics


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        sys.exit(__doc__)
    total = 0
    for run_dir in argv:
        n = dedup_metrics(run_dir)
        print(f"{run_dir}: dropped {n}")
        total += n
    print(f"total dropped: {total}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
