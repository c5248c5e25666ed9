"""Stage-1 person-agnostic UV pretrain of TransG, the port's pre_train.py:

    python -m neural_human_video_rendering_tpu_torch.pre_train <pre_train.py flags>

(--gpu_ids -1 for the CPU; the card otherwise).
"""

import sys

from .config import TrainOptions
from .train.drivers import run_pretrain_uv


def main(argv=None) -> int:
    run_pretrain_uv(TrainOptions().parse(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
