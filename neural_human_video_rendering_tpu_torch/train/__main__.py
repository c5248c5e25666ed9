"""Stage-2 end-to-end training, the port's train.py:

    python -m neural_human_video_rendering_tpu_torch.train <train.py flags>

(--gpu_ids -1 for the CPU; the card otherwise).
"""

import sys

from ..config import TrainOptions
from .drivers import run_train


def main(argv=None) -> int:
    run_train(TrainOptions().parse(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
