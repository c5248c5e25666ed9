"""Texture-generator pretrain of TexG, the port's pre_train_tex.py:

    python -m neural_human_video_rendering_tpu_torch.pre_train_tex <pre_train_tex.py flags>

(--gpu_ids -1 for the CPU; the card otherwise).
"""

import sys

from .config import TrainOptions
from .train.drivers import run_pretrain_tex


def main(argv=None) -> int:
    run_pretrain_tex(TrainOptions().parse(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
