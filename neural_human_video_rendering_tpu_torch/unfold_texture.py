"""The static texture atlas from frames and DensePose, the port's
unfold_texture.py:

    python -m neural_human_video_rendering_tpu_torch.unfold_texture \\
        FRAME_DIR DENSEPOSE_DIR [--out texture.jpg] [--tile 128] [--max_frames 500]

Writes the 4 x 6 grid of the 24 part tiles (``data/texture_unfold.py``)
to --out, by default texture.jpg beside the frame directory.
"""

import argparse
import os
import sys

from .data.texture_unfold import unfold_texture


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("frame_dir")
    p.add_argument("densepose_dir")
    p.add_argument("--out", default="")
    p.add_argument("--tile", type=int, default=128)
    p.add_argument("--max_frames", type=int, default=500)
    args = p.parse_args(argv)
    out = args.out or os.path.join(os.path.dirname(args.frame_dir.rstrip("/")),
                                   "texture.jpg")
    path = unfold_texture(args.frame_dir, args.densepose_dir, out,
                          tile=args.tile, max_frames=args.max_frames)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
