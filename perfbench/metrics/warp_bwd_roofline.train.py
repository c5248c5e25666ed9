"""The texture-warp backward's bound as a share of its device time in the train step, in percent."""

from perfbench.harness import readers


def read(r):
    return readers.roofline(r, "train", readers.WARP_BWD, "warp_bwd_bound_s")
