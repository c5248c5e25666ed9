"""The fused texture-warp forward's bound as a share of its device time in a rendered batch, in percent."""

from perfbench.harness import readers


def read(r):
    return readers.roofline(r, "render", readers.WARP_FWD, "warp_fwd_bound_s")
