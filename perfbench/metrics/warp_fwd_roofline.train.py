"""The fused texture-warp forwards' bound (bytes at HBM rate or float32 operations) as a share of their device time in the train step, in percent."""

from perfbench.harness import readers


def read(r):
    return readers.roofline(r, "train", readers.WARP_FWD, "warp_fwd_bound_s")
