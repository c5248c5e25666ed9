"""The rendering forward's convolution and matrix operations a second, as a share of the card's bfloat16 peak, in percent."""

from perfbench.harness import readers


def read(r):
    return readers.mfu(r, "render")
