"""Share of the traced rendering window with no operation on the card, in percent."""

from perfbench.harness import readers


def read(r):
    return readers.idle_share(r, "render")
