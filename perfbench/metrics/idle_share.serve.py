"""Share of the traced serving window with no operation on the card, in percent."""

from perfbench.harness import readers


def read(r):
    return readers.idle_share(r, "serve")
