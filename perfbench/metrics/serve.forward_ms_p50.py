"""Median of the served program's device call (serve._Model.timing forward_s) over all requests, in milliseconds."""

from perfbench.harness import readers


def read(r):
    return readers.served_ms(r, "forward_s", 50)
