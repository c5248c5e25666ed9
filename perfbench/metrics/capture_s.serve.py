"""Seconds the served program's CUDA-graph capture took (Program.capture_s)."""

from perfbench.harness import readers


def read(r):
    return readers.capture_s(r, "serve")
