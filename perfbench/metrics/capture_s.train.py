"""Seconds the train step's CUDA-graph captures took (Program.capture_s, summed)."""

from perfbench.harness import readers


def read(r):
    return readers.capture_s(r, "train")
