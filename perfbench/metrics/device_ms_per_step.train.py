"""Kernel time a train step, from the profiler, in milliseconds."""

from perfbench.harness import readers


def read(r):
    return readers.device_ms_per_unit(r, "train")
