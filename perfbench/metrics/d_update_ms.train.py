"""Median, over the traced steps, of the device-clock milliseconds of a train-step replay from the end of G's backward to its last graph's end (D's forward and backward, both Adam updates and the EMA), from the program's device marks step.g_backward.end and step.replay.end; None where the program records no such mark."""

import statistics


def read(r):
    if r.get("kind") != "train":
        return None
    try:
        from neural_human_video_rendering_tpu_torch.utils import spans
    except ImportError:       # a program without the recorder
        return None
    ms = spans.device_intervals("step.g_backward.end", "step.replay.end")
    return statistics.median(ms) if ms else None
