"""Median, over the traced steps, of the device-clock milliseconds from the end of one train-step replay to the start of the next (the upload and the host's work before it), from the program's device marks step.replay.end and step.replay.begin."""

import statistics


def read(r):
    if r.get("kind") != "train":
        return None
    try:
        from neural_human_video_rendering_tpu_torch.utils import spans
    except ImportError:       # a program without the recorder
        return None
    ms = spans.device_intervals("step.replay.end", "step.replay.begin")
    return statistics.median(ms) if ms else None
