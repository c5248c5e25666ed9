"""Median, over the traced steps, of the device-clock milliseconds of a train-step replay, from the stream reaching it to its last graph's end, from the program's device marks step.replay.begin and step.replay.end."""

import statistics


def read(r):
    if r.get("kind") != "train":
        return None
    try:
        from neural_human_video_rendering_tpu_torch.utils import spans
    except ImportError:       # a program without the recorder
        return None
    ms = spans.device_intervals("step.replay.begin", "step.replay.end")
    return statistics.median(ms) if ms else None
