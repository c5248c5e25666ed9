"""Median, over the traced steps, of the device-clock milliseconds of a train-step replay from the stream reaching it to the end of the renderer's forward (the inputs, the generators, and under temporal_prev fake the t-1 render), from the program's device marks step.replay.begin and step.g_forward.end; None where the program records no such mark."""

import statistics


def read(r):
    if r.get("kind") != "train":
        return None
    try:
        from neural_human_video_rendering_tpu_torch.utils import spans
    except ImportError:       # a program without the recorder
        return None
    ms = spans.device_intervals("step.replay.begin", "step.g_forward.end")
    return statistics.median(ms) if ms else None
