"""Median, over the traced steps, of the device-clock milliseconds of a train-step replay from the end of E's forward to the end of the per-part pooling (the argmax of TransG's part probabilities, its one-hot, each part's mean of E's channels and their broadcast back), from the program's device marks step.feat.encoded and step.feat.end; None where the program records no such mark (a configuration without E, or a program without the marks)."""

import statistics


def read(r):
    if r.get("kind") != "train":
        return None
    try:
        from neural_human_video_rendering_tpu_torch.utils import spans
    except ImportError:       # a program without the recorder
        return None
    ms = spans.device_intervals("step.feat.encoded", "step.feat.end")
    return statistics.median(ms) if ms else None
