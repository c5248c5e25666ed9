"""Median, over the traced steps, of the device-clock milliseconds of a train-step replay spent in pix2pixHD's feature encoder E's forward (the real frame t in, E's feat_num channels at full resolution out), from the program's device marks step.feat.begin and step.feat.encoded; None where the program records no such mark (a configuration without E, or a program without the marks)."""

import statistics


def read(r):
    if r.get("kind") != "train":
        return None
    try:
        from neural_human_video_rendering_tpu_torch.utils import spans
    except ImportError:       # a program without the recorder
        return None
    ms = spans.device_intervals("step.feat.begin", "step.feat.encoded")
    return statistics.median(ms) if ms else None
