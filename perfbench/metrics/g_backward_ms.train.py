"""Median, over the traced steps, of the device-clock milliseconds of a train-step replay from the end of the renderer's forward to the end of G's backward (the discriminator for G, VGG, the losses and the generator's backward), from the program's device marks step.g_forward.end and step.g_backward.end; None where the program records no such mark."""

import statistics


def read(r):
    if r.get("kind") != "train":
        return None
    try:
        from neural_human_video_rendering_tpu_torch.utils import spans
    except ImportError:       # a program without the recorder
        return None
    ms = spans.device_intervals("step.g_forward.end", "step.g_backward.end")
    return statistics.median(ms) if ms else None
