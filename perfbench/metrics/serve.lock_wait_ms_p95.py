"""95th percentile of a request's wait for the served program's lock (the span serve.lock_wait), over the requests recorded in the traced window, in milliseconds."""

from perfbench.harness.window import percentile


def read(r):
    if r.get("kind") != "serve":
        return None
    try:
        from neural_human_video_rendering_tpu_torch.utils import spans
    except ImportError:       # a program without the recorder
        return None
    waits = [s.seconds for s in spans.records("serve.lock_wait")]
    return 1e3 * percentile(waits, 95) if waits else None
