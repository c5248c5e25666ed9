"""The arithmetic of the per-layer metrics, from a run's readings.

Every reader returns None where its run has nothing to read (another
kind of traffic, or no traced window), and never 0 for a share of a
roofline or a peak. ``units`` are the steps, batches or requests in the
traced window; ``trace["window_s"]`` is its length on the host's clock.
"""

from __future__ import annotations

from typing import Optional

from .counts import BF16_FLOPS

WARP_FWD = ("texture_warp_fwd_kernel", "texel_major_kernel")
WARP_BWD = ("texture_warp_bwd_kernel",)


def _traced(r: dict, kind: str) -> Optional[dict]:
    if r.get("kind") != kind:
        return None
    return r.get("trace")


def idle_share(r: dict, kind: str) -> Optional[float]:
    t = _traced(r, kind)
    if t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(r: dict, kind: str) -> Optional[float]:
    t = _traced(r, kind)
    if t is None or not r.get("flops"):
        return None
    return 100.0 * r["flops"] * r["units"] / t["window_s"] / BF16_FLOPS


def device_ms_per_unit(r: dict, kind: str) -> Optional[float]:
    t = _traced(r, kind)
    if t is None:
        return None
    return 1e3 * sum(t["kernel_s"].values()) / r["units"]


def kernel_s(t: dict, names) -> float:
    return sum(s for k, s in t["kernel_s"].items()
               if any(n in k for n in names))


def roofline(r: dict, kind: str, names, bound_key: str) -> Optional[float]:
    """The bound's share of the named kernels' device time in the traced
    window, in percent."""
    t = _traced(r, kind)
    if t is None or not r.get(bound_key):
        return None
    spent = kernel_s(t, names)
    if spent <= 0:
        return None
    return 100.0 * r[bound_key] * r["units"] / spent


def capture_s(r: dict, kind: str) -> Optional[float]:
    if r.get("kind") != kind or "capture_s" not in r:
        return None
    return r["capture_s"]


def served_ms(r: dict, key: str, q: float) -> Optional[float]:
    """The q-th percentile of a served request's part, in milliseconds:
    "forward_s" (the device call as the served program times it) or
    "queue_s" (its latency from due time less that call and the copy to
    the host: the wait for the lock and the device thread)."""
    from .window import percentile
    if r.get("kind") != "serve" or not r.get(key):
        return None
    return 1e3 * percentile(r[key], q)
