"""The device's timeline from ``torch.profiler``: busy time, kernel time
by name, and the idle gaps labelled by what the host was doing.

The union of the CUDA kernel, memcpy and memset intervals is the busy
time (``union_s``: a frozen copy of the port's ``profile_step._union_ms``
arithmetic). A gap between two busy intervals is labelled by the
innermost host event open at its start: a span of the harness
(``record_function``), an aten op or a CUDA runtime call.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime")
NO_HOST = "(no host event open)"


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The idle (start, end) stretches between the merged intervals."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def summarize(events: List[dict], window_s: float, top: int = 10) -> Dict:
    """Chrome-trace events (times in microseconds) of one traced window ->
    busy_s, kernel seconds and launches by name, the longest device ops
    and the idle time by host label."""
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS and "dur" in e]
    if not device:
        raise RuntimeError("the profiler's trace holds no device event: "
                           "no kernel ran on the card, or CUPTI traced none")
    iv = [(e["ts"], e["ts"] + e["dur"]) for e in device]
    kernel_s: Dict[str, float] = defaultdict(float)
    kernel_n: Dict[str, int] = defaultdict(int)
    for e in device:
        kernel_s[e["name"]] += e["dur"] / 1e6
        kernel_n[e["name"]] += 1
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                   and "dur" in e), key=lambda h: h[0])
    idle: Dict[str, float] = defaultdict(float)
    active: List[Tuple[float, float, str]] = []
    i = 0
    for s, e in gaps(iv):
        while i < len(host) and host[i][0] <= s:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= s]
        inner = min(active, key=lambda h: h[1] - h[0], default=None)
        idle[inner[2] if inner else NO_HOST] += (e - s) / 1e6
    ranked = sorted(kernel_s.items(), key=lambda kv: -kv[1])
    return {"busy_s": union_s(iv) / 1e6, "window_s": window_s,
            "kernel_s": dict(kernel_s), "kernel_n": dict(kernel_n),
            "device_ops": [[_short(n), s] for n, s in ranked[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]]}


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


class Tracer:
    """Profiles the device between ``start()`` and ``stop()``; each
    boundary synchronises the card, and the host clock between them is
    the traced window."""

    def __init__(self, device):
        """Starts and stops the profiler once, so that CUPTI's first
        start is not paid inside the window."""
        from torch.profiler import ProfilerActivity, profile
        self.device = device
        self.prof = None
        self.t0 = self.t1 = 0.0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            pass

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()

    def stop(self) -> Dict:
        import torch
        torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        self.prof = None
        return summarize(events, self.t1 - self.t0)


def span(name: str):
    """A harness span on the host timeline (a no-op unless profiling)."""
    from torch.profiler import record_function
    return record_function(name)
