"""Host points: steps of a captured closure that must run on the host.

A collective of the data-parallel ranks (``parallel/mesh.py``) cannot run
inside a CUDA graph under gloo. The transport calls ``host_point(fn)``;
while a capture (``train/graphs.py``) is under way in this thread, the
capture ends its graph there, runs fn, and runs it again between the same
two graphs on every replay. Outside a capture fn simply runs.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator

_capture = threading.local()


def host_point(fn: Callable[[], None]) -> None:
    """Run ``fn``, a host step inside a captured closure: now when no
    capture is under way in this thread, else through the capture's
    ``split(fn)``. fn must work in place on tensors that outlive it."""
    cap = getattr(_capture, "active", None)
    if cap is None:
        fn()
    else:
        cap.split(fn)


@contextlib.contextmanager
def capturing(cap) -> Iterator[None]:
    """Route this thread's host points to ``cap`` (an object with
    ``split(fn)``) while the block runs."""
    _capture.active = cap
    try:
        yield
    finally:
        _capture.active = None
