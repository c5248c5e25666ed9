"""Spans and device marks: the port's one recorder of where host and device
time goes, kept in memory and read after the fact.

    with span("step.copy_in", rid=3) as s:
        ...
    s.seconds                       # always: two perf_counter_ns reads

A span always takes the host clock at entry and exit, so a caller that
needs the seconds (``Program.capture_s``, ``serve._Model.timing``) gets
them whatever the tracing state. It appends a record (name, start, end,
thread, the enclosing span of the same thread, attrs) only while tracing
is on:

  * while a ``torch.profiler`` session runs anywhere in the process (the
    profiler's process-global flag, read once a span: the benchmark's
    ``--trace 1`` window, the trainer's ``--profile_dir``, ``profile_step``);
  * inside ``recording()``, for tests and operators.

Off, a span costs one flag check and two clock reads; no
``record_function`` is made (about 12 us a span). On, a span opened on
the thread that runs the profiler is also a ``record_function``
annotation of the same name, so it lies on the profiler's timeline by
construction. The profiler records annotations only on its own thread:
the spans of other threads (a server's device thread, its clients, a
loader) are written into a Chrome trace with ``chrome_events``, on the
profiler's clock (the wall clock less the trace's
``baseTimeNanoseconds``), one ``tid`` per thread.

``device_mark(name)`` records a timing CUDA event on the current stream
while tracing is on (nothing otherwise); ``device_intervals(a, b)`` reads
the device-clock milliseconds from each mark ``a`` to the next mark ``b``
after a synchronise. Records and marks are kept in bounded buffers (the
oldest dropped past ``CAP``); ``records(name)`` and ``clear()`` read and
empty them.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

# records, and device marks, kept (each buffer drops its oldest past it)
CAP = 1 << 16

# a perf_counter_ns stamp + SHIFT_NS is the wall clock (time_ns) of the
# same moment
SHIFT_NS = time.time_ns() - time.perf_counter_ns()


class Record(NamedTuple):
    """One closed span: host clock (perf_counter_ns) at entry and exit,
    the native id of its thread, its own id and its parent's (the span
    open around it on the same thread, or None), and its attrs."""
    name: str
    start_ns: int
    end_ns: int
    tid: int
    id: int
    parent: Optional[int]
    attrs: Dict[str, Any]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


_records: "collections.deque[Record]" = collections.deque(maxlen=CAP)
# device marks: (name, CUDA event), in the order recorded
_marks: "collections.deque[tuple]" = collections.deque(maxlen=CAP)
_ids = itertools.count(1)
_stack = threading.local()
_forced = [0]
_forced_lock = threading.Lock()


def tracing() -> bool:
    """Whether spans record now: a profiler session runs, or
    ``recording()`` is open."""
    return _profiler._is_profiler_enabled or _forced[0] > 0


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record every span and device mark of every thread while open (the
    recorder's switch for tests and operators; nests)."""
    with _forced_lock:
        _forced[0] += 1
    try:
        yield
    finally:
        with _forced_lock:
            _forced[0] -= 1


class span:
    """``with span(name, **attrs) as s``: the host clock around the block
    (``s.seconds``), and, while tracing, a record (the module docstring)."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "id", "_annot")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.id = 0
        self.end_ns = 0

    def __enter__(self) -> "span":
        # the clock outside the annotation's enter and exit: the profiler
        # stamps its event early in the one and late in the other
        self.start_ns = time.perf_counter_ns()
        if tracing():
            stack = getattr(_stack, "open", None)
            if stack is None:
                stack = _stack.open = []
            self.id = next(_ids)
            stack.append(self.id)
            # the profiler's own thread: an annotation on its timeline too
            self._annot = (_profiler.record_function(self.name)
                           if torch._C._autograd._profiler_enabled()
                           else None)
            if self._annot is not None:
                self._annot.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.id and self._annot is not None:
            self._annot.__exit__(*exc)
        self.end_ns = time.perf_counter_ns()
        if self.id:
            stack = _stack.open
            stack.pop()
            _records.append(Record(
                self.name, self.start_ns, self.end_ns,
                threading.get_native_id(), self.id,
                stack[-1] if stack else None, self.attrs))

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def records(name: Optional[str] = None) -> List[Record]:
    """The records kept, oldest first (only those of ``name``, if given)."""
    out = list(_records)
    return out if name is None else [r for r in out if r.name == name]


def clear() -> None:
    """Drop every record and device mark."""
    _records.clear()
    _marks.clear()


def device_mark(name: str, device=None) -> None:
    """While tracing, a timing CUDA event on ``device``'s current stream
    (default: the current device's); nothing otherwise, nor for a device
    that is not a CUDA device (the step marks its phases on the CPU too)."""
    if not tracing() or (device is not None
                         and torch.device(device).type != "cuda"):
        return
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    _marks.append((name, event))


def device_intervals(a: str, b: str) -> List[float]:
    """Device-clock milliseconds from each mark ``a`` to the first mark
    ``b`` after it (marks in the order recorded; an ``a`` followed by
    another ``a`` before any ``b`` counts from the later one). Waits for
    the marks it reads."""
    out, start = [], None
    for name, event in list(_marks):
        if name == a:
            start = event
        elif name == b and start is not None:
            event.synchronize()
            out.append(start.elapsed_time(event))
            start = None
    return out


def chrome_events(base_ns: int, recs: Optional[List[Record]] = None
                  ) -> List[dict]:
    """Records (default: all kept) as Chrome-trace complete events on a
    profiler trace's clock: ``ts`` in microseconds from ``base_ns`` (the
    trace's ``baseTimeNanoseconds``) on the wall clock, one ``tid`` per
    thread, the attrs and the span ids under ``args``."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "span", "name": r.name, "pid": pid,
             "tid": r.tid, "ts": (r.start_ns + SHIFT_NS - base_ns) / 1e3,
             "dur": (r.end_ns - r.start_ns) / 1e3,
             "args": dict(r.attrs, id=r.id, parent=r.parent)}
            for r in (records() if recs is None else recs)]
