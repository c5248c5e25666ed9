"""Captured programs: the port's counterpart of the JAX package's jitted
steps (``jax.jit(step, donate_argnums=(0,))``, ``jax.jit(fwd)``).

A ``Program`` turns a closure into one device program per input signature,
as jit traces one per shape: on the card a CUDA graph, replayed with the
host out of the loop. What a signature's first call does:

  * the inputs (the host batch, already split into tensors) get static
    device buffers, and every later call copies its inputs into them;
  * the closure runs ``WARMUP`` times on a side stream (cuDNN picks its
    algorithms, the warp backward raises its shared-memory opt-in), with
    the state the closure updates saved before and restored after, so the
    warm-up leaves no trace: the first replay is the signature's first
    step, as jit's first call is. The saved copy is kept in pinned host
    memory, and the side stream's cached blocks are handed back to the
    card after the warm-up (the capture allocates in a pool of its own,
    which cannot reuse them), so a capture's peak stays near an eager
    step's (the warm-up's gradients are dropped with them: a captured
    closure sets its own);
  * the closure runs once more under capture, in a private memory pool
    of its own. A host point inside it
    (``utils/host_point.py``: a collective of the data-parallel ranks,
    which gloo cannot run inside a graph) ends the graph being captured,
    runs on the host and opens the next graph in the same memory pool, so
    a program is a chain of graphs with host steps between them;
  * the kernel wrappers' launch counters count the launches of the steps
    the program ran, one step's worth a replay, as they count the eager
    closure's: a replay does not pass through the wrappers, so it adds
    the launches its capture recorded (computed, not seen). The warm-up
    calls do launch every kernel on the card, but their effects are
    undone and they belong to no step: the counters are put back after
    them, and the program keeps those launches apart, in
    ``warmup_launches``. The capture itself launches nothing.

The outputs are cloned out of the graph's pool on every replay, so a
caller may keep them, as it keeps jit's fresh arrays. A capture that
fails raises, naming the call that broke it: there is no fallback.

Each capture keeps the allocator's record (``Program.memory``): the bytes
reserved at its start, after the state's copy, after the warm-up, after
the release and after the capture, the bytes its pool holds and the peak
reserved. Each capture keeps a pool of its own, which holds the step's
activations: sharing one across a program's signatures would save memory
only at a second signature (a partial last batch, a freeze boundary), not
at a program's peak.

A caught out-of-memory error is refused. While it picks an algorithm,
cuDNN catches an out-of-memory error on a plan's workspace and takes the
next plan, which rounds differently, so a step that went on after one
computes other bits than the same step on a free card. The warm-up and
the capture run inside ``refuse_caught_ooms``: where the allocator's
count of out-of-memory errors (``num_ooms``) rose and the closure still
returned, it raises ``CaughtOutOfMemory``, naming the program, the ops'
lines (an observer of the allocator's errors, attached once a process),
the bytes asked and free and the allocator record; the capture is not
stored and its pool goes. The JAX package's compiled step either fits or
stops with RESOURCE_EXHAUSTED, and so does this one: nothing on the
trainers' or the server's path catches the error. There is no second
capture and no eager fallback: PyTorch keeps one cuDNN plan a shape for
the process, the first that fitted, so a second capture after
``torch.cuda.empty_cache()`` runs the fallback plan again and catches
nothing (``graph_memory_probe --routes`` with 30 GB free on the H100:
the same G err/tol 107 against the eager threads as the first capture's),
and an eager step at that free memory caught an error of its own and
read 0.094, not the free card's 6.3e-4. The eager closure beside a
program (a step called with ``mark``, ``train/steps.py``) runs every call
inside the same check: a cached plan that stops fitting is searched again.

The callers (the forward and the steps of ``train/steps.py``, the server
of ``serve.py``) reach their program through one ``Dispatch``: it takes
the eager route or the program's, drops the captures when the objects
the graphs address change and prints each route once. The CPU has no
graphs: there ``program_for`` gives none and the eager closure runs.
``StandIn`` is a capture that records nothing and replays by running the
closure again, which lets the CPU tests drive a Program's bookkeeping
(they patch ``program_for`` to hand out stand-ins).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import traceback
from typing import (Any, Callable, Dict, Hashable, List, Optional, Sequence,
                    Tuple)

import torch

from ..models.layers import conv_counts
from ..models.renderer import feat_counts
from ..ops import adam_ema_kernel as ak
from ..ops import flow_warp_kernel as fk
from ..ops import texture_warp_kernel as tk
from ..utils.host_point import capturing, host_point  # noqa: F401
from ..utils.spans import device_mark, span
from .state import adam_counts

# calls of the closure on the side stream before a capture
WARMUP = 3


def kernel_counters() -> list:
    """(wrapper, attribute) of every launch counter of the CUDA kernel
    wrappers (``launches``, and ``launches_keep_w`` of the fused
    forward), which the programs keep true."""
    wrappers = [tk.topk_select, tk.texture_warp_fwd, tk.texture_warp_topk_fwd,
                tk.texture_warp_bwd, fk.flow_warp_fwd, ak.adam_ema]
    return [(w, a) for w in wrappers for a in sorted(vars(w))
            if a.startswith("launches")]


def _engaged() -> tuple:
    """The engagement counters a capture line prints, as one tuple:
    conv_counts, adam_counts, feat_counts."""
    return conv_counts() + adam_counts() + feat_counts()


def _counts() -> list:
    return [getattr(w, a) for w, a in kernel_counters()]


def _set_counts(counts) -> None:
    for (w, a), n in zip(kernel_counters(), counts):
        setattr(w, a, n)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(v, fn) for v in x)
    return fn(x) if torch.is_tensor(x) else x


_HERE = os.path.abspath(__file__)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))


def _show(f) -> str:
    return f"{os.path.basename(f.filename)}:{f.lineno} ({f.line})"


def _repo_frames(frames) -> list:
    """The frames of this repository, this module's left out."""
    return [f for f in frames if os.path.abspath(f.filename) != _HERE
            and os.path.abspath(f.filename).startswith(_ROOT)]


def _where(e: BaseException) -> str:
    """Where e was raised, this module's frames left out: the innermost
    frame, and the innermost of this repository's when it differs."""
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if os.path.abspath(f.filename) != _HERE]
    if not frames:
        return "?"
    ours = _repo_frames(frames)
    if not ours or ours[-1] is frames[-1]:
        return _show(frames[-1])
    return f"{_show(frames[-1])}, called from {_show(ours[-1])}"


class CaughtOutOfMemory(RuntimeError):
    """A region on the card raised an out-of-memory error that a caller
    caught and went on from (the module docstring): refused, as a program
    that does not fit is refused on the TPU."""


def caught_ooms(device: torch.device) -> int:
    """The out-of-memory errors the caching allocator has raised on
    ``device`` so far (``num_ooms``); 0 on the CPU, whose allocator is not
    read. ``refuse_caught_ooms`` reads the count here and only here."""
    if device.type != "cuda":
        return 0
    return int(torch.cuda.memory_stats_as_nested_dict(device)
               .get("num_ooms", 0))


# the out-of-memory errors the observer saw inside watched regions: one
# dict each (device, bytes asked, bytes free, the op's line); the
# observer is attached once a process and records only while a region
# is watched (``_watchers`` counts them by thread)
_sites: List[Dict[str, Any]] = []
_watchers: Dict[int, int] = {}
_watch_lock = threading.Lock()
_observing: List[bool] = []


def _op_line() -> str:
    """The line of the op that asked for the memory: the innermost frame
    of this repository in the allocating thread. A backward's ops run on
    autograd's own thread, which has no such frame: then the autograd node
    that ran and the line of the watched thread that called backward."""
    ours = _repo_frames(traceback.extract_stack())
    if ours:
        return _show(ours[-1])
    node = getattr(torch._C, "_current_autograd_node", lambda: None)()
    node = type(node).__name__ if node is not None else "an autograd node"
    frames = sys._current_frames()
    callers = []
    for t in list(_watchers):
        theirs = _repo_frames(traceback.extract_stack(frames[t])) \
            if t in frames else []
        if theirs:
            callers.append(_show(theirs[-1]))
    return f"{node} in the backward of {' or '.join(callers) or '?'}"


def _observed(device: int, asked: int, limit: int, free: int) -> None:
    """The allocator's out-of-memory observer: it runs on every
    out-of-memory error raised, caught by its caller or not. It must not
    raise (the allocator would raise it from the op)."""
    if not _watchers:
        return
    try:
        where = _op_line()
    except Exception as e:          # noqa: BLE001 - the op's line is a label
        where = f"? ({type(e).__name__}: {e})"
    _sites.append({"device": device, "asked": asked, "free": free,
                   "where": where})


def _observe() -> None:
    """Attach the observer, once a process (it cannot be detached)."""
    with _watch_lock:
        if not _observing:
            torch._C._cuda_attach_out_of_memory_observer(_observed)
            _observing.append(True)


def _gb(n: Optional[int]) -> str:
    return "?" if n is None else f"{n / 1e9:.2f} GB"


def _refusal(name: str, device: torch.device, what: str, caught: int,
            sites: List[Dict[str, Any]],
            record: Optional[Dict[str, Optional[int]]]) -> str:
    """The message of a ``CaughtOutOfMemory``: its first line names the
    program, the region and the op; then each error's bytes, the
    allocator record and what to do."""
    lines = sorted({s["where"] for s in sites}) or ["(the observer saw none)"]
    out = [f"[{name}] refused: {caught} out-of-memory error"
           f"{'s' if caught > 1 else ''} caught in {what} on {device}, at "
           f"{'; '.join(lines)}"]
    out += [f"  {s['where']}: asked {_gb(s['asked'])} with {_gb(s['free'])} "
            f"free on the card" for s in sites]
    if device.type == "cuda":
        rec = dict(record or {})
        rec.setdefault("reserved_now", torch.cuda.memory_reserved(device))
        rec.setdefault("peak_reserved",
                       torch.cuda.max_memory_reserved(device))
        out.append("  allocator: " + ", ".join(
            f"{k} {_gb(v)}" for k, v in rec.items() if k != "num_ooms"))
    out.append(
        "  cuDNN (or another caller) caught the error and went on with "
        "another algorithm, which rounds differently: this run's arithmetic "
        "would depend on the memory free. Free memory on the card (other "
        "processes on it, tensors this process holds, "
        "torch.cuda.empty_cache()) or lower the batch, and run again.")
    return "\n".join(out)


@contextlib.contextmanager
def refuse_caught_ooms(name: str, device: torch.device, what: str,
                       record: Optional[Dict[str, Optional[int]]] = None):
    """Raise ``CaughtOutOfMemory`` after the region if the allocator's
    count of out-of-memory errors (``caught_ooms``) rose inside it and
    the region still returned: a caller caught the error and went on. Its
    message (``_refusal``) names the program, ``what`` the region was, the
    ops' lines with the bytes asked and free, and ``record`` (a capture's
    allocator record so far). An error that leaves the region is not
    replaced. On the CPU the count stays 0 and the region passes."""
    device = torch.device(device)
    if device.type == "cuda":
        _observe()
    me = threading.get_ident()
    with _watch_lock:
        _watchers[me] = _watchers.get(me, 0) + 1
        start = len(_sites)
    before = caught_ooms(device)
    try:
        yield
        caught = caught_ooms(device) - before
    finally:
        with _watch_lock:
            sites = _sites[start:]
            _watchers[me] -= 1
            if not _watchers[me]:
                del _watchers[me]
            if not _watchers:
                _sites.clear()
    if caught > 0:
        index = device.index if device.index is not None else (
            torch.cuda.current_device() if device.type == "cuda" else None)
        raise CaughtOutOfMemory(_refusal(
            name, device, what, caught,
            [s for s in sites if s["device"] == index], record))


def _allocator(device: torch.device) -> Dict[str, int]:
    """The caching allocator's bytes reserved, peak reserved and caught
    out-of-memory errors on ``device``."""
    return {"reserved": torch.cuda.memory_reserved(device),
            "peak_reserved": torch.cuda.max_memory_reserved(device),
            "num_ooms": caught_ooms(device)}


def _pool_bytes(device: torch.device, pool) -> Optional[int]:
    """The bytes of the segments of a graph's private pool (None where
    the snapshot does not name pools)."""
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return sum(s["total_size"] for s in segs if s.get("device") == index
               and tuple(s["segment_pool_id"]) == tuple(pool))


def _saved_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of a state tensor that the warm-up cannot touch: in pinned
    host memory for a card's tensor (the card's memory stays free for the
    warm-up and the capture), a clone on the CPU."""
    if not t.is_cuda:
        return t.detach().clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t.detach(), non_blocking=True)
    return host


def _release(device: torch.device,
             state: Callable[[], Sequence[torch.Tensor]]) -> None:
    """Hand the warm-up's blocks back to the card: they belong to the side
    stream, and the capture's pool cannot reuse them. The warm-up's
    gradients go too (a captured closure sets its own)."""
    for t in state():
        if t.grad is not None:
            t.grad = None
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()


def capture_line(name: str, stand_in: bool, n: int, batch: Optional[int],
                 segments: int, seconds: float,
                 mem: Dict[str, Optional[int]],
                 convs: Tuple[int, int] = (0, 0),
                 adam: Tuple[int, int] = (0, 0),
                 feat: Tuple[int, int] = (0, 0)) -> str:
    """The line a capture prints: ``[name] graphed (CUDA graph, capture n:
    batch B, k segments, s s, nhwc a/c, adam a/c, feat a/c, num_ooms m,
    peak reserved g GB)``, ``nhwc a/c`` where the capture ran c convs, a
    of them on NHWC operands (``models/layers.conv_counts``), ``adam a/c``
    where its updates offered c optimizer parameter tensors, a of them
    updated by the one-pass kernel (``state.adam_counts``), ``feat a/c``
    where it ran c renderer calls under the feature flags, a of them
    encoding a real frame through E (``models/renderer.feat_counts``); a
    stand-in's has no allocator record."""
    kind = "stand-in" if stand_in else "CUDA graph"
    head = f"batch {batch}, " if batch is not None else ""
    layout = f", nhwc {convs[0]}/{convs[1]}" if convs[1] else ""
    layout += f", adam {adam[0]}/{adam[1]}" if adam[1] else ""
    layout += f", feat {feat[0]}/{feat[1]}" if feat[1] else ""
    alloc = ""
    if "num_ooms" in mem:
        alloc = (f", num_ooms {mem['num_ooms']}, peak reserved "
                 f"{mem['peak_reserved'] / 1e9:.2f} GB")
    return (f"[{name}] graphed ({kind}, capture {n}: {head}{segments} "
            f"segment{'s' if segments > 1 else ''}, {seconds:.2f} s{layout}"
            f"{alloc})")


class _CudaCapture:
    """One capture on the card: graphs split at the host points, all in
    one private memory pool, replayed in the order captured."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.host_ops: List[Callable[[], None]] = []
        self.open: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None

    def _begin(self) -> None:
        self.open = torch.cuda.CUDAGraph()
        # thread_local: a loader thread may use the card meanwhile
        self.open.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")

    def _end(self) -> None:
        g, self.open = self.open, None
        g.capture_end()
        self.graphs.append(g)

    def split(self, fn: Callable[[], None]) -> None:
        self._end()
        fn()
        self.host_ops.append(fn)
        self._begin()

    def run(self, closure: Callable[[], Any], stream) -> None:
        with torch.cuda.stream(stream), capturing(self):
            self._begin()
            try:
                self.outputs = closure()
                self._end()
            except BaseException:
                if self.open is not None:
                    try:
                        self.open.capture_end()
                    except RuntimeError:
                        pass             # the capture was invalidated
                    self.open = None
                raise

    def discard(self) -> None:
        """Drop the graphs and outputs: the pool's blocks go back to the
        allocator's cache."""
        self.graphs, self.outputs = [], None

    def replay(self) -> None:
        for i, g in enumerate(self.graphs):
            g.replay()
            if i < len(self.host_ops):
                self.host_ops[i]()

    @property
    def segments(self) -> int:
        return len(self.graphs)


class StandIn:
    """A capture that records nothing (the CPU tests' stand-in for a CUDA
    graph): the capture runs the closure and counts its host points, a
    replay runs it again and copies its outputs into the captured ones,
    with the wrappers' counts put back as a graph's replay leaves them."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host_ops: List[Callable[[], None]] = []
        self.closure: Optional[Callable[[], Any]] = None
        self.outputs = None

    def split(self, fn: Callable[[], None]) -> None:
        fn()
        self.host_ops.append(fn)

    def run(self, closure: Callable[[], Any], stream) -> None:
        with capturing(self):
            self.outputs = closure()
        self.closure = closure

    def discard(self) -> None:
        self.closure, self.outputs = None, None

    def replay(self) -> None:
        counts = _counts()
        fresh = self.closure()
        _set_counts(counts)
        flat_new, flat_old = [], []
        _tree(fresh, flat_new.append)
        _tree(self.outputs, flat_old.append)
        with torch.no_grad():
            for old, new in zip(flat_old, flat_new):
                old.copy_(new)

    @property
    def segments(self) -> int:
        return len(self.host_ops) + 1


class _Entry:
    """A signature's capture: its static inputs, its outputs, the launches
    one replay makes, and what it must keep alive."""

    def __init__(self, capture, inputs, outputs, launches, keep):
        self.capture = capture
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.keep = keep


class Program:
    """Captures of one closure by signature (the module docstring).

    program(key, inputs, make_closure, state=()) -> outputs (clones):
    ``inputs`` maps names to tensors (host or device); ``key`` is the rest
    of the signature, anything that changes what the closure launches
    (the inputs' names, shapes and dtypes are added to it);
    ``make_closure(static)`` returns the closure of that signature over
    the static input buffers; ``state()`` lists the tensors the closure
    updates in place (saved across the warm-up; a tensor that appears
    during the warm-up, such as an optimizer's lazily made moment, is
    zeroed after it). ``keep`` objects are held as long as the capture
    (what the graphs address: assets, the train state).

    ``name`` labels the line each capture prints on stderr: ``[name]
    graphed (CUDA graph, capture n: ...)``, with the capture's caught
    out-of-memory errors and the peak reserved. ``warmup_launches`` maps
    each counter (``wrapper`` or ``wrapper.attribute``) to the launches
    the warm-up calls made on the card, which the counters leave out.

    ``name`` also prefixes the program's spans (``utils/spans.py``): a
    call is ``name.copy_in`` (the inputs into the static buffers),
    ``name.replay`` (the graph chain's launch) and ``name.clone_out``; a
    capture is ``name.capture``, whose seconds ``capture_s`` keeps.
    ``convs`` keeps, for each capture, the conv calls it recorded that
    found their input and weight NHWC, and all its conv calls
    (``models/layers.conv_counts``; the capture line prints them);
    ``adam`` the optimizer parameter tensors its updates offered and those
    the one-pass kernel updated (``state.adam_counts``); ``feat`` the
    renderer calls under the feature flags and those that encoded a real
    frame through E and pooled it (``models/renderer.feat_counts``). With
    ``marks`` set (the stage-2 step's program), the device marks
    ``name.replay.begin`` and ``name.replay.end`` lie on the card's
    stream before the replay and after its last graph; a stand-in records
    none."""

    def __init__(self, name: str, device: torch.device,
                 stand_in: bool = False):
        self.name = name
        self.device = torch.device(device)
        if self.device.type != "cuda" and not stand_in:
            raise ValueError(f"{name}: a captured program needs a CUDA "
                             f"device, got {self.device}")
        self.stand_in = stand_in
        self.entries: Dict[Hashable, _Entry] = {}
        self.captures = 0
        self.marks = False
        self.capture_s: List[float] = []
        self.convs: List[Tuple[int, int]] = []
        self.adam: List[Tuple[int, int]] = []
        self.feat: List[Tuple[int, int]] = []
        self.warmup_launches: Dict[str, int] = {}
        # each capture's allocator record (the module docstring); empty
        # dicts for a stand-in
        self.memory: List[Dict[str, Optional[int]]] = []

    @property
    def route(self) -> str:
        """The route a caller prints: ``graphed (CUDA graph, n capture[s])``
        (``stand-in`` for a stand-in)."""
        kind = "stand-in" if self.stand_in else "CUDA graph"
        n = self.captures
        return f"graphed ({kind}, {n} capture{'s' if n > 1 else ''})"

    @property
    def num_ooms(self) -> int:
        """Out-of-memory errors caught across every stored capture's
        warm-up and capture: 0, since a capture that caught one is
        refused (``refuse_caught_ooms``)."""
        return sum(m.get("num_ooms", 0) for m in self.memory)

    def clear(self) -> None:
        """Drop every capture (their pools go with them)."""
        self.entries.clear()

    def __call__(self, key: Hashable, inputs: Dict[str, torch.Tensor],
                 make_closure: Callable[[Dict[str, torch.Tensor]],
                                        Callable[[], Any]],
                 state: Callable[[], Sequence[torch.Tensor]] = tuple,
                 keep: Sequence[Any] = ()) -> Any:
        sig = (key, tuple((k, tuple(v.shape), v.dtype)
                          for k, v in sorted(inputs.items())))
        entry = self.entries.get(sig)
        if entry is None:
            entry = self._capture(sig, inputs, make_closure, state, keep)
            self.entries[sig] = entry
        name, marks = self.name, self.marks and not self.stand_in
        with span(name + ".copy_in"):
            for k, v in inputs.items():
                entry.inputs[k].copy_(v, non_blocking=True)
        with span(name + ".replay"):
            if marks:
                device_mark(name + ".replay.begin", self.device)
            entry.capture.replay()
            if marks:
                device_mark(name + ".replay.end", self.device)
            for (w, a), n in entry.launches:
                setattr(w, a, getattr(w, a) + n)
        with span(name + ".clone_out"):
            return _tree(entry.outputs, torch.clone)

    def _capture(self, sig, inputs, make_closure, state, keep) -> _Entry:
        with span(self.name + ".capture", capture=self.captures + 1) as sp:
            cuda = not self.stand_in
            mem: Dict[str, Optional[int]] = {}

            def note(at: str) -> None:
                if cuda:
                    mem[f"reserved_{at}"] = \
                        _allocator(self.device)["reserved"]

            start = _allocator(self.device) if cuda else None
            note("start")
            static = {k: torch.empty(v.shape, dtype=v.dtype,
                                     device=self.device)
                      for k, v in inputs.items()}
            for k, v in inputs.items():
                static[k].copy_(v)
            closure = make_closure(static)
            counts = _counts()
            stream = torch.cuda.Stream(self.device) if cuda else None
            n = self.captures + 1
            try:
                with refuse_caught_ooms(self.name, self.device,
                                        f"the warm-up of capture {n}", mem):
                    self._warm_up(closure, state, stream,
                                  lambda: note("after_copy"))
            finally:
                for (w, a), m, c in zip(kernel_counters(), _counts(), counts):
                    if m != c:
                        name = w.__name__ + ("" if a == "launches"
                                             else "." + a[9:])
                        self.warmup_launches[name] = \
                            self.warmup_launches.get(name, 0) + m - c
                _set_counts(counts)
            note("after_warmup")
            if cuda:
                _release(self.device, state)
                note("after_release")
            cap = StandIn(self.device) if self.stand_in \
                else _CudaCapture(self.device)
            try:
                with refuse_caught_ooms(self.name, self.device,
                                        f"capture {n}", mem):
                    try:
                        engaged = _engaged()
                        if self.stand_in:  # it runs the closure: no trace
                            _preserving(state,
                                        lambda: cap.run(closure, stream))
                        else:
                            cap.run(closure, stream)
                            mem["pool_bytes"] = _pool_bytes(self.device,
                                                            cap.pool)
                        engaged = tuple(b - a for a, b in zip(
                            engaged, _engaged()))
                    except Exception as e:
                        raise RuntimeError(
                            f"[{self.name}] CUDA graph capture failed at "
                            f"{_where(e)}: {type(e).__name__}: {e}") from e
            except CaughtOutOfMemory:
                # not stored: its graphs, outputs and gradients go, and the
                # pool's blocks with them
                cap.discard()
                _set_counts(counts)
                if cuda:
                    _release(self.device, state)
                raise
            outputs = cap.outputs
            if cuda:
                torch.cuda.current_stream(self.device).wait_stream(stream)
            launches = [(c, m - k) for c, m, k in
                        zip(kernel_counters(), _counts(), counts) if m != k]
            _set_counts(counts)
        self.captures += 1
        self.capture_s.append(sp.seconds)
        convs, adam, feat = engaged[:2], engaged[2:4], engaged[4:]
        self.convs.append(convs)
        self.adam.append(adam)
        self.feat.append(feat)
        if cuda:
            end = _allocator(self.device)
            note("after_capture")
            mem.update(peak_reserved=end["peak_reserved"],
                       num_ooms=end["num_ooms"] - start["num_ooms"])
        self.memory.append(mem)
        lead = inputs.get("joints", next(iter(inputs.values()), None))
        print(capture_line(self.name, self.stand_in, self.captures,
                           None if lead is None else lead.shape[0],
                           cap.segments, self.capture_s[-1], mem, convs,
                           adam, feat),
              file=sys.stderr, flush=True)
        return _Entry(cap, static, outputs, launches, (closure, tuple(keep)))

    def _warm_up(self, closure, state, stream, copied) -> None:
        """WARMUP calls of the closure on the side stream, leaving no trace
        in the state; ``copied()`` runs once the state is saved."""
        if stream is None:
            _preserving(state, lambda: [closure() for _ in range(WARMUP)],
                        copied)
            return
        current = torch.cuda.current_stream(self.device)

        def calls():
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                for _ in range(WARMUP):
                    closure()
            current.wait_stream(stream)

        _preserving(state, calls, copied)
        stream.wait_stream(current)


def program_for(name: str, device: torch.device) -> Optional[Program]:
    """The captured program of a closure on ``device``: on the card a CUDA
    graph's, on the CPU none (the eager closure runs)."""
    return Program(name, device) if device.type == "cuda" else None


class Dispatch:
    """One closure's route (the module docstring): ``program`` is
    ``program_for(name, device)``, None where the closure runs eagerly.

    dispatch(eager, keep, key, inputs, make_closure, state=tuple,
    eagerly=False) -> outputs: ``eager()`` where there is no program or
    the caller asks for it (``eagerly``, a step called with ``mark``;
    beside a program it runs inside ``refuse_caught_ooms``), else the
    program's call of signature (the ids of ``keep``, ``key``) with
    ``inputs``, ``make_closure`` and ``state`` as ``Program`` takes them.
    ``keep`` lists the objects the graphs address: when their ids change,
    every capture goes. Each route is printed once, ``[name] eager
    (cpu)``, ``[name] eager (per-phase marks)`` or ``[name]`` and the
    program's ``route``; ``route`` keeps the first printed."""

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.device = torch.device(device)
        self.program = program_for(name, self.device)
        self.route = ""
        self._told: set = set()
        self._held: Optional[tuple] = None

    def __call__(self, eager: Callable[[], Any], keep: Sequence[Any],
                 key: Hashable, inputs: Dict[str, torch.Tensor],
                 make_closure: Callable[[Dict[str, torch.Tensor]],
                                        Callable[[], Any]],
                 state: Callable[[], Sequence[torch.Tensor]] = tuple,
                 eagerly: bool = False) -> Any:
        program = self.program
        if program is None:
            self._tell("eager", f"eager ({self.device.type})")
            return eager()
        if eagerly:
            self._tell("eager", "eager (per-phase marks)")
            with refuse_caught_ooms(self.name, self.device, "an eager call"):
                return eager()
        ids = tuple(id(x) for x in keep)
        if self._held != ids:
            program.clear()
            self._held = ids
        out = program((ids, key), inputs, make_closure, state, keep)
        self._tell("graphed", program.route)
        return out

    def _tell(self, kind: str, how: str) -> None:
        if kind not in self._told:
            self._told.add(kind)
            self.route = self.route or how
            print(f"[{self.name}] {how}", file=sys.stderr, flush=True)


def _preserving(state: Callable[[], Sequence[torch.Tensor]],
                fn: Callable[[], Any],
                copied: Callable[[], None] = lambda: None) -> None:
    """Run fn with the state's tensors as they were before it, after it: a
    tensor that appears during fn (an optimizer's lazily made moment or
    step count, zero when made) is zeroed. The saved copy of a card's
    tensor waits in pinned host memory (``_saved_copy``); ``copied()``
    runs between the copy and fn."""
    before = list(state())
    saved = [_saved_copy(t) for t in before]
    copied()
    fn()
    with torch.no_grad():
        known = {id(t) for t in before}
        for t, s in zip(before, saved):
            t.copy_(s, non_blocking=True)
        for t in state():
            if id(t) not in known:
                t.zero_()
    if any(t.is_cuda for t in before):
        # the host copies are read by the copies back: done before they go
        torch.cuda.synchronize()
