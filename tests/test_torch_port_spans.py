"""PyTorch port, the span recorder (``utils/spans.py``) and its spans in the
captured programs, the server and the training loop, on the CPU:
  * off by default: a span returns its seconds, records nothing and
    enters no ``record_function``; a device mark does nothing;
  * under a CPU ``torch.profiler`` session the main thread's spans are
    annotations of the same name, ``chrome_events`` lays them on the
    profiler's clock, and a span on a worker thread is kept in memory
    with its thread id; ``recording()`` records every thread's spans;
  * device marks pair into intervals (planted events);
  * a stand-in ``Program`` call records ``copy_in``, ``replay`` and
    ``clone_out`` under its name, and ``capture_s`` is its capture span's
    seconds;
  * two concurrent ``serve._Model.render`` calls: the second waits for
    the device while the first holds it, each request's spans share its
    id across the client and the device thread, ``timing`` holds the
    forward and transfer spans' seconds;
  * requests queued while the device is held share replays: in arrival
    order up to the first that does not fit, ``serve.device``'s ``rid``
    the tuple of their ids, each with its own frames (bit-equal to its
    joints rendered alone, with the marks a wrapper of ``_call`` put on
    the replay's array), a failed replay raised in each; a request to an
    idle model replayed at once, alone; 24 concurrent clients;
  * the loop's ``loop.next_batch`` span, and ``ProfileWindow`` writing
    other threads' spans into its trace, the loader's ``data.batch`` among
    them;
  * the benchmark's readers of the recorder, on planted records: the
    replay, the gap between replays, the step's three phases between its
    replay's marks, the lock wait and the batch fill;
    ``serve.batch_fill`` counts the slots of the replays it sees.
The device marks of a graph replay are read on the card by the benchmark
(``perfbench``'s ``replay_ms.train`` and ``replay_gap_ms.train``).
"""

import itertools
import json
import statistics
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neural_human_video_rendering_tpu_torch import export_serving as es
from neural_human_video_rendering_tpu_torch import serve as srv
from neural_human_video_rendering_tpu_torch.config import TestOptions
from neural_human_video_rendering_tpu_torch.data import dataset as tds
from neural_human_video_rendering_tpu_torch.train import graphs, loop
from neural_human_video_rendering_tpu_torch.utils import spans
from perfbench.harness import bench as hb
from test_torch_port_graph_pretrain import SERVE_TINY
from test_torch_port_graph_step import stand_in  # noqa: F401 (fixture)


@pytest.fixture(autouse=True)
def _empty_recorder():
    spans.clear()
    yield
    spans.clear()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _on_worker(name, **attrs) -> int:
    """A span on a pool's worker thread; that thread's native id."""
    def work():
        with spans.span(name, **attrs):
            pass
        return threading.get_native_id()

    with ThreadPoolExecutor(1) as ex:
        return ex.submit(work).result(timeout=30)


def _no_record_function(monkeypatch):
    made = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: made.append(name))
    return made


def test_off_by_default_times_and_records_nothing(monkeypatch):
    made = _no_record_function(monkeypatch)
    assert not spans.tracing()
    with spans.span("a", rid=1) as s:
        time.sleep(0.002)
    assert s.seconds >= 0.002
    spans.device_mark("a.begin")
    assert spans.records() == [] and list(spans._marks) == [] and made == []
    assert spans.device_intervals("a.begin", "a.end") == []


def test_recording_keeps_every_thread_and_the_parents(monkeypatch):
    made = _no_record_function(monkeypatch)
    with spans.recording():
        with spans.recording():          # nests
            pass
        assert spans.tracing()
        with spans.span("outer", rid=7) as outer:
            with spans.span("inner"):
                pass
        tid = _on_worker("w")
    assert not spans.tracing()
    with spans.span("after"):
        pass
    inner, out, w = spans.records()
    assert [r.name for r in (inner, out, w)] == ["inner", "outer", "w"]
    assert out.parent is None and inner.parent == out.id == outer.id
    assert out.attrs == {"rid": 7} and out.start_ns <= inner.start_ns
    assert inner.end_ns <= out.end_ns and out.seconds == outer.seconds
    assert inner.tid == out.tid == threading.get_native_id()
    assert w.tid == tid != out.tid and w.parent is None
    assert made == []      # no profiler runs: no annotation
    assert spans.records("outer") == [out]


def test_many_threads_lose_no_record():
    """16 threads, each 500 nested pairs, with a short switch interval:
    every record kept, every id unique, each inner span's parent the
    outer span of its own thread."""
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(500):
                with spans.span("outer", k=k, i=i):
                    with spans.span("inner", k=k, i=i):
                        pass

        with spans.recording():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(before)
    recs = spans.records()
    assert len(recs) == 16 * 500 * 2
    assert len({r.id for r in recs}) == len(recs)
    outer = {r.id: r for r in recs if r.name == "outer"}
    for r in recs:
        if r.name == "inner":
            o = outer[r.parent]
            assert o.attrs == r.attrs and o.tid == r.tid


def test_the_buffer_keeps_the_newest():
    with spans.recording():
        for i in range(spans.CAP + 3):
            with spans.span("s", i=i):
                pass
    recs = spans.records()
    assert len(recs) == spans.CAP
    assert recs[0].attrs["i"] == 3 and recs[-1].attrs["i"] == spans.CAP + 2


def test_profiler_session_annotates_and_chrome_events_align(tmp_path):
    def worker():
        with spans.span("client", rid=3):
            time.sleep(0.001)
        return threading.get_native_id()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.tracing()
        for i in range(-2, 5):       # two first annotations, not compared
            with spans.span("main.x", i=i):
                time.sleep(0.002)
        with ThreadPoolExecutor(1) as ex:
            tid = ex.submit(worker).result()
    assert not spans.tracing()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    theirs = sorted((e for e in trace["traceEvents"]
                     if e.get("name") == "main.x"), key=lambda e: e["ts"])
    assert len(theirs) == 7
    assert {e["cat"] for e in theirs} == {"user_annotation"}
    ours = spans.chrome_events(int(trace["baseTimeNanoseconds"]),
                               spans.records("main.x"))
    assert [e["args"]["i"] for e in ours] == list(range(-2, 5))
    # on one clock: each within a millisecond, the median within 100 us (a
    # preemption between the two clock reads moves one span, not all)
    for key in ("ts", "dur"):
        diffs = [abs(o[key] - t[key]) for t, o in zip(theirs[2:], ours[2:])]
        assert max(diffs) < 1000 and statistics.median(diffs) < 100, diffs
    assert {(o["ph"], o["tid"]) for o in ours} == {
        ("X", threading.get_native_id())}
    client, = spans.records("client")
    assert client.tid == tid != threading.get_native_id()
    assert client.attrs == {"rid": 3} and client.seconds >= 0.001


class _Event:
    """A planted device event at ``t`` ms."""

    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def _plant(marks):
    for name, t in marks:
        spans._marks.append((name, _Event(t)))


def test_device_intervals_pair_each_mark_with_the_next():
    _plant([("r.end", 0.0), ("r.begin", 1.0), ("r.end", 11.0),
            ("r.begin", 14.0), ("r.end", 24.5), ("r.begin", 30.0)])
    assert spans.device_intervals("r.begin", "r.end") == [10.0, 10.5]
    assert spans.device_intervals("r.end", "r.begin") == [1.0, 3.0, 5.5]
    assert spans.device_intervals("r.begin", "nothing") == []


def test_stand_in_program_call_spans(monkeypatch, capsys):
    made = _no_record_function(monkeypatch)
    prog = graphs.Program("prog", torch.device("cpu"), stand_in=True)
    prog.marks = True                  # a stand-in records none all the same
    x = torch.arange(4.0)

    def call(v):
        return prog("k", {"x": v}, lambda st: lambda: {"y": st["x"] * 2})

    with spans.recording():
        assert torch.equal(call(x)["y"], x * 2)
        assert torch.equal(call(x + 1)["y"], (x + 1) * 2)
    names = [r.name for r in spans.records()]
    assert names[0] == "prog.capture"
    assert names[1:] == ["prog.copy_in", "prog.replay", "prog.clone_out"] * 2
    cap, = spans.records("prog.capture")
    assert prog.capture_s == [cap.seconds] and cap.attrs == {"capture": 1}
    assert prog.captures == 1
    assert list(spans._marks) == [] and made == []   # a stand-in: no marks
    # off: the same seconds, nothing recorded
    spans.clear()
    prog.clear()
    call(x)
    assert len(prog.capture_s) == 2 and prog.capture_s[1] > 0
    assert spans.records() == [] and prog.captures == 2
    assert "[prog] graphed (stand-in, capture 2" in capsys.readouterr().err


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny exported program at batch 4 and its joints."""
    root = tmp_path_factory.mktemp("serve_spans")
    opt = TestOptions().parse(SERVE_TINY + ["--checkpoints_dir", str(root)],
                              save=False)
    path = str(root / "m.pt2")
    es.save_artifact(opt, 4, path)
    ds = tds.SyntheticDataset(opt, length=4)
    joints = np.stack([ds[i]["joints"] for i in range(4)]).astype(np.float32)
    return path, joints


def test_serve_spans_and_the_lock_wait(stand_in, served):
    path, joints = served
    model = srv._Model(path, torch.device("cpu"))
    call = model._call
    holding, go = threading.Event(), threading.Event()

    def gated(padded, n):          # the first request holds the device
        if not go.is_set():
            holding.set()
            assert go.wait(30)
        return call(padded, n)

    model._call = gated
    out = [None, None]

    def request(i, n):
        out[i] = model.render(joints[:n])

    with spans.recording():
        first = threading.Thread(target=request, args=(0, 1))
        first.start()
        assert holding.wait(30)
        second = threading.Thread(target=request, args=(1, 3))
        second.start()
        time.sleep(0.2)           # the second asks for the lock meanwhile
        go.set()
        for t in (first, second):
            t.join(60)
            assert not t.is_alive()
    assert out[0].shape[0] == 1 and out[1].shape[0] == 3
    reqs = spans.records("serve.request")
    waits = {r.attrs["rid"]: r for r in spans.records("serve.lock_wait")}
    devs = {r.attrs["rid"]: r for r in spans.records("serve.device")}
    assert [(r.attrs["n"], r.attrs["batch"]) for r in
            sorted(reqs, key=lambda r: r.attrs["rid"])] == [(1, 4), (3, 4)]
    a, b = sorted(r.attrs["rid"] for r in reqs)
    # the second waited for the lock while the first held the device
    assert waits[b].start_ns < devs[a].end_ns <= waits[b].end_ns
    assert waits[b].seconds >= 0.2 > waits[a].seconds
    assert devs[b].start_ns >= waits[b].end_ns
    for r in reqs:    # one id across the client and the device thread
        rid = r.attrs["rid"]
        assert waits[rid].tid == r.tid != devs[rid].tid
        assert waits[rid].parent == r.id
        assert r.start_ns <= devs[rid].start_ns <= devs[rid].end_ns \
            <= r.end_ns
    # inside the device span: the forward (the program's spans in it) and
    # the transfer; timing holds the last request's two spans
    by_id = {r.id: r for r in spans.records()}
    fwd = [r for r in spans.records("serve.forward")
           if by_id[r.parent].attrs["rid"] == b]
    tr = [r for r in spans.records("serve.transfer")
          if by_id[r.parent].attrs["rid"] == b]
    assert len(fwd) == len(tr) == 1
    assert model.timing == {"forward_s": fwd[0].seconds,
                            "transfer_s": tr[0].seconds}
    inside = [r.name for r in spans.records() if r.parent == fwd[0].id]
    assert inside == ["serve.copy_in", "serve.replay", "serve.clone_out"]
    fill = hb.reader("serve.batch_fill")({"kind": "serve"})
    assert fill == pytest.approx(100.0 * 4 / 8)


def _wait_for(cond, what):
    deadline = time.monotonic() + 30
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.001)


def _queued_behind_a_held_device(model, holder, parts, after=None):
    """Holds the device with a request of ``holder``'s joints, queues a
    request of each joints in ``parts`` behind it in that order, then frees
    the device; the replays after the holder's call ``after`` (default: the
    model's ``_call``). Recording starts once the holder holds the device.
    Returns each queued request's frames or exception, and the replays
    recorded, each as the indices into ``parts`` of the requests it
    served."""
    call = model._call
    after = after or call
    holding, go = threading.Event(), threading.Event()

    def gated(padded, n):
        if not go.is_set():
            holding.set()
            assert go.wait(30)
            return call(padded, n)
        return after(padded, n)

    model._call = gated
    out = [None] * (len(parts) + 1)      # the holder's last

    def request(i, joints):
        try:
            out[i] = model.render(joints)
        except Exception as e:      # a failed replay's
            out[i] = e

    first = threading.Thread(target=request, args=(len(parts), holder))
    first.start()
    assert holding.wait(30)
    threads = [first]
    with spans.recording():
        for i, joints in enumerate(parts):
            threads.append(threading.Thread(target=request, args=(i, joints)))
            threads[-1].start()
            _wait_for(lambda: len(model.pending) == i + 1, "not queued")
        go.set()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    assert out[-1].shape[0] == len(holder)
    rids = sorted(r.attrs["rid"] for r in spans.records("serve.request"))
    index = {rid: i for i, rid in enumerate(rids)}
    replays = []
    for dev in spans.records("serve.device"):
        rid = dev.attrs["rid"]
        replays.append([index[r] for r in
                        (rid if isinstance(rid, tuple) else (rid,))])
    return out[:-1], replays


def test_queued_requests_share_one_replay(stand_in, served):
    """Three one-frame requests queued while the device is held ride in one
    replay: its serve.device span carries their ids as a tuple,
    serve.batch_fill reads their 3 frames over one batch of 4, each
    request's lock wait ends when the replay takes it up (before its frames
    come back), and each request's frames are bit-equal to its joints
    rendered alone."""
    path, joints = served
    model = srv._Model(path, torch.device("cpu"))
    call = model._call
    seen = []

    def riders_taken(padded, n):   # the three waits closed before the replay
        _wait_for(lambda: len(spans.records("serve.lock_wait")) == 3,
                  "a rider's lock wait outlasted its take-up")
        seen.append(n)
        return call(padded, n)

    parts = [joints[i:i + 1] for i in range(3)]
    out, replays = _queued_behind_a_held_device(model, joints[3:], parts,
                                                riders_taken)
    assert replays == [[0, 1, 2]] and seen == [3]
    dev, = spans.records("serve.device")
    reqs = sorted(spans.records("serve.request"), key=lambda r: r.attrs["rid"])
    assert dev.attrs["rid"] == tuple(r.attrs["rid"] for r in reqs)
    assert hb.reader("serve.batch_fill")({"kind": "serve"}) == \
        pytest.approx(100.0 * 3 / 4)
    for wait in spans.records("serve.lock_wait"):
        assert wait.end_ns <= dev.end_ns
    for i, p in enumerate(parts):
        assert out[i].dtype == np.uint8 and out[i].shape[0] == 1
        np.testing.assert_array_equal(out[i], model.render(p))
    assert not model.busy and not model.pending


@pytest.mark.parametrize("sizes,replays", [
    ((1, 3, 1), [[0, 1], [2]]),
    ((2, 3, 1), [[0], [1, 2]]),        # the 1 does not overtake the 3
    ((1, 4, 1), [[0], [1], [2]]),      # a request of the batch rides alone
], ids=["1-3-1", "2-3-1", "1-4-1"])
def test_queued_requests_replay_in_arrival_order(stand_in, served, sizes,
                                                 replays):
    """Batch 4: each replay takes the queued requests in arrival order and
    stops at the first that does not fit; each request's frames are its
    own joints rendered alone."""
    path, joints = served
    model = srv._Model(path, torch.device("cpu"))
    parts = [joints[4 - k:] for k in sizes]
    out, got = _queued_behind_a_held_device(model, joints[:1], parts)
    assert got == replays
    for frames, p in zip(out, parts):
        assert frames.shape[0] == len(p)
        np.testing.assert_array_equal(frames, model.render(p))


def test_a_request_to_an_idle_model_is_replayed_at_once_alone(stand_in,
                                                              served):
    path, joints = served
    model = srv._Model(path, torch.device("cpu"))
    with spans.recording():
        got = model.render(joints[:2])
    req, = spans.records("serve.request")
    wait, = spans.records("serve.lock_wait")
    dev, = spans.records("serve.device")
    assert dev.attrs["rid"] == req.attrs["rid"]          # an int, alone
    assert wait.end_ns <= dev.start_ns and wait.seconds < 0.5
    assert len(spans.records("serve.replay")) == 1 and got.shape[0] == 2
    assert hb.reader("serve.batch_fill")({"kind": "serve"}) == \
        pytest.approx(50.0)
    assert not model.busy and not model.pending


class _Marked(np.ndarray):
    """Host frames marked by a wrapper of ``_call``."""


def test_coalesced_parts_carry_the_marks_of_the_replays_array(stand_in,
                                                              served):
    """A ``_call`` wrapper returns an ndarray subclass with instance
    attributes: every request of a shared replay gets its part with the
    same attributes (those of its replay, not the class's defaults)."""
    path, joints = served
    model = srv._Model(path, torch.device("cpu"))
    call, calls = model._call, itertools.count()

    def marking(padded, n):
        out = call(padded, n).view(_Marked)
        out.call = next(calls)
        out.forward_s = model.timing["forward_s"]
        return out

    model._call = marking
    parts = [joints[:1], joints[1:3], joints[3:]]
    out, replays = _queued_behind_a_held_device(model, joints[:1], parts)
    assert replays == [[0, 1, 2]]
    for frames, p in zip(out, parts):
        assert isinstance(frames, _Marked) and frames.shape[0] == len(p)
        assert frames.call == 1 and frames.forward_s > 0
        assert frames.forward_s == out[0].forward_s


def test_a_failed_replay_raises_in_every_request_it_carried(stand_in,
                                                            served):
    path, joints = served
    model = srv._Model(path, torch.device("cpu"))
    call = model._call

    def broken(padded, n):
        raise RuntimeError("texture_warp_topk_fwd launch failed")

    parts = [joints[i:i + 1] for i in range(3)]
    out, replays = _queued_behind_a_held_device(model, joints[3:], parts,
                                                broken)
    assert replays == [[0, 1, 2]]
    assert all(isinstance(e, RuntimeError) for e in out)
    assert out[0] is out[1] is out[2] and "launch failed" in str(out[0])
    # the device is free again: the next request is served
    assert not model.busy and not model.pending
    model._call = call
    assert model.render(joints[:1]).shape[0] == 1


def test_concurrent_requests_get_their_own_frames(stand_in, served):
    """24 client threads, 4 requests each of 1-4 frames, with a short
    switch interval: every request gets its own joints' frames, every
    request rides in exactly one replay, and no replay carries more frames
    than the batch."""
    path, joints = served
    model = srv._Model(path, torch.device("cpu"))
    single = [model.render(joints[i:i + 1]) for i in range(4)]
    rng = np.random.default_rng(5)
    plans = [[(int(a), int(rng.integers(a + 1, 5)))
              for a in rng.integers(0, 4, size=4)] for _ in range(24)]
    wrong = []

    def client(plan):
        for a, b in plan:
            got = model.render(joints[a:b])
            if not np.array_equal(got, np.concatenate(single[a:b])):
                wrong.append((a, b))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with spans.recording():
            threads = [threading.Thread(target=client, args=(p,))
                       for p in plans]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert wrong == []
    n = {r.attrs["rid"]: r.attrs["n"] for r in spans.records("serve.request")}
    served_rids = []
    for dev in spans.records("serve.device"):
        rid = dev.attrs["rid"]
        rids = rid if isinstance(rid, tuple) else (rid,)
        assert sum(n[r] for r in rids) <= 4
        served_rids += rids
    assert sorted(served_rids) == sorted(n) and len(n) == 24 * 4
    assert not model.busy and not model.pending


def test_loop_next_batch_spans(monkeypatch):
    class Opt:
        profile_dir = ""
        profile_start = 0
        profile_steps = 1
        debug_nans = False
        print_freq = 100
        display_freq = 100
        save_latest_freq = 0
        save_epoch_freq = 100

    class State:
        device = torch.device("cpu")
        metrics = None
        step = 0

        def __init__(self):
            self.step_seconds = []

    monkeypatch.setattr(loop, "Visualizer", lambda opt: _Quiet())
    state = State()
    with spans.recording():
        loop.run_training(Opt(), [1, 2, 3], lambda st, b: {}, state, 2)
    nexts = spans.records("loop.next_batch")
    assert len(nexts) == 2 * 4       # 3 batches and the end, per epoch
    assert len(state.step_seconds) == 6


class _Quiet:
    def log_losses(self, *a):
        pass

    def close(self):
        pass


def test_profile_window_adds_other_threads_spans(tmp_path):
    class Opt:
        profile_dir = str(tmp_path)
        profile_start = 0
        profile_steps = 1

    window = loop.ProfileWindow(Opt(), cuda=False)
    window.before_step(0)
    with spans.span("main.step"):
        tid = _on_worker("other", rid=5)
    window.after_step(1)
    path, = tmp_path.glob("steps_0-0.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    other = [e for e in events if e.get("name") == "other"]
    assert len(other) == 1
    assert other[0]["tid"] == tid and other[0]["cat"] == "span"
    assert other[0]["args"]["rid"] == 5
    main = [e for e in events if e.get("name") == "main.step"]
    # this thread's span is the profiler's own annotation, not added again
    assert [e["cat"] for e in main] == ["user_annotation"]


_planted_ids = itertools.count(1)


def _rec(name, ms, parent=None, **attrs) -> int:
    """A planted record of ``ms`` milliseconds; its id."""
    i = next(_planted_ids)
    spans._records.append(spans.Record(name, 0, int(ms * 1e6), 1, i, parent,
                                       attrs))
    return i


def _device_call(rid, replays=1):
    """The device thread's spans of a served call: serve.device (``rid``)
    holding serve.forward, which holds the program's replays."""
    dev = _rec("serve.device", 35.0, rid=rid)
    fwd = _rec("serve.forward", 34.0, parent=dev)
    for _ in range(replays):
        _rec("serve.replay", 1.0, parent=fwd)


@pytest.mark.parametrize("metric,kind", [
    ("replay_gap_ms.train", "train"), ("replay_ms.train", "train"),
    ("serve.lock_wait_ms_p95", "serve"), ("serve.batch_fill", "serve")])
def test_readers_none_outside_their_kind_or_without_records(metric, kind):
    read = hb.reader(metric)
    assert read({"kind": kind}) is None          # nothing recorded
    _plant([("step.replay.begin", 0.0), ("step.replay.end", 60.0),
            ("step.replay.begin", 66.0)])
    _rec("serve.lock_wait", 5.0)
    _rec("serve.request", 40.0, rid=0, n=1, batch=8)
    _device_call(0)
    other = "render"
    assert read({"kind": other}) is None
    assert read({"kind": kind}) is not None


def test_readers_on_planted_records():
    marks, t = [], 0.0
    for replay, gap in [(64.0, 5.0), (65.0, 7.0), (63.0, 4.0), (66.0, 6.0),
                        (64.5, 0.0)]:
        marks += [("step.replay.begin", t), ("step.replay.end", t + replay)]
        t += replay + gap
    _plant([("forward.replay.begin", -9.0)] + marks)
    assert hb.reader("replay_ms.train")({"kind": "train"}) == 64.5
    assert hb.reader("replay_gap_ms.train")({"kind": "train"}) == 5.5
    for i, ms in enumerate([float(v) for v in range(1, 21)]):
        _rec("serve.lock_wait", ms, rid=i)
        _rec("serve.request", ms + 40.0, rid=i, n=1 if i < 16 else 8,
             batch=8)
        _device_call(i)
    # 95th percentile of 1..20 ms by linear interpolation: 19.05
    got = hb.reader("serve.lock_wait_ms_p95")({"kind": "serve"})
    assert got == pytest.approx(19.05)
    fill = hb.reader("serve.batch_fill")({"kind": "serve"})
    assert fill == pytest.approx(100.0 * (16 + 4 * 8) / (20 * 8))


PHASES = {"g_forward_ms.train": ("step.replay.begin", "step.g_forward.end"),
          "g_backward_ms.train": ("step.g_forward.end",
                                  "step.g_backward.end"),
          "d_update_ms.train": ("step.g_backward.end", "step.replay.end")}


@pytest.mark.parametrize("metric", sorted(PHASES))
def test_phase_readers_on_planted_marks(metric):
    """The step's three phases between its replay's marks: each reader
    takes the median of its own interval, the three add up to the replay,
    and a program without the phase marks (the replay's alone) reads
    None."""
    read = hb.reader(metric)
    _plant([("step.replay.begin", 0.0), ("step.replay.end", 60.0)])
    assert read({"kind": "train"}) is None
    spans.clear()
    marks, t, want = [], 0.0, {m: [] for m in PHASES}
    for fwd, bwd, upd, gap in [(20.0, 35.0, 9.0, 3.0), (21.0, 36.5, 8.0, 2.0),
                               (19.5, 34.0, 10.0, 4.0)]:
        marks += [("step.replay.begin", t), ("step.g_forward.end", t + fwd),
                  ("step.g_backward.end", t + fwd + bwd),
                  ("step.replay.end", t + fwd + bwd + upd)]
        for m, v in (("g_forward_ms.train", fwd),
                     ("g_backward_ms.train", bwd),
                     ("d_update_ms.train", upd)):
            want[m].append(v)
        t += fwd + bwd + upd + gap
    _plant(marks)
    assert read({"kind": "render"}) is None
    assert read({"kind": "train"}) == statistics.median(want[metric])
    replays = spans.device_intervals("step.replay.begin", "step.replay.end")
    for i, total in enumerate(replays):
        assert sum(want[m][i] for m in PHASES) == total


def test_batch_fill_counts_the_slots_replayed():
    """Two requests that share one replay fill twice the slots of one
    request a replay; a replay of a request recorded before the window
    (no serve.request span) and a request not yet replayed are left out."""
    def fill():
        return hb.reader("serve.batch_fill")({"kind": "serve"})

    for rid in (0, 1):
        _rec("serve.request", 40.0, rid=rid, n=1, batch=8)
        _device_call(rid)
    assert fill() == pytest.approx(12.5)
    spans.clear()
    for rid in (0, 1):
        _rec("serve.request", 40.0, rid=rid, n=1, batch=8)
    _device_call((0, 1))
    assert fill() == pytest.approx(25.0)
    _device_call(99)                   # its request before the window
    _rec("serve.request", 40.0, rid=2, n=3, batch=8)   # not replayed yet
    assert fill() == pytest.approx(25.0)
    _device_call(2, replays=2)         # a request the program replays twice
    assert fill() == pytest.approx(100.0 * (2 + 3) / (3 * 8))


def test_profile_window_carries_the_loaders_batches(tmp_path):
    """The loader's thread records ``data.batch`` for each batch it
    assembles; a profiled window writes them on that thread's row."""
    class Opt:
        profile_dir = str(tmp_path)
        profile_start = 0
        profile_steps = 1

    class Frames:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            return {"x": np.full((2,), i, np.float32)}

    window = loop.ProfileWindow(Opt(), cuda=False)
    window.before_step(0)
    got = [b["x"][:, 0].tolist() for b in
           tds.BatchLoader(Frames(), 2, shuffle=False)]
    window.after_step(1)
    assert got == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]]
    path, = tmp_path.glob("steps_0-0.trace.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("name") == "data.batch"]
    assert sorted(e["args"]["b"] for e in events) == [0, 1, 2]
    assert {e["cat"] for e in events} == {"span"}
    loader, = {e["tid"] for e in events}
    assert loader != threading.get_native_id()
