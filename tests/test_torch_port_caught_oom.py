"""PyTorch port: a step that caught an out-of-memory error is refused
(``train/graphs.py``: ``refuse_caught_ooms``, ``CaughtOutOfMemory``).

cuDNN catches an out-of-memory error on a plan's workspace and takes
another plan, which rounds differently; a program that did so would run
the whole run on arithmetic the free card does not compute. On the card
the allocator counts those errors (``num_ooms``); here the count comes
from a fake in place of ``graphs.caught_ooms``, and the captures are
``graphs.StandIn``'s:
  * a count that rises during a capture's warm-up, or during the capture,
    raises ``CaughtOutOfMemory`` naming the program, and nothing is
    stored;
  * a flat count captures and replays as before;
  * the eager step beside a program (a call with ``mark``) is refused on
    a call whose count rose, and gives the plain eager step's metrics on
    one whose count stayed;
  * nothing on the trainers' or the server's path catches the error and
    goes on.
The refusal under a real blocker on the card is in
tests/test_torch_port_cuda.py (``gpu``) and chip_smoke.py phase 17.
"""

import ast
import os

import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu_torch.config import Options as TOptions
from neural_human_video_rendering_tpu_torch.data import dataset as tds
from neural_human_video_rendering_tpu_torch.train import graphs
from neural_human_video_rendering_tpu_torch.train import state as tstate
from neural_human_video_rendering_tpu_torch.train import steps as tsteps
from test_torch_port_graph_step import stand_in  # noqa: F401 (fixture)

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "neural_human_video_rendering_tpu_torch")

TINY_STEP = dict(
    loadSize=32, tex_tile=16, batchSize=2, n_blocks_translate=1,
    n_downsample_translate=2, n_blocks_global=1, n_downsample_global=1,
    n_blocks_bg=1, n_downsample_bg=1, ngf=4, ngf_global=4, ndf=4, num_D=2,
    n_layers_D=2, dtype="float32", no_flip=True, pose_heatmaps=True,
    coord_conv=True, stem_s2d=2, head_s2d=2, bg_s2d=4, pad_mode="same",
    warp_topk=24, warp_eps=0.0, lambda_L2=500, lambda_UV=1000,
    lambda_Prob=10, lambda_Temp=500, use_densepose_loss=True,
    no_vgg_loss=True, ema_decay=0.999, temporal_prev="real")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def count(monkeypatch):
    """The allocator's count of out-of-memory errors, faked: a one-element
    list the test raises where an error 'was caught'."""
    n = [0]
    monkeypatch.setattr(graphs, "caught_ooms", lambda device: n[0])
    return n


def _toy(calls, count, rise_at=None):
    """make_closure of a closure that doubles its input and bumps a state
    tensor; its call number ``rise_at`` (1-based: the warm-up's calls come
    first, then the capture's) raises the count."""
    acc = torch.zeros(2)

    def make(static):
        def closure():
            calls.append(1)
            if len(calls) == rise_at:
                count[0] += 1
            acc.add_(1.0)
            return {"y": static["x"] * 2.0}
        return closure

    return make, acc


@pytest.mark.parametrize("rise_at, region", [
    (1, "the warm-up of capture 1"), (graphs.WARMUP, "the warm-up of capture 1"),
    (graphs.WARMUP + 1, "capture 1")])
def test_a_caught_error_refuses_the_capture(count, rise_at, region):
    prog = graphs.Program("toy", torch.device("cpu"), stand_in=True)
    calls = []
    make, acc = _toy(calls, count, rise_at)
    with pytest.raises(graphs.CaughtOutOfMemory) as e:
        prog("k", {"x": torch.ones(2)}, make, state=lambda: [acc])
    first = str(e.value).splitlines()[0]
    assert first.startswith(f"[toy] refused: 1 out-of-memory error caught "
                            f"in {region} on cpu")
    assert "arithmetic would depend on the memory free" in str(e.value)
    assert isinstance(e.value, RuntimeError)
    # nothing stored: a later call captures anew (and, the count flat now,
    # keeps that capture)
    assert prog.entries == {} and prog.captures == 0 and prog.memory == []
    # the refused warm-up left the state as it was
    assert torch.equal(acc, torch.zeros(2))
    before = len(calls)
    out = prog("k", {"x": torch.ones(2)}, make, state=lambda: [acc])
    assert torch.equal(out["y"], torch.full((2,), 2.0))
    assert prog.captures == 1 and len(prog.entries) == 1
    assert len(calls) == before + graphs.WARMUP + 2


def test_a_flat_count_captures_and_replays(count, capsys):
    count[0] = 7                     # errors from before the program count not
    prog = graphs.Program("toy", torch.device("cpu"), stand_in=True)
    calls = []
    make, acc = _toy(calls, count)
    for x in (torch.ones(2), torch.arange(2.0)):
        out = prog("k", {"x": x}, make, state=lambda: [acc])
        assert torch.equal(out["y"], x * 2.0)
    assert prog.captures == 1 and len(calls) == graphs.WARMUP + 3
    assert torch.equal(acc, torch.full((2,), 2.0))
    assert "[toy] graphed (stand-in, capture 1" in capsys.readouterr().err


def test_an_error_leaving_the_region_is_not_replaced(count):
    """An out-of-memory error nobody caught propagates as itself."""
    with pytest.raises(torch.OutOfMemoryError):
        with graphs.refuse_caught_ooms("toy", torch.device("cpu"), "a call"):
            count[0] += 1
            raise torch.OutOfMemoryError("CUDA out of memory")


def test_the_cpu_count_is_zero_and_reads_no_allocator():
    assert graphs.caught_ooms(torch.device("cpu")) == 0
    with graphs.refuse_caught_ooms("toy", torch.device("cpu"), "a call"):
        pass
    assert graphs._watchers == {} and graphs._sites == []


# ------------------------------------------- the eager step with a mark

def _tiny_state(tmp_path):
    opt = TOptions(**TINY_STEP, checkpoints_dir=str(tmp_path), gpu_ids="-1")
    ds = tds.SyntheticDataset(opt, length=4, seed=3)
    batch = tds.collate([ds[1], ds[2]])
    atlas = np.random.default_rng(5).uniform(
        -0.5, 0.5, (opt.n_parts, opt.tex_tile, opt.tex_tile, 3)
    ).astype(np.float32)
    torch.manual_seed(0)
    st = tstate.create_train_state(opt, atlas, ds.background(),
                                   device=torch.device("cpu"))
    return opt, st, batch


def _sgd_step(opt, st):
    return tsteps.make_train_step(
        opt, st.renderer, st.disc, None,
        torch.optim.SGD(st.renderer.parameters(), lr=1.0),
        torch.optim.SGD(st.disc.parameters(), lr=1.0))


def test_an_eager_call_that_caught_an_error_is_refused(count, stand_in,
                                                       tmp_path):
    """The eager step beside a program (a stand-in here, a CUDA graph's on
    the card), called with a mark: a call whose count rose raises; one
    whose count stayed flat gives the plain eager step's metrics."""
    opt, st, batch = _tiny_state(tmp_path)
    with stand_in.cpu():
        plain = {k: float(v) for k, v in
                 _sgd_step(opt, st)(st, batch).items()}

    opt, st, batch = _tiny_state(tmp_path)
    step = _sgd_step(opt, st)
    marks = []

    def rising(name):
        marks.append(name)
        if name == "g_backward":
            count[0] += 1

    with pytest.raises(graphs.CaughtOutOfMemory,
                       match=r"^\[step\] refused: 1 out-of-memory error "
                             r"caught in an eager call on cpu"):
        step(st, batch, rising)
    assert "g_backward" in marks and step.program.captures == 0

    opt, st, batch = _tiny_state(tmp_path)
    step = _sgd_step(opt, st)
    got = {k: float(v) for k, v in
           step(st, batch, lambda name: None).items()}
    assert got == plain
    assert step.program.captures == 0


# ------------------------------------------ nothing on the path catches it

PATH_FILES = ("train/loop.py", "train/drivers.py", "serve.py",
              "train/steps.py")
# the calls that reach a step or a program on these files' paths
STEP_CALLS = {"step", "program", "render", "_call", "fwd", "forward",
              "body", "run_training", "submit", "result"}
# what an ``except`` names that would catch CaughtOutOfMemory
CATCHING = {"CaughtOutOfMemory", "RuntimeError", "Exception",
            "BaseException"}


def _names(node):
    if node is None:
        return {"BaseException"}          # a bare except
    if isinstance(node, ast.Tuple):
        return set().union(*(_names(e) for e in node.elts))
    if isinstance(node, ast.Attribute):
        return {node.attr}
    if isinstance(node, ast.Name):
        return {node.id}
    return set()


def _called(nodes):
    out = set()
    for n in nodes:
        for c in ast.walk(n):
            if isinstance(c, ast.Call):
                f = c.func
                out.add(f.attr if isinstance(f, ast.Attribute)
                        else getattr(f, "id", None))
    return out


def handlers_that_go_on(source: str):
    """The ``except`` clauses that would catch CaughtOutOfMemory around a
    call that reaches a step or a program, and do not raise again."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if not isinstance(node, ast.Try) or not (
                _called(node.body) & STEP_CALLS):
            continue
        for h in node.handlers:
            reraises = any(isinstance(r, ast.Raise) for b in h.body
                           for r in ast.walk(b))
            if _names(h.type) & CATCHING and not reraises:
                bad.append(h.lineno)
    return bad


@pytest.mark.parametrize("path", PATH_FILES)
def test_no_handler_on_the_path_goes_on_after_a_refusal(path):
    with open(os.path.join(PORT, path)) as f:
        assert handlers_that_go_on(f.read()) == [], path


def test_the_scan_finds_a_handler_that_goes_on():
    src = ("try:\n    out = step(state, batch)\nexcept RuntimeError:\n"
           "    out = None\n"
           "try:\n    out = model.render(j)\nexcept Exception as e:\n"
           "    log(e)\n    raise\n"
           "try:\n    n = int(x)\nexcept Exception:\n    n = 0\n")
    assert handlers_that_go_on(src) == [3]
