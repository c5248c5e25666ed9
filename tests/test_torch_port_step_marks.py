"""PyTorch port, the stage-2 step's phase marks (``train/steps.py``), on the
CPU: the host points that put the device marks ``step.g_forward.end`` and
``step.g_backward.end`` on the card's stream.

The step runs through ``graphs.StandIn`` (the CPU has no CUDA graphs), at
a tiny size of each benchmark configuration, with the weights the
benchmark draws. ``spans.device_mark`` records a CUDA event, so a recorder
of the names it is given takes its place:
  * the capture has exactly three segments, split by the two host points;
  * the names come in the order ``step.g_forward.end``,
    ``step.g_backward.end`` on each warm-up call, on the capture and on
    each replay;
  * the step's metrics and the updated state are bit-equal with and
    without the host points;
  * the real ``device_mark`` records nothing for a CPU step, even while
    the recorder is on.
On the card the marks split each replay into the three intervals that
the benchmark's ``g_forward_ms.train``, ``g_backward_ms.train`` and
``d_update_ms.train`` read.
"""

import copy
import time

import pytest
import torch

from neural_human_video_rendering_tpu_torch.parallel.mesh import \
    optimizer_tensors
from neural_human_video_rendering_tpu_torch.train import graphs
from neural_human_video_rendering_tpu_torch.train import steps as tsteps
from neural_human_video_rendering_tpu_torch.utils import spans
from perfbench.harness import bench as hb
from perfbench.harness import data
from perfbench.harness.bench import Run
from perfbench.kinds import train
from perfbench.reference.config import reference_config
from test_torch_port_local1024 import TINY

CPU = torch.device("cpu")
SEED = 2 ** 31 + 1021
MARKS = ["step.g_forward.end", "step.g_backward.end"]
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_recorder():
    spans.clear()
    yield
    spans.clear()


@pytest.fixture
def stand_in(monkeypatch):
    """make_train_step takes the graph route on the CPU, with the stand-in
    capture; yields the programs it makes."""
    made = []

    def program(name, device):
        p = graphs.Program(name, device, stand_in=True)
        made.append(p)
        return p

    monkeypatch.setattr(tsteps, "_program", program)
    yield made


def _steps(config: str, calls=None):
    """A benchmark configuration at TINY through the port's stage-2 step:
    STEPS steps on the benchmark's batches, ``calls()`` read after each.
    Returns (metrics a step, the state's tensors, the reads, the
    program)."""
    flags = copy.deepcopy(hb.configuration(hb.benchmark(), config)["flags"])
    flags.update(TINY, dtype="float32", no_vgg_loss=True)
    cfg = reference_config(flags)
    run = Run("t", SEED, 0.0, False, flags, {}, {}, CPU, time.perf_counter())
    batches = data.train_batches(SEED, STEPS, cfg.batchSize, cfg.size, CPU)
    tex, bg = data.assets(SEED, cfg.size, cfg.tex_tile, cfg.n_parts, CPU)
    system = train.Program(run, cfg, train.draw_weights(cfg, SEED, CPU),
                           tex, bg)
    metrics, reads = [], []
    for b in batches:
        metrics.append({k: v.clone() for k, v in system.step(b).items()})
        reads.append(calls() if calls else None)
    st = system.state
    state = {k: t.detach().clone() for k, t in system.leaves().items()}
    for tag, o in (("g_opt", st.g_opt), ("d_opt", st.d_opt)):
        for i, t in enumerate(optimizer_tensors(o)):
            state[f"{tag}.{i}"] = t.detach().clone()
    return metrics, state, reads, system.fn.program


CONFIGS = [c["name"] for c in hb.benchmark()["configs"]]


@pytest.mark.parametrize("config", CONFIGS)
def test_the_marks_split_the_capture_and_come_in_order(stand_in,
                                                       monkeypatch, config):
    names = []
    monkeypatch.setattr(spans, "device_mark",
                        lambda name, device=None: names.append(name))
    _, _, reads, prog = _steps(config, lambda: list(names))
    entry, = prog.entries.values()
    assert entry.capture.segments == 3
    assert len(entry.capture.host_ops) == 2
    # the first call: the warm-up's calls, the capture, its replay; then
    # one replay a call
    calls = graphs.WARMUP + 2
    assert reads[0] == MARKS * calls
    for i in range(1, STEPS):
        assert reads[i] == MARKS * (calls + i)


@pytest.mark.parametrize("config", CONFIGS)
def test_the_host_points_change_no_bit(stand_in, monkeypatch, config):
    with_marks = _steps(config)
    entry, = with_marks[3].entries.values()
    assert entry.capture.segments == 3
    monkeypatch.setattr(tsteps, "host_point", lambda fn: None)
    without = _steps(config)
    entry, = without[3].entries.values()
    assert entry.capture.segments == 1
    for m_with, m_without in zip(with_marks[0], without[0]):
        assert sorted(m_with) == sorted(m_without)
        for k in m_with:
            assert torch.equal(m_with[k], m_without[k]), k
    assert sorted(with_marks[1]) == sorted(without[1])
    for k in with_marks[1]:
        assert torch.equal(with_marks[1][k], without[1][k]), k


def test_a_cpu_step_records_no_device_mark(stand_in):
    with spans.recording():
        _steps("flagship512")
        assert spans.tracing()
    assert list(spans._marks) == []
    assert spans.device_intervals(*MARKS) == []
