"""PyTorch port, the stage-2 step's phase marks (``train/steps.py``), on the
CPU: the host points that put the device marks ``step.g_forward.end`` and
``step.g_backward.end`` on the card's stream, and under the feature flags
(pix2pixHD's encoder E) ``step.feat.begin``, ``step.feat.encoded`` and
``step.feat.end`` inside the renderer's forward before them.

The step runs through ``graphs.StandIn`` (the CPU has no CUDA graphs), at
a tiny size of each benchmark configuration, with the weights the
benchmark draws. ``spans.device_mark`` records a CUDA event, so a recorder
of the names it is given takes its place. The marks a configuration
expects follow from its flags (``expected``):
  * the capture has exactly one segment more than host points: three
    segments without E, six with it;
  * the names come in the order of ``expected`` on each warm-up call, on
    the capture and on each replay;
  * the step's metrics and the updated state are bit-equal with and
    without the host points;
  * the capture counts E's engagement (``Program.feat``, the capture
    line's ``feat a/c``): 1/1 with E, nothing without it;
  * the real ``device_mark`` records nothing for a CPU step, even while
    the recorder is on.
On the card the marks split each replay into the intervals that the
benchmark's ``g_forward_ms.train``, ``g_backward_ms.train`` and
``d_update_ms.train`` read, and under E its forward and the pooling.
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
from test_torch_port_graph_step import stand_in  # noqa: F401 (fixture)
from test_torch_port_local1024 import TINY

CPU = torch.device("cpu")
SEED = 2 ** 31 + 1021
MARKS = ["step.g_forward.end", "step.g_backward.end"]
FEAT_MARKS = ["step.feat.begin", "step.feat.encoded", "step.feat.end"]
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


def _flags(config: str) -> dict:
    return copy.deepcopy(hb.configuration(hb.benchmark(), config)["flags"])


def uses_e(config: str) -> bool:
    flags = _flags(config)
    return bool(flags.get("instance_feat") or flags.get("label_feat"))


def expected(config: str) -> list:
    """The device marks of one call of the configuration's step, in
    order: E's three (the renderer's forward of frame t) where the flags
    build E, then the two phase marks."""
    return (FEAT_MARKS if uses_e(config) else []) + MARKS


def _steps(config: str, calls=None):
    """A benchmark configuration at TINY through the port's stage-2 step:
    STEPS steps on the benchmark's batches, ``calls()`` read after each.
    Returns (metrics a step, the state's tensors, the reads, the
    program)."""
    flags = _flags(config)
    flags.update(TINY, dtype="float32", no_vgg_loss=True)
    if uses_e(config):       # E at a depth 32 px frames hold
        flags.update(nef=4, n_downsample_E=2)
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


def test_the_configurations_with_and_without_e():
    """Both kinds of step stay covered: the committed configurations
    without E, and ``local1024feat`` with it."""
    assert {c: uses_e(c) for c in ("flagship512", "ref512", "local1024",
                                   "local1024feat")} == {
        "flagship512": False, "ref512": False, "local1024": False,
        "local1024feat": True}


@pytest.mark.parametrize("config", CONFIGS)
def test_the_marks_split_the_capture_and_come_in_order(stand_in,
                                                       monkeypatch, config):
    names = []
    monkeypatch.setattr(spans, "device_mark",
                        lambda name, device=None: names.append(name))
    _, _, reads, prog = _steps(config, lambda: list(names))
    marks = expected(config)
    entry, = prog.entries.values()
    assert entry.capture.segments == len(marks) + 1 == (
        6 if uses_e(config) else 3)
    assert len(entry.capture.host_ops) == len(marks)
    # the first call: the warm-up's calls, the capture, its replay; then
    # one replay a call
    calls = graphs.WARMUP + 2
    assert reads[0] == marks * calls
    for i in range(1, STEPS):
        assert reads[i] == marks * (calls + i)


@pytest.mark.parametrize("config", CONFIGS)
def test_the_host_points_change_no_bit(stand_in, monkeypatch, config):
    with_marks = _steps(config)
    entry, = with_marks[3].entries.values()
    assert entry.capture.segments == len(expected(config)) + 1
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


@pytest.mark.parametrize("config", CONFIGS)
def test_the_capture_counts_e(stand_in, capsys, config):
    """E encoded the real frame in the one renderer call of the capture
    (temporal_prev real: no t-1 render), and the capture line says so;
    a configuration without E counts nothing and prints no feat."""
    _, _, _, prog = _steps(config)
    err = capsys.readouterr().err
    line, = [ln for ln in err.splitlines()
             if ln.startswith("[step] graphed (stand-in, capture 1:")]
    if uses_e(config):
        assert prog.feat == [(1, 1)]
        assert ", feat 1/1" in line
    else:
        assert prog.feat == [(0, 0)]
        assert "feat" not in line
