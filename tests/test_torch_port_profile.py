"""PyTorch port, ``profile_step`` (the JAX package's tools/profile_step.py):
the analysis of a CPU trace of a tiny stage-2 step and of the trainer's
--profile_dir window, and the CUDA attribution on a hand-written trace
(kernels matched to their launches by correlation id, backward kernels to
the forward op of their autograd node), all on the CPU.

Exact checks: every row names a source line of the port (or the row of
work outside it), and the rows sum to the trace's total.
"""

import json

import pytest
import torch

from neural_human_video_rendering_tpu_torch import profile_step as ps
from neural_human_video_rendering_tpu_torch.config import Options, TrainOptions
from neural_human_video_rendering_tpu_torch.train import drivers
from test_torch_port_pretrain import TINY
from test_torch_port_train_step import STEP_FLAGS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_rows(out):
    assert out["rows"] and out["n_rows"] == len(out["rows"])
    for r in out["rows"]:
        assert r["frame"] == ps.NO_FRAME or r["frame"].startswith(ps.PACKAGE)
    key = [k for k in out if k.endswith("_ms_per_step")][0]
    assert out["rows_ms_total"] == pytest.approx(out[key] * out["steps"],
                                                 rel=1e-9)
    assert sum(r["share"] for r in out["rows"]) == pytest.approx(1.0)


def test_cpu_trace_of_a_tiny_step(tmp_path, capsys):
    opt = Options(**dict(STEP_FLAGS, temporal_prev="real"), gpu_ids="-1")
    path = ps.run_trace(opt, str(tmp_path), steps=2, infer=False)
    out = ps.analyze(path, top=1000)
    assert out["events"] == "cpu ops" and out["steps"] == 2
    assert "device_ms_per_step" not in out        # the CPU is no device
    assert 0 < out["busy_share"] <= 1
    assert out["cpu_op_ms_per_step"] <= out["step_ms"]
    _assert_rows(out)
    frames = [r["frame"] for r in out["rows"]]
    assert any("models/layers.py" in f and f.endswith("(backward)")
               for f in frames)
    assert any("ops/texture_warp" in f for f in frames)
    # the CLI on the saved directory prints the same analysis as one line
    assert ps.main(["--analyze", str(tmp_path), "--top", "1000"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["rows"] == out["rows"] and line["trace"] == str(tmp_path)


def test_trainer_profile_window_is_analyzable(tmp_path):
    prof = tmp_path / "prof"
    drivers.run_train(TrainOptions().parse(TINY + [
        "--checkpoints_dir", str(tmp_path), "--name", "p", "--niter", "1",
        "--no_decay", "--profile_dir", str(prof), "--profile_start", "1",
        "--profile_steps", "1"]), max_steps=2)
    out = ps.analyze(str(prof), top=1000)
    assert out["steps"] == 1 and out["events"] == "cpu ops"
    _assert_rows(out)
    assert any("train/steps.py" in r["frame"] or "models/" in r["frame"]
               for r in out["rows"])


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 0, "args": args}


def test_kernels_by_launch_and_autograd_node(tmp_path):
    """Main thread 1 runs two frames of the package, one launching kernel
    A inside a forward op with sequence number 7; the autograd thread 2
    launches kernel B inside the backward node of sequence number 7 and
    kernel C outside any node; kernel D has no launch event."""
    P = "/x/" + ps.PACKAGE
    ev = [
        _x("user_annotation", ps.STEP_SPAN, 0, 100),
        _x("python_function", P + "models/a.py(3): forward", 0, 50),
        _x("python_function", P + "models/b.py(9): conv", 10, 20),
        _x("cpu_op", "aten::conv2d", 12, 10, **{"Sequence number": 7,
                                               "Fwd thread id": 0}),
        _x("cuda_runtime", "cudaLaunchKernel", 14, 1, correlation=1),
        _x("cpu_op", "autograd::engine::evaluate_function: ConvBackward0",
           60, 20, tid=2, **{"Sequence number": 7, "Fwd thread id": 1}),
        _x("cuda_driver", "cuLaunchKernel", 65, 1, tid=2, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 90, 1, tid=2, correlation=3),
        _x("kernel", "A", 20, 4, tid=7, correlation=1),
        _x("kernel", "B", 70, 6, tid=7, correlation=2),
        _x("kernel", "C", 92, 2, tid=7, correlation=3),
        _x("gpu_memcpy", "D", 95, 1, tid=7, correlation=4),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    out = ps.analyze(str(path))
    rows = {r["frame"]: r["ms_per_step"] for r in out["rows"]}
    assert rows == {ps.PACKAGE + "models/b.py(9): conv": 0.004,
                    ps.PACKAGE + "models/b.py(9): conv (backward)": 0.006,
                    ps.NO_FRAME: 0.003}
    assert out["events"] == "cuda kernels"
    assert out["device_ms_per_step"] == pytest.approx(0.013)
    assert out["step_ms"] == pytest.approx(0.1)
    assert out["busy_share"] == pytest.approx(0.13)
    _assert_rows(out)
