"""PyTorch port, the benchmark entry points and the quality run on the CPU:
bench's checkpoint resolution against the JAX package's bench.py on the
same directories (plus the port's .pth files), load_bench_state's G-only
and G+D cases, the two timing functions and both entry points at tiny
widths (their JSON keys: the JAX lines' but vs_baseline in bench's), and
one small quality run through the port's five entry points producing
quality_run.json."""

import functools
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu.utils import checkpoint as jckpt
from neural_human_video_rendering_tpu_torch import bench as tbench
from neural_human_video_rendering_tpu_torch import bench_infer as tbench_infer
from neural_human_video_rendering_tpu_torch.config import Options
from neural_human_video_rendering_tpu_torch.data.dataset import \
    SyntheticDataset
from neural_human_video_rendering_tpu_torch.data.keypoints import (
    BODY25_TO_COCO18, write_keypoint_json)
from neural_human_video_rendering_tpu_torch.utils import checkpoint as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench as jbench  # noqa: E402  (the JAX package's bench.py)

CPU = torch.device("cpu")
TINY = dict(loadSize=32, tex_tile=16, ngf=4, ngf_global=4, ndf=4,
            n_blocks_translate=1, n_downsample_translate=2,
            n_blocks_global=1, n_downsample_global=1, n_blocks_bg=1,
            n_downsample_bg=1, n_layers_D=2, dtype="float32")
BENCH_KEYS = ["metric", "value", "unit", "inference_fps", "regime"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _g_msgpack(path):
    os.makedirs(path, exist_ok=True)
    jckpt.save_net(str(path), "G", "latest", {"w": jnp.zeros(2)})


def _g_pth(path):
    tckpt.save_net(str(path), "G", "latest", {"w": torch.zeros(2)})


def _metrics(flag):
    (flag / "recipe.json").write_text(json.dumps(
        {"config": {"tex_tile": 64, "pose_heatmaps": True}}))
    lines = [{"epoch": 1, "it": 3, "step": 45, "G_total": 9.0},
             {"epoch": 1, "it": -1, "step": 45, "val_PSNR": 21.0,
              "val_SSIM": 0.7},
             "not json",
             {"epoch": 22, "it": -1, "step": 990, "val_PSNR": 27.23,
              "val_SSIM": 0.92}]
    (flag / "metrics.jsonl").write_text("\n".join(
        x if isinstance(x, str) else json.dumps(x) for x in lines) + "\n")


# the cases of tests/test_bench_ckpt.py: (dirs holding a JAX G, the
# argument, whether flagship gets a recipe and metrics)
RESOLVE_CASES = {
    "auto_no_checkpoints": ((), "auto", False),
    "auto_prefers_flagship": (("flagship", "r4/e2e_base"), "auto", False),
    "auto_falls_back_to_e2e_base": (("r4/e2e_base",), "auto", False),
    "forced_off": (("flagship",), "", False),
    "reads_recipe_and_provenance": (("flagship",), "auto", True),
    "provenance_without_metrics": (("flagship",), "auto", False),
    "explicit_dir": (("flagship",), "checkpoints/flagship", True),
}


@pytest.mark.parametrize("case", list(RESOLVE_CASES))
def test_resolve_checkpoint_matches_jax(tmp_path, case):
    dirs, arg, with_metrics = RESOLVE_CASES[case]
    for d in dirs:
        _g_msgpack(tmp_path / "checkpoints" / d)
    if with_metrics:
        _metrics(tmp_path / "checkpoints" / "flagship")
    if arg not in ("", "auto"):
        arg = str(tmp_path / arg)
    got = tbench.resolve_checkpoint(str(tmp_path), arg)
    assert got == jbench.resolve_checkpoint(str(tmp_path), arg)
    if case == "reads_recipe_and_provenance":
        assert got[1]["tex_tile"] == 64 and got[2] == "ep22,val27.2dB"


def test_resolve_checkpoint_finds_port_pth_first(tmp_path):
    """The port's .pth files count as a G (the JAX bench sees only
    .msgpack): a .pth flagship wins over a .msgpack e2e_base."""
    flag = tmp_path / "checkpoints" / "flagship"
    _g_pth(flag)
    _g_msgpack(tmp_path / "checkpoints" / "r4" / "e2e_base")
    assert tbench.resolve_checkpoint(str(tmp_path), "auto") == (
        str(flag), {}, "ep?")
    assert jbench.resolve_checkpoint(str(tmp_path), "auto")[0] == str(
        tmp_path / "checkpoints" / "r4" / "e2e_base")


class _State:
    def __init__(self, seed):
        g = torch.Generator().manual_seed(seed)
        self.renderer = torch.nn.Linear(3, 2)
        self.disc = torch.nn.Linear(2, 1)
        for m in (self.renderer, self.disc):
            for p in m.parameters():
                p.data = torch.randn(p.shape, generator=g)


@pytest.mark.parametrize("with_d", [False, True])
def test_load_bench_state(tmp_path, capsys, with_d):
    saved = _State(1)
    tckpt.save_net(str(tmp_path), "G", "latest", saved.renderer.state_dict())
    if with_d:
        tckpt.save_net(str(tmp_path), "D", "latest", saved.disc.state_dict())
    st = _State(2)
    d_before = st.disc.weight.detach().clone()
    out, suffix = tbench.load_bench_state(str(tmp_path), st)
    assert out is st
    assert torch.equal(st.renderer.weight, saved.renderer.weight)
    if with_d:
        assert suffix == "" and torch.equal(st.disc.weight, saved.disc.weight)
    else:
        assert suffix == "+randD"
        assert torch.equal(st.disc.weight, d_before)
        assert "no D net" in capsys.readouterr().err


BENCH_OPTIONS = tbench.bench_options


def _tiny_bench_options(tex_tile, warp_dtype, gpu_ids="0", recipe_cfg=None):
    """The bench's operating point at the TINY widths."""
    opt = BENCH_OPTIONS(tex_tile, warp_dtype, gpu_ids, recipe_cfg)
    for k, v in TINY.items():
        setattr(opt, k, v)
    return opt


def test_timing_functions_at_tiny_widths():
    opt = _tiny_bench_options(128, "bfloat16", "-1")
    sps, st, suffix = tbench.train_steps_per_sec(opt, CPU, iters=2, rounds=1)
    assert np.isfinite(sps) and sps > 0 and suffix == "" and st.step == 3
    assert set(st.metrics) >= {"G_GAN", "G_VGG", "G_Temp", "G_total"}
    fps = tbench.inference_fps(opt, st.renderer, (st.static_tex, st.bg,
                                                  st.tex_mask), CPU, batch=2,
                               iters=2)
    assert np.isfinite(fps) and fps > 0
    line = tbench.bench_line(sps, fps, "randinit+bf16warp")
    assert list(line) == BENCH_KEYS
    assert line["metric"] == "train_steps_per_sec_512px_bs2"


def test_entry_points_print_their_json_line(monkeypatch, capsys):
    """bench.main and bench_infer.main with their operating points cut to
    tiny widths (steps and forwards cut too): one JSON line each, the
    JAX lines' keys (bench without vs_baseline)."""
    monkeypatch.setattr(tbench, "bench_options", _tiny_bench_options)
    monkeypatch.setattr(tbench, "train_steps_per_sec", functools.partial(
        tbench.train_steps_per_sec, iters=2))
    assert tbench.main(["--ckpt", "", "--gpu_ids", "-1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == BENCH_KEYS and line["regime"] == "randinit+bf16warp"
    assert line["value"] > 0 and line["inference_fps"] > 0

    def tiny_infer(gpu_ids="0"):
        return Options(batchSize=8, gpu_ids=gpu_ids, **TINY)

    monkeypatch.setattr(tbench_infer, "infer_options", tiny_infer)
    assert tbench_infer.main(["--gpu_ids", "-1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "inference_fps_512px"
    assert line["vs_baseline"] == pytest.approx(line["value"] / 30, abs=1e-3)


def test_quality_run_small_writes_the_jax_schema(tmp_path):
    """quality_run --small at 32 px through the port's five entry points
    (subprocesses, on the CPU): the JAX tool's quality_run.json schema."""
    kp = tmp_path / "kp"
    kp.mkdir()
    for i, j in enumerate(SyntheticDataset(Options(loadSize=64), length=10,
                                           seed=0).joints):
        body = np.zeros((25, 3), np.float32)
        body[BODY25_TO_COCO18] = j
        write_keypoint_json(str(kp / f"frame{i:05d}_keypoints.json"), body)
    out = tmp_path / "q"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "neural_human_video_rendering_tpu_torch."
         "quality_run", "--out", str(out), "--keypoints", str(kp), "--small",
         "--size", "32", "--tile", "16", "--epochs", "1", "--pre_epochs", "1",
         "--extra", "--gpu_ids -1"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    with open(out / "quality_run.json") as f:
        q = json.load(f)
    assert list(q) == ["config", "val_curve", "final_parity_all_frames",
                       "stage_seconds"]
    assert q["config"] == {"size": 32, "tile": 16, "epochs": 1,
                           "pre_epochs": 1, "batch": 2, "model": "small",
                           "frames": 10, "train_frames": 9}
    assert [p["epoch"] for p in q["val_curve"]] == [1]
    assert np.isfinite([q["val_curve"][0]["val_PSNR"],
                        q["val_curve"][0]["val_SSIM"]]).all()
    parity = q["final_parity_all_frames"]
    assert set(parity) == {"psnr", "ssim", "temporal_l1", "temporal_l1_gt",
                           "flicker_ratio", "frames"}
    assert parity["frames"] == 10 and np.isfinite(list(parity.values())).all()
    assert len(os.listdir(out / "renders" / "images")) == 10
    assert list(q["stage_seconds"]) == ["make_demo_data", "pre_train",
                                        "train", "test_driver", "evaluate"]
    log = (out / "run.log").read_text()
    assert '[kernels] launches since the counters\' reset: {"topk_select": 0' \
        in log
