"""PyTorch port, the measurement tools against the JAX package's tools on
the CPU: quality_profile (tools/quality_profile.py), fabricate_source
(tools/round4/fabricate_source.py) and dedup_metrics
(tools/round5/dedup_metrics.py), each JAX tool loaded by path with its
sys.argv patched; and the two tools with no JAX run here: bench_serve (a
tiny program served on the CPU) and bench_trained_regime (the bench's
options shrunk to tiny widths).

The corpus is make_demo_data's at 64 px (tile 16) from SyntheticDataset
joints, and G a random-init tiny renderer saved by the JAX package's own
checkpoint saver: both tools read the same files.

Tolerances: every variant and tile 1e-3 dB PSNR and 1e-4 SSIM (float32
forwards of two frameworks; one-hot substitutions sum one part). The
model's variants are compared with all parts blended (--warp_topk 24
--warp_eps 0: a top-k choice among near-equal random-init probabilities
flips on rounding); the one-hot substitutions also at the flagship's k=4,
eps=1e-3, where exactly one part a pixel is non-zero. fabricate_source
and dedup_metrics byte for byte.
"""

import importlib.util
import json
import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from neural_human_video_rendering_tpu.config import Options as JOptions
from neural_human_video_rendering_tpu.data import dataset as jds
from neural_human_video_rendering_tpu.train import state as jstate
from neural_human_video_rendering_tpu.utils import checkpoint as jckpt
from neural_human_video_rendering_tpu_torch import bench as tbench
from neural_human_video_rendering_tpu_torch import (bench_serve,
                                                    bench_trained_regime,
                                                    dedup_metrics,
                                                    export_serving,
                                                    fabricate_source,
                                                    make_demo_data,
                                                    quality_profile)
from neural_human_video_rendering_tpu_torch.config import Options as TOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, T = 64, 16
FRAMES = 20                  # 2 held-out frames at --data_ratio 0.9
WIDTHS = dict(ngf=4, ngf_global=4, ndf=4, n_blocks_translate=1,
              n_downsample_translate=2, n_blocks_global=1,
              n_downsample_global=1, n_blocks_bg=1, n_downsample_bg=1,
              n_layers_D=2, dtype="float32")
ALL_PARTS = dict(warp_topk=24, warp_eps=0.0)
ONE_HOT = ("transg_gt", "all_gt_file", "all_gt_exact")
PSNR_TOL, SSIM_TOL = 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_tool(rel):
    """A JAX tool loaded by path (nothing under tools/ changes)."""
    name = "_jax_" + rel.replace("/", "_")[:-3]
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flag_list(d):
    out = []
    for k, v in d.items():
        out += [f"--{k}", str(v)]
    return out


def write_keypoints(kp_dir, n=FRAMES):
    chip_smoke.write_driving_sequence(TOptions(loadSize=S), str(kp_dir), n)
    return str(kp_dir)


def write_jax_g(run_dir, data, **kw):
    """A random-init tiny G saved by the JAX package's saver (epoch 1 and
    latest) into run_dir."""
    jopt = JOptions(loadSize=S, tex_tile=T, **WIDTHS, **kw)
    tex = jds.load_texture_atlas(f"{data}/texture.png", T, jopt.tex_rows,
                                 jopt.tex_cols)
    bg = jds.load_image(f"{data}/bg.jpg", S)
    bundle = jstate.create_train_state(jopt, jax.random.PRNGKey(0), tex, bg,
                                       with_discriminator=False)
    jckpt.save_net(str(run_dir), "G", 1, bundle["state"].g_params)
    return str(run_dir)


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """The JAX tool once (all parts blended), the port at the same flags
    and at the flagship's k and eps."""
    tmp = tmp_path_factory.mktemp("qprof")
    kp = write_keypoints(tmp / "kp")
    data = str(tmp / "data")
    make_demo_data.main(["--keypoints", kp, "--out", data, "--size", str(S),
                         "--tile", str(T)])
    run = write_jax_g(tmp / "run", data)
    base = ["--data", data, "--run_dir", run, "--how_many", "2",
            "--ceiling_tiles", "16,32"]
    model = flag_list(dict(loadSize=S, tex_tile=T, **WIDTHS))
    jtool = load_tool("tools/quality_profile.py")
    argv = sys.argv
    sys.argv = ["quality_profile.py", *base, "--out", str(tmp / "jax.json"),
                "--", *model, *flag_list(ALL_PARTS), "--no_use_pallas_warp"]
    try:
        jtool.main()
    finally:
        sys.argv = argv
    with open(tmp / "jax.json") as f:
        jax_res = json.load(f)
    port = {}
    for tag, warp in (("all_parts", ALL_PARTS),
                      ("flagship", dict(warp_topk=4, warp_eps=1e-3))):
        out = str(tmp / f"port_{tag}.json")
        port[tag] = quality_profile.main(
            base + ["--out", out, "--", *model, *flag_list(warp),
                    "--gpu_ids", "-1"])
        with open(out) as f:
            assert json.load(f) == json.loads(json.dumps(port[tag]))
    return jax_res, {k: json.loads(json.dumps(v)) for k, v in port.items()}


def _close(got, ref, what):
    assert abs(got["PSNR"] - ref["PSNR"]) <= PSNR_TOL, (what, got, ref)
    assert abs(got["SSIM"] - ref["SSIM"]) <= SSIM_TOL, (what, got, ref)


def test_quality_profile_matches_jax(profiled):
    jax_res, port = profiled
    got = port["all_parts"]
    assert got["config"] == jax_res["config"]
    assert got["config"]["frames"] == 2
    assert sorted(got["variants"]) == sorted(jax_res["variants"]) == sorted(
        ["full", "transg_gt", "texg_static", "mask_gt", "bg_gt",
         "all_gt_file", "all_gt_exact"])
    for name, ref in jax_res["variants"].items():
        _close(got["variants"][name], ref, name)
    assert sorted(got["tile_ceiling"]) == sorted(jax_res["tile_ceiling"]) \
        == ["16", "32"]
    for t, ref in jax_res["tile_ceiling"].items():
        _close(got["tile_ceiling"][t], ref, f"tile {t}")


def test_quality_profile_one_hot_at_the_flagship_k(profiled):
    """At k=4, eps=1e-3 the one-hot substitutions and the tile sweep are
    JAX's all-parts numbers (one part a pixel carries all the weight)."""
    jax_res, port = profiled
    got = port["flagship"]
    for name in ONE_HOT:
        _close(got["variants"][name], jax_res["variants"][name], name)
    for t, ref in jax_res["tile_ceiling"].items():
        _close(got["tile_ceiling"][t], ref, f"tile {t}")
    assert all(np.isfinite(v["PSNR"]) and np.isfinite(v["SSIM"])
               for v in list(got["variants"].values())
               + list(got["tile_ceiling"].values()))
    assert quality_profile.launches_per_frame(2) == 7


def test_quality_profile_refuses_a_split_of_the_whole_corpus(tmp_path):
    kp = write_keypoints(tmp_path / "kp", 6)
    data = str(tmp_path / "data")
    make_demo_data.main(["--keypoints", kp, "--out", data, "--size", str(S),
                         "--tile", str(T)])
    with pytest.raises(AssertionError, match="data_ratio"):
        quality_profile.main(["--data", data, "--run_dir", str(tmp_path),
                              "--data_ratio", "1.0", "--",
                              "--loadSize", str(S), "--gpu_ids", "-1"])


def test_gt_warp_copies_the_shared_uv_to_every_part():
    """The GT injection's one UV becomes P contiguous planes (the kernels'
    part stride is at least a plane), equal to the broadcast."""
    seen = {}

    def spy(tex, uv, probs, k, eps):
        seen["uv"] = uv
        return quality_profile.kernel_warp(tex, uv, probs, k, eps)

    g = torch.Generator().manual_seed(0)
    tex = torch.rand((1, 24, 3, 8, 8), generator=g) * 2 - 1
    uv2 = torch.rand((1, 2, 16, 16), generator=g)
    onehot = quality_profile.one_hot(
        np.random.default_rng(0).integers(0, 25, (16, 16)), 25,
        torch.device("cpu"))
    out = quality_profile.gt_warp(spy, tex, uv2, onehot, 4, 1e-3)
    uv = seen["uv"]
    assert uv.is_contiguous() and uv.shape == (1, 24, 2, 16, 16)
    assert onehot.is_contiguous() and onehot.shape == (1, 25, 16, 16)
    assert torch.equal(uv, uv2[:, None].expand(1, 24, 2, 16, 16))
    assert out.shape == (1, 3, 16, 16) and bool(torch.isfinite(out).all())


def test_fabricate_source_byte_equal(tmp_path, monkeypatch):
    kp = write_keypoints(tmp_path / "kp", 4)
    jtool = load_tool("tools/round4/fabricate_source.py")
    for args in ([], ["--scale", "0.7", "--shift", "-5", "12.5"]):
        jout, tout = tmp_path / "jax", tmp_path / "port"
        monkeypatch.setattr(sys, "argv", ["fabricate_source.py", "--src", kp,
                                          "--out", str(jout), *args])
        jtool.main()
        fabricate_source.main(["--src", kp, "--out", str(tout), *args])
        names = sorted(os.listdir(jout))
        assert names == sorted(os.listdir(tout)) and len(names) == 4
        for n in names:
            assert (jout / n).read_bytes() == (tout / n).read_bytes(), n


def test_dedup_metrics_cli_byte_equal(tmp_path, monkeypatch, capsys):
    recs = ([{"epoch": e, "it": -1, "step": e, "val_PSNR": 20.0 + e}
             for e in range(1, 6)]
            + [{"epoch": e, "it": -1, "step": e, "val_PSNR": 30.0 + e}
               for e in range(3, 7)])
    text = "".join(json.dumps(r) + "\n" for r in recs)
    dirs = {}
    for name in ("jax", "port"):
        for run in ("a", "b"):
            d = tmp_path / name / run
            d.mkdir(parents=True)
            (d / "metrics.jsonl").write_text(text if run == "a" else "")
        dirs[name] = [str(tmp_path / name / r) for r in ("a", "b")]
    monkeypatch.setattr(sys, "argv", ["dedup_metrics.py", *dirs["jax"]])
    runpy.run_path(os.path.join(REPO, "tools/round5/dedup_metrics.py"),
                   run_name="__main__")
    jax_out = capsys.readouterr().out
    assert dedup_metrics.main(dirs["port"]) == 0
    port_out = capsys.readouterr().out
    assert port_out.replace(str(tmp_path / "port"), "X") == \
        jax_out.replace(str(tmp_path / "jax"), "X")
    assert "total dropped: 3" in port_out
    for run in ("a", "b"):
        assert (tmp_path / "port" / run / "metrics.jsonl").read_bytes() == \
            (tmp_path / "jax" / run / "metrics.jsonl").read_bytes()


def test_bench_serve_ladder_on_the_cpu(tmp_path):
    """A tiny program served on the CPU by a server subprocess: the JSON
    keys, a positive ladder, and the server gone (a clean exit on SIGINT,
    its launches printed: none on the CPU)."""
    kp = write_keypoints(tmp_path / "kp", 3)
    model = str(tmp_path / "m.pt2")
    assert export_serving.main(
        ["--out", model, "--batch", "2", "--gpu_ids", "-1", "--loadSize",
         "32", "--tex_tile", "16", *flag_list(WIDTHS), "--checkpoints_dir",
         str(tmp_path / "ck")]) == 0
    result, server = bench_serve.run_ladder(model, kp, requests=2,
                                            concurrency="1,2",
                                            gpu_ids="-1")
    assert list(result) == ["artifact", "batch", "ladder", "n_requests"]
    assert result["artifact"] == "m.pt2" and result["batch"] == 2
    assert result["n_requests"] == 2 and list(result["ladder"]) == ["1", "2"]
    assert all(v > 0 for v in result["ladder"].values())
    assert server["rc"] == 0
    assert server["launches"] == {k: 0 for k in chip_smoke.train_launches()}


def test_bench_trained_regime_windows(monkeypatch, capsys):
    """2 windows of 2 steps at the bench's options shrunk to tiny widths:
    one line a window with a finite G_Prob, then the summary line."""
    real = tbench.bench_options

    def tiny(tex_tile, warp_dtype, gpu_ids="0", recipe_cfg=None):
        opt = real(tex_tile, warp_dtype, gpu_ids, recipe_cfg)
        for k, v in dict(WIDTHS, loadSize=32, tex_tile=16).items():
            setattr(opt, k, v)
        return opt

    monkeypatch.setattr(tbench, "bench_options", tiny)
    assert bench_trained_regime.main(["--windows", "2", "--window_steps", "2",
                                      "--gpu_ids", "-1"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [list(x) for x in lines[:2]] == [
        ["window", "steps_per_sec", "G_Prob"]] * 2
    assert [x["window"] for x in lines[:2]] == [0, 1]
    assert all(np.isfinite(x["G_Prob"]) and x["steps_per_sec"] > 0
               for x in lines[:2])
    assert list(lines[2]) == ["metric", "first_window_sps", "last_window_sps",
                              "speedup"]
    assert lines[2]["metric"] == "trained_regime_speedup_512px_bs2"
