"""PyTorch port, the A/B tools against the JAX package's on the CPU:
noisy_gt_ab.refinement_metrics (tools/noisy_gt_ab.py), ms_uv_ab64.score
(tools/round5/ms_uv_ab64.py) and noisyab_anatomy's ssim_map and
region_psnr (tools/round4/noisyab_anatomy.py), each JAX tool loaded by
path; then the port's noisyab_anatomy on an A/B dir, and noisy_gt_ab's
rules for a finished corpus (its sentinel) and a finished arm (its saved
epoch).

Corpora: make_demo_data at 64 px (tile 16) from SyntheticDataset joints,
clean and --corrupt 0.5. G: a random-init tiny renderer saved by the JAX
package's checkpoint saver, read by both tools. The models blend all
parts (--warp_topk 24 --warp_eps 0: a top-k choice among near-equal
random-init probabilities flips on rounding).

Tolerances: render PSNR 1e-3 dB and SSIM 1e-4; mask IoU within one
pixel's share of the frame (1 / 64^2); bg PSNR 1e-3 dB; the UV L1 and the
part accuracy 1e-5 (float32 forwards of two frameworks); the SSIM map
1e-5 and region PSNR 1e-4 dB on the same images.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu_torch import make_demo_data
from neural_human_video_rendering_tpu_torch import ms_uv_ab64 as tms
from neural_human_video_rendering_tpu_torch import noisy_gt_ab as tnab
from neural_human_video_rendering_tpu_torch import noisyab_anatomy as tana
from neural_human_video_rendering_tpu_torch.utils import checkpoint as tckpt
from test_torch_port_tools import (ALL_PARTS, PSNR_TOL, SSIM_TOL, S, T,
                                   WIDTHS, load_tool, write_jax_g,
                                   write_keypoints)

IOU_TOL = 1.0 / (S * S)
SIZE_KW = dict(WIDTHS, **ALL_PARTS)
JAX_KW = dict(SIZE_KW, use_pallas_warp=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ab_dir(tmp_path_factory):
    """An A/B dir as noisy_gt_ab leaves it: the clean and noisy corpora
    and each arm's stage-2 run dir with a JAX G (epoch 1 and latest)."""
    ab = tmp_path_factory.mktemp("ab")
    kp = write_keypoints(ab / "kp")
    for arm, extra in (("clean", []), ("noisy", ["--corrupt", "0.5"])):
        make_demo_data.main(["--keypoints", kp, "--out", str(ab / arm),
                             "--size", str(S), "--tile", str(T)] + extra)
        write_jax_g(ab / f"ckpt_{arm}" / "e2e", str(ab / "clean"),
                    **ALL_PARTS)
    return ab


def _args(**kw):
    return types.SimpleNamespace(size=S, tile=T, gpu_ids="-1", how_many=2,
                                 **kw)


def test_refinement_metrics_match_jax(ab_dir):
    jtool = load_tool("tools/noisy_gt_ab.py")
    clean = str(ab_dir / "clean")
    for arm in ("clean", "noisy"):
        data, ck = str(ab_dir / arm), str(ab_dir / f"ckpt_{arm}")
        ref = jtool.refinement_metrics(_args(), data, clean, ck, JAX_KW, 2)
        got = tnab.refinement_metrics(_args(), data, clean, ck, SIZE_KW, 2)
        assert list(got) == list(ref), arm
        assert got["held_out_frames"] == ref["held_out_frames"] == 2
        assert abs(got["render_PSNR"] - ref["render_PSNR"]) <= PSNR_TOL
        assert abs(got["render_SSIM"] - ref["render_SSIM"]) <= SSIM_TOL
        for k in ("mask_IoU_refined_vs_true", "mask_IoU_supervision_vs_true"):
            assert abs(got[k] - ref[k]) <= IOU_TOL, (arm, k, got[k], ref[k])
            assert 0.0 <= got[k] <= 1.0
        for k in ("bg_PSNR_refined_vs_true", "bg_PSNR_supervision_vs_true"):
            assert abs(got[k] - ref[k]) <= PSNR_TOL, (arm, k, got[k], ref[k])
    # the corrupted supervision is worse than the clean one
    noisy = tnab.refinement_metrics(_args(), str(ab_dir / "noisy"), clean,
                                    str(ab_dir / "ckpt_noisy"), SIZE_KW, 2)
    assert noisy["mask_IoU_supervision_vs_true"] < 1.0


def test_ms_uv_score_matches_jax(ab_dir, monkeypatch):
    jtool = load_tool("tools/round5/ms_uv_ab64.py")
    monkeypatch.setattr(jtool, "SIZES", dict(SIZE_KW))
    monkeypatch.setattr(tms, "SIZES", dict(SIZE_KW))
    data, ck = str(ab_dir / "clean"), str(ab_dir / "ckpt_clean")
    ref = jtool.score(_args(), data, ck, {})
    got = tms.score(_args(), data, ck, {})
    assert list(got) == list(ref) == ["held_out_frames", "render_PSNR",
                                      "render_SSIM", "uv_L1_at_gt_part",
                                      "part_accuracy_fg"]
    assert got["held_out_frames"] == 2
    assert abs(got["render_PSNR"] - ref["render_PSNR"]) <= PSNR_TOL
    assert abs(got["render_SSIM"] - ref["render_SSIM"]) <= SSIM_TOL
    for k in ("uv_L1_at_gt_part", "part_accuracy_fg"):
        assert abs(got[k] - ref[k]) <= 1e-5, (k, got[k], ref[k])


def test_anatomy_ssim_map_and_region_psnr_match_jax():
    jtool = load_tool("tools/round4/noisyab_anatomy.py")
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (S, S, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), -1, 1).astype(np.float32)
    got, ref = tana.ssim_map(a, b), jtool.ssim_map(a, b)
    assert got.shape == ref.shape == (S - 10, S - 10)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    region = (rng.uniform(size=(S, S)) > 0.5).astype(np.float32)
    for r in (region, 1.0 - region):
        assert abs(tana.region_psnr(a, b, r) - jtool.region_psnr(a, b, r)) \
            <= 1e-4


def test_anatomy_on_an_ab_dir(ab_dir, monkeypatch, tmp_path):
    """The port's anatomy over both arms' saved epochs (epoch 1 and latest,
    JAX .msgpack files): the JAX tool's keys, finite values."""
    monkeypatch.setattr(tnab, "SIZES_SMALL", dict(SIZE_KW))
    out = tmp_path / "anatomy.json"
    assert tana.main(["--ab", str(ab_dir), "--small", "--size", str(S),
                      "--tile", str(T), "--n_eval", "2", "--gpu_ids", "-1",
                      "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert sorted(rep) == ["clean", "noisy"]
    for arm in rep.values():
        assert sorted(arm["epochs"]) == ["1", "latest"]
        for ep in arm["epochs"].values():
            assert sorted(ep) == sorted([
                "bg_PSNR_occluded", "bg_PSNR_visible", "mask_IoU_train",
                "mask_sharpness_train", "mask_IoU_holdout",
                "mask_sharpness_holdout"])
            assert all(np.isfinite(v) for v in ep.values())
        for key in ("ssim_zones_latest", "psnr_zones_latest"):
            assert sorted(arm[key]) == ["background", "edge", "interior"]


def test_corpus_counts_as_built_only_with_its_sentinel(tmp_path, monkeypatch):
    calls = []

    def fake_run(module, args, log):
        calls.append(module)
        out = args[args.index("--out") + 1]
        os.makedirs(os.path.join(out, "frames"), exist_ok=True)
        return 0.0

    monkeypatch.setattr(tnab, "run", fake_run)
    data = tmp_path / "clean"
    (data / "frames").mkdir(parents=True)        # a killed build's leftovers
    (data / "frames" / "stale.png").write_bytes(b"x")
    assert tnab.build_corpus(str(data), S, T, "kp", str(tmp_path / "log"))
    assert calls == ["make_demo_data"]
    assert (data / tnab.CORPUS_DONE).exists()
    assert not (data / "frames" / "stale.png").exists()
    assert not tnab.build_corpus(str(data), S, T, "kp", str(tmp_path / "log"))
    assert calls == ["make_demo_data"]


def test_arm_is_trained_again_until_its_saved_epoch_reaches_epochs(tmp_path):
    ck = str(tmp_path / "ckpt_clean")
    run = os.path.join(ck, "e2e")
    assert tnab.needs_training(ck, 2) and tnab.arm_epoch(ck) is None
    net = torch.nn.Linear(2, 2)
    opt = torch.optim.Adam(net.parameters())
    tckpt.save_net(run, "G", "latest", net.state_dict())
    tckpt.save_train_state(run, opt, opt, 5, "latest")   # no epoch recorded
    assert tnab.arm_epoch(ck) is None and tnab.needs_training(ck, 2)
    tckpt.save_train_state(run, opt, opt, 5, 1)          # killed after 1
    assert tnab.arm_epoch(ck) == 1 and tnab.needs_training(ck, 2)
    tckpt.save_train_state(run, opt, opt, 10, 2)
    assert tnab.arm_epoch(ck) == 2 and not tnab.needs_training(ck, 2)


def test_retraining_starts_from_scratch(tmp_path, monkeypatch):
    """train_arm clears the arm's run dirs before its two stages."""
    calls = []
    monkeypatch.setattr(tnab, "run",
                        lambda module, args, log: calls.append(module))
    ck = tmp_path / "ckpt_noisy"
    (ck / "e2e").mkdir(parents=True)
    (ck / "e2e" / "latest_net_G.pth").write_bytes(b"old")
    a = _args(pre_epochs=1, epochs=2, batch=2, seed=0)
    tnab.train_arm(a, str(tmp_path / "noisy"), str(ck), "log", SIZE_KW)
    assert calls == ["pre_train", "train"]
    assert not (ck / "e2e" / "latest_net_G.pth").exists()
