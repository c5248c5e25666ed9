"""PyTorch port, quality evaluation against the JAX package on the CPU:
frame pairing, the VGG distance and LPIPS (the same VGG weights carried
across by the bridge), the packed-tap normalisation, the LPIPS head
loaders, evaluate_dirs with LPIPS and flicker, and the CLI's JSON keys.

Tolerances: both packages run the VGG in bfloat16, whose rounding differs
between the two frameworks' convolutions, so the VGG distance and LPIPS
agree within 3e-2 relative; the tap normalisation is float32 arithmetic
on the same array (1e-6); PSNR within 1e-4 dB and SSIM within 1e-5
(float32 on the same decoded frames). The flicker metrics are within 1e-6
relative of their float64 value computed here with numpy, and within 1e-5
of the JAX package's: its float32 mean over a frame's 3072 values is
itself 1.3e-6 off the float64 value on these frames.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu.infer import evaluate as jev
from neural_human_video_rendering_tpu.models import vgg as jvgg
from neural_human_video_rendering_tpu.utils import lpips as jl
from neural_human_video_rendering_tpu.utils import metrics as jm
from neural_human_video_rendering_tpu_torch.data.dataset import load_image
from neural_human_video_rendering_tpu_torch.infer import evaluate as tev
from neural_human_video_rendering_tpu_torch.models import vgg as tvgg
from neural_human_video_rendering_tpu_torch.models.bridge import \
    params_from_jax
from neural_human_video_rendering_tpu_torch.models.renderer import init_params
from neural_human_video_rendering_tpu_torch.utils import lpips as tl
from neural_human_video_rendering_tpu_torch.utils import metrics as tm
from neural_human_video_rendering_tpu_torch.utils.image import save_image

BF16_VGG_RTOL = 3e-2
NORM_TOL = 1e-6
PSNR_ATOL, SSIM_ATOL = 1e-4, 1e-5
FLICKER_RTOL, FLICKER_JAX_RTOL = 1e-6, 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vgg_pair():
    """The JAX package's random-feature VGG params and the port's VGG
    (bfloat16) holding the same weights."""
    params = jvgg.init_vgg_params(jax.random.PRNGKey(0), 32)
    with torch.device("meta"):
        vgg = tvgg.VGG19Features(dtype=torch.bfloat16)
    vgg = init_params(vgg, 0)
    vgg.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, vgg.requires_grad_(False)


def _images(seed, n=2, S=32):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32) / S
    base = np.stack([np.sin(7 * xx), np.cos(5 * yy),
                     np.sin(4 * (xx + yy))], -1) * 0.6
    return np.clip(base + rng.uniform(-0.3, 0.3, (n, S, S, 3)), -1,
                   1).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _touch(d, names):
    os.makedirs(d, exist_ok=True)
    for n in names:
        save_image(os.path.join(d, n), np.zeros((4, 4, 3), np.float32))


@pytest.mark.parametrize("names_a,names_b", [
    # not zero-padded, .png renders against .jpg frames, one unmatched
    ([f"frame{i}_synthesized.png" for i in (2, 10, 1, 11, 3)],
     [f"frame{i}.jpg" for i in (1, 2, 3, 10, 11, 12)]),
    # no digits on one side: sorted order
    (["a.png", "b.png", "c.png"], [f"f{i:03d}.jpg" for i in range(4)]),
])
def test_pair_frames_matches_jax(tmp_path, names_a, names_b):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _touch(a, names_a)
    _touch(b, names_b)
    got = tev.pair_frames(a, b)
    assert got == jev.pair_frames(a, b)
    if names_a[0].startswith("frame"):
        assert [p[1] for p in got] == [f"frame{i}.jpg"
                                       for i in (1, 2, 3, 10, 11)]


def test_vgg_distance_matches_jax(vgg_pair):
    params, vgg = vgg_pair
    a, b = _images(0), _images(1)
    want = np.asarray(jm.vgg_distance(params, jnp.asarray(a), jnp.asarray(b),
                                      per_sample=True))
    with torch.no_grad():
        got = tm.vgg_distance(vgg, _nchw(a), _nchw(b)).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=BF16_VGG_RTOL)


def test_lpips_distance_matches_jax(vgg_pair):
    params, vgg = vgg_pair
    a, b = _images(2), _images(3)
    lins = tl.uniform_lin_weights()
    lins[2] = lins[2] * 50.0                 # a head that is not uniform
    want = np.asarray(jl.lpips_distance(params, jnp.asarray(a),
                                        jnp.asarray(b), lins,
                                        per_sample=True))
    with torch.no_grad():
        got = tl.lpips_distance(vgg, _nchw(a), _nchw(b), lins,
                                per_sample=True).numpy()
        mean = float(tl.lpips_distance(vgg, _nchw(a), _nchw(b), lins))
        same = tl.lpips_distance(vgg, _nchw(a), _nchw(a), per_sample=True)
    np.testing.assert_allclose(got, want, rtol=BF16_VGG_RTOL)
    assert mean == pytest.approx(float(got.mean()), rel=1e-6)
    assert float(same.abs().max()) == 0.0


@pytest.mark.parametrize("width,channels", [(64, 256), (128, 128)])
def test_tap_normalisation_matches_jax(width, channels):
    """Tap 0 is space-to-depth packed in NCHW (4 groups of 64 channels):
    each original pixel is normalised over its own 64 channels, as JAX's
    _normalize_tap does on NHWC; an unpacked tap over all its channels."""
    x = np.random.default_rng(5).normal(size=(2, 4, 6, channels)).astype(
        np.float32)
    want = np.asarray(jl._normalize_tap(jnp.asarray(x), width))
    got = tl.normalize_tap(_nchw(x), width)
    if channels != width:               # (B, g, C, H, W) -> (B, H, W, g, C)
        got = got.permute(0, 3, 4, 1, 2)
    else:
        got = got.permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=NORM_TOL)
    # normalising over all 256 channels of the packed tap is another thing
    if channels != width:
        wrong = _nchw(x) / _nchw(x).norm(dim=1, keepdim=True)
        assert float((wrong.view(2, 4, 64, 4, 6).permute(0, 3, 4, 1, 2)
                      - got).abs().max()) > 0.1


def _lin_file(tmp_path, fmt, widths=tl.TAP_WIDTHS):
    rng = np.random.default_rng(1)
    ws = [rng.normal(0.1, 0.05, (c,)).astype(np.float32) for c in widths]
    ws[0][0] = -0.3                          # clamped to 0 when loaded
    if fmt == "pth":
        p = str(tmp_path / "lpips_vgg.pth")
        torch.save({f"lin{i}.model.1.weight": torch.from_numpy(
            w.reshape(1, -1, 1, 1)) for i, w in enumerate(ws)}, p)
    else:
        p = str(tmp_path / "lins.npz")
        np.savez(p, **{f"lin{i}": w for i, w in enumerate(ws)})
    return p


@pytest.mark.parametrize("fmt", ["pth", "npz"])
def test_load_lin_weights_matches_jax(tmp_path, monkeypatch, fmt):
    p = _lin_file(tmp_path, fmt)
    got = tl.load_lin_weights(p)
    want = jl.load_lin_weights(p)
    assert [w.shape for w in got] == [(c,) for c in tl.TAP_WIDTHS]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0][0] == 0.0 and all((w >= 0).all() for w in got)
    monkeypatch.setenv("LPIPS_WEIGHTS", p)
    np.testing.assert_array_equal(tl.get_lin_weights()[3], got[3])
    monkeypatch.delenv("LPIPS_WEIGHTS")
    assert tl.get_lin_weights()[0][0] == pytest.approx(1 / 64)


def test_load_lin_weights_refuses_a_wrong_width(tmp_path):
    widths = list(tl.TAP_WIDTHS)
    widths[2] = 7
    with pytest.raises(ValueError, match="lin2"):
        tl.load_lin_weights(_lin_file(tmp_path, "npz", widths))


def _frame_dirs(tmp_path, n=10, S=32):
    """Renders and ground truth of n frames: a moving pattern, the renders
    a noisy copy."""
    rng = np.random.default_rng(7)
    res, gt = str(tmp_path / "res"), str(tmp_path / "gt")
    os.makedirs(res)
    os.makedirs(gt)
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32) / S
    for i in range(n):
        img = np.stack([np.sin(7 * xx + 0.4 * i), np.cos(5 * yy - 0.3 * i),
                        np.sin(4 * (xx + yy))], -1) * 0.7
        save_image(os.path.join(gt, f"frame{i:05d}.png"), img)
        save_image(os.path.join(res, f"frame{i:05d}_synthesized.png"),
                   np.clip(img + rng.normal(0, 0.1, img.shape), -1, 1))
    return res, gt


def test_evaluate_dirs_matches_jax(tmp_path, monkeypatch, vgg_pair):
    """10 frames at batch 4: the last batch is padded, and the padded
    entries are dropped before averaging."""
    params, vgg = vgg_pair
    res, gt = _frame_dirs(tmp_path)
    monkeypatch.setattr(jvgg, "get_vgg_params", lambda *a: params)
    monkeypatch.setattr(tev, "build_vgg", lambda **kw: vgg)
    kw = dict(size=32, batch_size=4, use_vgg=True, use_lpips=True,
              use_temporal=True)
    want = jev.evaluate_dirs(res, gt, **kw)
    got = tev.evaluate_dirs(res, gt, device=CPU, **kw)
    assert set(got) == set(want)
    assert got["frames"] == want["frames"] == 10
    assert got["psnr"] == pytest.approx(want["psnr"], abs=PSNR_ATOL)
    assert got["ssim"] == pytest.approx(want["ssim"], abs=SSIM_ATOL)
    exact = {}
    for k, d, col in (("temporal_l1", res, 0), ("temporal_l1_gt", gt, 1)):
        frames = [load_image(os.path.join(d, p[col]), 32).astype(np.float64)
                  for p in tev.pair_frames(res, gt)]
        exact[k] = np.mean([np.abs(y - x).mean()
                            for x, y in zip(frames, frames[1:])])
    exact["flicker_ratio"] = exact["temporal_l1"] / exact["temporal_l1_gt"]
    for k, v in exact.items():
        assert got[k] == pytest.approx(v, rel=FLICKER_RTOL), k
        assert got[k] == pytest.approx(want[k], rel=FLICKER_JAX_RTOL), k
    for k in ("vgg_dist", "lpips"):
        assert got[k] == pytest.approx(want[k], rel=BF16_VGG_RTOL), k
    # the padded tail is dropped: the mean of the 10 frames one at a time
    one = tev.evaluate_dirs(res, gt, size=32, batch_size=1, use_vgg=False,
                            device=CPU)
    assert one["psnr"] == pytest.approx(got["psnr"], abs=1e-5)


def test_cli_prints_jax_keys(tmp_path, capsys):
    res, gt = _frame_dirs(tmp_path, n=5)
    argv = ["--results_dir", res, "--gt_dir", gt, "--loadSize", "32",
            "--batch_size", "2", "--no_vgg", "--metric", "temporal"]
    jev.main(argv + ["--out", str(tmp_path / "j.json")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = str(tmp_path / "t.json")
    tev.main(argv + ["--out", out, "--gpu_ids", "-1"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want)
    assert got == json.loads(open(out).read())
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=2e-5), k
    with pytest.raises(SystemExit):
        tev.main(argv + ["--metric", "fid"])
