"""PyTorch port, serving driver and package rules: run_inference on the
CPU at a tiny size, the PNG writer, device selection, the host-side data
copies against the JAX package, and the rule that the port imports
nothing of JAX."""

import ast
import os
import pathlib

import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu.data import dataset as jds
from neural_human_video_rendering_tpu.data import pose_align as jpa
from neural_human_video_rendering_tpu.infer.test_driver import \
    map_driving_joints as j_map_driving_joints
from neural_human_video_rendering_tpu_torch.config import \
    TestOptions as PortTestOptions
from neural_human_video_rendering_tpu_torch.config import resolve_device
from neural_human_video_rendering_tpu_torch.data import pose_align as tpa
from neural_human_video_rendering_tpu_torch.data.dataset import (
    SyntheticDataset, canvas_geom)
from neural_human_video_rendering_tpu_torch.data.keypoints import (
    BODY25_TO_COCO18, write_keypoint_json)
from neural_human_video_rendering_tpu_torch.infer.test_driver import (
    map_driving_joints, run_inference)
from neural_human_video_rendering_tpu_torch.utils.image import (encode_png,
                                                                read_png,
                                                                to_uint8)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "neural_human_video_rendering_tpu_torch"

# the small-model flags of the verify recipe, with the flagship's encoding
TINY = ("--loadSize 64 --tex_tile 32 --ngf 8 --ngf_global 8 "
        "--n_blocks_translate 2 --n_downsample_translate 2 "
        "--n_blocks_global 2 --n_downsample_global 1 --n_blocks_bg 1 "
        "--n_downsample_bg 1 --dtype float32 --pose_heatmaps --coord_conv "
        "--gpu_ids -1").split()


def _write_sequence(d, opt, n, seed=0):
    syn = SyntheticDataset(opt, length=n, seed=seed)
    os.makedirs(d, exist_ok=True)
    for i, j in enumerate(syn.joints):
        body = np.zeros((25, 3), np.float32)
        body[BODY25_TO_COCO18] = j
        write_keypoint_json(os.path.join(d, f"frame{i:05d}_keypoints.json"),
                            body)
    return syn


def test_run_inference_writes_frames_and_gallery(tmp_path, capsys):
    kp_dir = str(tmp_path / "kp")
    opt = PortTestOptions().parse(TINY + [
        "--pose_path", kp_dir, "--results_dir", str(tmp_path / "res"),
        "--checkpoints_dir", str(tmp_path / "ckpt"), "--name", "t"],
        save=False)
    syn = _write_sequence(kp_dir, opt, 5)
    n = run_inference(opt, batch_size=2,
                      assets=(syn.texture_atlas(), syn.background()))
    assert n == 5
    assert "random-init demo render" in capsys.readouterr().out
    imgs = sorted(os.listdir(tmp_path / "res" / "images"))
    assert imgs == [f"frame{i:05d}_synthesized.png" for i in range(5)]
    frames = [read_png(str(tmp_path / "res" / "images" / f)) for f in imgs]
    assert all(f.shape == (64, 64, 3) for f in frames)
    assert len({f.tobytes() for f in frames}) == 5     # the pose moves
    html = (tmp_path / "res" / "index.html").read_text()
    assert all(f"images/{f}" in html for f in imgs)


def test_run_inference_renders_jax_checkpoint(tmp_path, capsys):
    """A run dir the JAX package's trainer wrote (random-init weights,
    saved by its checkpoint module as 10_net_G.msgpack): run_inference
    loads and renders it; the frames equal a forward of the same weights
    carried across by the bridge."""
    import jax
    from neural_human_video_rendering_tpu.config import Options as JOptions
    from neural_human_video_rendering_tpu.train.state import \
        create_train_state
    from neural_human_video_rendering_tpu.utils import checkpoint as jckpt
    from neural_human_video_rendering_tpu_torch.models.bridge import \
        params_from_jax
    from neural_human_video_rendering_tpu_torch.models.renderer import (
        init_params, renderer_from_options)
    from neural_human_video_rendering_tpu_torch.train.steps import \
        make_forward_fn
    kp_dir = str(tmp_path / "kp")
    opt = PortTestOptions().parse(TINY + [
        "--pose_path", kp_dir, "--results_dir", str(tmp_path / "res"),
        "--checkpoints_dir", str(tmp_path / "ckpt"), "--name", "t",
        "--which_epoch", "10"], save=False)
    syn = _write_sequence(kp_dir, opt, 2)
    jopt = JOptions(**{k: getattr(opt, k) for k in (
        "loadSize", "tex_tile", "ngf", "ngf_global", "n_blocks_translate",
        "n_downsample_translate", "n_blocks_global", "n_downsample_global",
        "n_blocks_bg", "n_downsample_bg", "dtype", "pose_heatmaps",
        "coord_conv")})
    g = create_train_state(jopt, jax.random.PRNGKey(1), syn.texture_atlas(),
                           syn.background(),
                           with_discriminator=False)["state"].g_params
    g = jax.tree.map(np.asarray, g)
    jckpt.save_net(opt.run_dir, "G", 10, g)
    assets = (syn.texture_atlas(), syn.background())
    assert run_inference(opt, assets=assets) == 2
    assert "loaded G epoch 10" in capsys.readouterr().out
    ref = init_params(renderer_from_options(opt), 0)
    ref.load_state_dict(params_from_jax(g))
    from neural_human_video_rendering_tpu_torch.infer.test_driver import (
        assets_to_device, load_driving_joints)
    _, joints = load_driving_joints(opt)
    fake = make_forward_fn(opt, ref.eval())(
        assets_to_device(opt, *assets, torch.device("cpu")),
        torch.from_numpy(joints))["fake"]
    for i in range(2):
        png = read_png(str(tmp_path / "res" / "images"
                           / f"frame{i:05d}_synthesized.png"))
        np.testing.assert_array_equal(png, to_uint8(
            fake[i].permute(1, 2, 0).numpy()))


def test_png_roundtrip(tmp_path):
    img = np.random.default_rng(0).uniform(-1, 1, (7, 5, 3)).astype(np.float32)
    u8 = to_uint8(img)
    data = encode_png(u8)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    (tmp_path / "p.png").write_bytes(data)
    np.testing.assert_array_equal(read_png(str(tmp_path / "p.png")), u8)


def test_resolve_device():
    assert resolve_device("-1").type == "cpu"
    assert resolve_device("").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("0")


def test_alignment_and_canvas_match_jax(tmp_path):
    opt = PortTestOptions().parse(TINY, save=False)
    _write_sequence(str(tmp_path / "src"), opt, 6, seed=1)
    syn = _write_sequence(str(tmp_path / "tgt"), opt, 6, seed=2)
    s_t, t_t = tpa.fit_scale_translation(str(tmp_path / "tgt"),
                                         str(tmp_path / "src"),
                                         target_shape=(70, 60))
    s_j, t_j = jpa.fit_scale_translation(str(tmp_path / "tgt"),
                                         str(tmp_path / "src"),
                                         target_shape=(70, 60))
    assert s_t == s_j
    np.testing.assert_array_equal(t_t, t_j)
    for lo_hi in zip(tpa.corpus_extent(str(tmp_path / "src")),
                     jpa.corpus_extent(str(tmp_path / "src"))):
        np.testing.assert_array_equal(*lo_hi)
    for mode in ("resize", "scale_width"):
        assert canvas_geom(mode, 100, 60, 64) == jds.canvas_geom(mode, 100, 60, 64)
    np.testing.assert_array_equal(
        map_driving_joints(opt, syn.joints, (120.0, 90.0)),
        j_map_driving_joints(opt, syn.joints, (120.0, 90.0)))


def test_synthetic_assets_match_jax(tiny_opt):
    import dataclasses
    from neural_human_video_rendering_tpu_torch.config import Options
    topt = Options(**dataclasses.asdict(tiny_opt))
    j, t = jds.SyntheticDataset(tiny_opt, length=4, seed=3), \
        SyntheticDataset(topt, length=4, seed=3)
    np.testing.assert_array_equal(t.joints, j.joints)
    np.testing.assert_array_equal(t.texture_atlas(), j.texture_atlas())
    np.testing.assert_array_equal(t.background(), j.background())


_FORBIDDEN = ("jax", "flax", "optax", "msgpack",
              "neural_human_video_rendering_tpu", "tools")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [REPO / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in _FORBIDDEN, f"{path} imports {mod}"
