"""PyTorch port, the reference launchers' flags: the texture atlas unfold
and the pose retargeting tool against the JAX package's on a corpus the
test writes; the pose input with LaplaceProj channels, pose images and limb
coordinates; the texture pretrain step under --input_nc 81; inference
driven by pose images with LaplaceProj frames, cluster codes and a video
against the JAX driver; the profiler window and --debug_nans; the partial
TransG restore the launchers need; and every script under launchers/ run
through the port on the CPU at a tiny size (chip_smoke.py phase 8 runs
them at their own widths on the card).

The corpus comes from chip_smoke.write_launcher_corpus (the port's
SyntheticDataset in the reference layout). Tolerances: the atlas bytes
exact; the aligned keypoints and the fit 1e-6 (JSON numbers); the pose
input 1e-5 absolute; the pretrain step's loss 1e-5 relative and parameter
changes per tensor 1e-5 * max|change| over the net + 1e-4 * max|change|
of the tensor (float32 sums in another order); frame and video counts
exact.
"""

import importlib.util
import json
import os
import pathlib
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from neural_human_video_rendering_tpu.config import Options as JOptions
from neural_human_video_rendering_tpu.config import \
    TestOptions as JTestOptions
from neural_human_video_rendering_tpu.data import pose_align as jpa
from neural_human_video_rendering_tpu.data import rasterize as jr
from neural_human_video_rendering_tpu.data import \
    texture_unfold as j_unfold
from neural_human_video_rendering_tpu.models import generators as jg
from neural_human_video_rendering_tpu.train import steps as jsteps
from neural_human_video_rendering_tpu_torch import encode_features
from neural_human_video_rendering_tpu_torch import graph_posenorm
from neural_human_video_rendering_tpu_torch import unfold_texture
from neural_human_video_rendering_tpu_torch.config import Options as TOptions
from neural_human_video_rendering_tpu_torch.config import \
    TestOptions as TTestOptions
from neural_human_video_rendering_tpu_torch.config import TrainOptions
from neural_human_video_rendering_tpu_torch.data import dataset as tds
from neural_human_video_rendering_tpu_torch.data import keypoints as tkp
from neural_human_video_rendering_tpu_torch.data import rasterize as trz
from neural_human_video_rendering_tpu_torch.data.texture_unfold import \
    unfold_texture as t_unfold
from neural_human_video_rendering_tpu_torch.data.wire import (pack_batch,
                                                              unpack_batch)
from neural_human_video_rendering_tpu_torch.infer import test_driver as td
from neural_human_video_rendering_tpu_torch.launch import (ENTRY_POINTS,
                                                           launcher_argv,
                                                           run_launcher)
from neural_human_video_rendering_tpu_torch.models import generators as tg
from neural_human_video_rendering_tpu_torch.models.bridge import params_from_jax
from neural_human_video_rendering_tpu_torch.models.renderer import (
    init_params, renderer_from_options)
from neural_human_video_rendering_tpu_torch.train import drivers, loop
from neural_human_video_rendering_tpu_torch.train.state import PretrainState
from neural_human_video_rendering_tpu_torch.train.steps import (
    build_pose_input, make_pretrain_tex_step)
from neural_human_video_rendering_tpu_torch.utils import checkpoint as ckpt

REPO = pathlib.Path(__file__).resolve().parents[1]
LAUNCHERS = REPO / "launchers"
ATOL = 1e-5
LOSS_RTOL = 1e-5
# the tiny widths appended after a launcher's own flags (a later flag wins)
TINY = ("--loadSize 32 --tex_tile 16 --ngf 4 --ngf_global 4 "
        "--n_downsample_translate 2 --n_blocks_global 1 "
        "--n_downsample_global 1 --n_blocks_bg 1 --n_downsample_bg 1 "
        "--nef 4 --n_downsample_E 2 --ndf 4 --n_layers_D 2 --dtype float32 "
        "--no_vgg_loss --no_flip --gpu_ids -1 --print_freq 1").split()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's CPU thread pool slows many-fold when they share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """6 frames at 32 px in the launchers' layout (atlases at tile 16)."""
    root = str(tmp_path_factory.mktemp("launchers") / "data")
    return chip_smoke.write_launcher_corpus(root, 6, 32, tile=16)[0]


def _load_root_script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("script,entry,args", [
    ("run_align_pose.sh", "graph_posenorm", []),
    ("pretrain_trans.sh", "pre_train", []),
    ("pretrain_tex.sh", "pre_train_tex", ["/seq"]),
    ("train_e2e.sh", "train.__main__", ["d"]),
    ("test_infer.sh", "infer.test_driver", ["d"])])
def test_every_launcher_maps_to_a_port_entry_point(script, entry, args):
    env = {"TGT": "/t", "SRC": "/s", "OUT": "/o", "ROOT": "/r"}
    got, argv = launcher_argv(str(LAUNCHERS / script), args, env)
    assert got == entry and entry in ENTRY_POINTS.values()
    mod = importlib.import_module(
        f"neural_human_video_rendering_tpu_torch.{entry}")
    assert callable(mod.main)
    text = (LAUNCHERS / script).read_text()
    for flag in (a for a in argv if a.startswith("--")):
        assert flag in text, flag
    if script == "train_e2e.sh":
        assert argv[argv.index("--img_path") + 1] == "/r/d/d"
        assert argv[argv.index("--checkpoints_dir") + 1] == "./checkpoints"
        with pytest.raises(ValueError, match="usage"):
            launcher_argv(str(LAUNCHERS / script), [], env)


@pytest.mark.parametrize("size", [None, 24])
def test_texture_unfold_matches_jax(corpus, tmp_path, size):
    """The atlas the port writes is the JAX package's, byte for byte."""
    frames, dp = corpus[chip_smoke.DANCE], corpus["densepose"]
    ref = j_unfold.unfold_texture(frames, dp, str(tmp_path / "j.jpg"),
                                  tile=16, size=size)
    if size is None:          # through the entry point
        assert unfold_texture.main([frames, dp, "--out",
                                    str(tmp_path / "t.jpg"), "--tile",
                                    "16"]) == 0
    else:
        t_unfold(frames, dp, str(tmp_path / "t.jpg"), tile=16, size=size)
    assert (tmp_path / "t.jpg").read_bytes() == pathlib.Path(ref).read_bytes()
    atlas = tds.load_texture_atlas(str(tmp_path / "t.jpg"), 16)
    assert atlas.shape == (24, 16, 16, 3) and atlas.std() > 0.05


def test_graph_posenorm_matches_jax(corpus, tmp_path, monkeypatch, capsys):
    """run_align_pose.sh's argv with --source_frames, through the port's
    graph_posenorm and the JAX package's graph_posenorm.py: the aligned
    keypoint JSONs, the fit in align_meta.json and the overlays."""
    env = {"TGT": corpus["align_target"], "SRC": corpus["align_source"]}
    frames = ["--source_frames", corpus[chip_smoke.DANCE]]
    _, argv_t = launcher_argv(str(LAUNCHERS / "run_align_pose.sh"), [],
                              dict(env, OUT=str(tmp_path / "t")))
    _, argv_j = launcher_argv(str(LAUNCHERS / "run_align_pose.sh"), [],
                              dict(env, OUT=str(tmp_path / "j")))
    assert graph_posenorm.main(argv_t + frames) == 0
    tool = _load_root_script("graph_posenorm")
    monkeypatch.setattr(sys, "argv", ["graph_posenorm.py"] + argv_j + frames)
    tool.main()
    out = capsys.readouterr().out
    assert out.count("scale:") == 2 and len(set(
        ln for ln in out.splitlines() if ln.startswith("scale:"))) == 1
    names = tkp.keypoint_jsons(str(tmp_path / "t"))
    assert len(names) == 6
    for n in names:
        a = tkp.parse_keypoint_json(str(tmp_path / "t" / n))
        b = tkp.parse_keypoint_json(str(tmp_path / "j" / n))
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-6)
    with open(tmp_path / "t" / "align_meta.json") as f:
        mt = json.load(f)
    with open(tmp_path / "j" / "align_meta.json") as f:
        mj = json.load(f)
    assert mt["target_shape"] == mj["target_shape"] == [1024, 1024]
    np.testing.assert_allclose([mt["scale"]] + mt["translation"],
                               [mj["scale"]] + mj["translation"], atol=1e-6)
    # overlays: the JAX function on the aligned JSONs without the sidecar
    # (graph_posenorm.py writes the sidecar first, and JAX then pairs it
    # with frame 0)
    clean = tmp_path / "j_clean"
    shutil.copytree(tmp_path / "j", clean)
    os.remove(clean / "align_meta.json")
    shutil.rmtree(clean / "overlay")
    assert jpa.write_debug_overlays(corpus[chip_smoke.DANCE], str(clean),
                                    (1024, 1024)) == 6
    for f in sorted(os.listdir(clean / "overlay")):
        assert (tmp_path / "t" / "overlay" / f).read_bytes() == \
            (clean / "overlay" / f).read_bytes(), f


def test_pose_dirs_skip_the_align_meta_sidecar(tmp_path):
    syn = tds.SyntheticDataset(TOptions(loadSize=32), length=3)
    for i, j in enumerate(syn.joints):
        body = np.zeros((25, 3), np.float32)
        body[tkp.BODY25_TO_COCO18] = j
        tkp.write_keypoint_json(str(tmp_path / f"f{i}_keypoints.json"), body)
    (tmp_path / "align_meta.json").write_text('{"scale": 1.0}')
    names, joints = tkp.load_pose_dir(str(tmp_path))
    assert names == [f"f{i}_keypoints.json" for i in range(3)]
    np.testing.assert_allclose(joints, syn.joints, atol=1e-5)
    ds = tds.FrameDataset(TOptions(loadSize=32, pose_path=str(tmp_path)))
    assert len(ds) == 3


def _pose_flags(**over):
    base = dict(loadSize=32, pose_heatmaps=True, coord_conv=True)
    base.update(over)
    return base


@pytest.mark.parametrize("case", [
    "train_e2e", "pose_plus_laplace", "input_nc_81", "laplace_zeros",
    "limb_coords"])
def test_build_pose_input_matches_jax(case):
    """The pose input of each launcher's configuration: train_e2e.sh
    (--use_laplace, --input_nc 3: LaplaceProj only, no render),
    test_infer.sh (--pose_plus_laplace), pretrain_tex.sh (--input_nc 81:
    a pose image and 78 LaplaceProj channels), LaplaceProj absent (zeros),
    and --limb_coords."""
    over = {"train_e2e": dict(use_laplace=True),
            "pose_plus_laplace": dict(use_laplace=True,
                                      pose_plus_laplace=True),
            "input_nc_81": dict(use_laplace=True, input_nc=81,
                                pose_heatmaps=False, coord_conv=False),
            "laplace_zeros": dict(use_laplace=True, pose_plus_laplace=True),
            "limb_coords": dict(limb_coords=True)}[case]
    jopt, topt = JOptions(**_pose_flags(**over)), TOptions(**_pose_flags(**over))
    syn = tds.SyntheticDataset(topt, length=2)
    joints = syn.joints
    rng = np.random.default_rng(0)
    lap = pimg = None
    if topt.use_laplace and case != "laplace_zeros":
        lap = rng.uniform(-1, 1, (2, 32, 32, topt.laplace_nc_eff)).astype(
            np.float32)
    if case == "input_nc_81":
        pimg = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jsteps.build_pose_input(
        jopt, jnp.asarray(joints), None if lap is None else jnp.asarray(lap),
        None if pimg is None else jnp.asarray(pimg)))

    def nchw(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a.transpose(0, 3, 1, 2)))

    got = build_pose_input(topt, torch.from_numpy(joints), nchw(lap),
                           nchw(pimg)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == ref.shape == (2, 32, 32, topt.pose_nc)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    if case == "input_nc_81":
        assert topt.pose_nc == 81
        np.testing.assert_array_equal(got[..., :3], pimg)
        np.testing.assert_array_equal(got[..., 3:], lap)
    with pytest.raises(ValueError, match="channels"):
        build_pose_input(topt, torch.from_numpy(joints),
                         torch.zeros(2, topt.laplace_nc_eff + 1, 32, 32)
                         if topt.use_laplace else None,
                         torch.zeros(2, 4, 32, 32)
                         if topt.use_pose_render else None)


def test_limb_coord_maps_match_jax():
    j = tds.SyntheticDataset(TOptions(loadSize=40), length=2).joints
    j[0, 3, 2] = 0.0              # an undetected joint gates its limbs
    ref = np.asarray(jax.vmap(lambda x: jr.limb_coord_maps(
        x, 40, 36, sigma=7.0))(jnp.asarray(j)))
    got = trz.limb_coord_maps(torch.from_numpy(j), 40, 36, sigma=7.0)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), ref,
                               atol=ATOL)
    assert float(got[0, 4:6].abs().max()) == 0.0      # limb (3, 4) gated


def test_input_nc_81_channels_reach_the_pose_input(corpus):
    """pretrain_tex.sh's contract: the 78-channel .npy LaplaceProj and the
    pose image go through FrameDataset, the wire format and
    build_pose_input unchanged (float16 files, at the loadSize)."""
    opt = TrainOptions().parse(TINY + [
        "--use_laplace", "--input_nc", "81", "--pose_path",
        corpus["openpose_img"], "--lapalce_path", corpus["LaplaceProj78"]],
        save=False)
    ds = tds.FrameDataset(opt)
    b = unpack_batch(pack_batch(tds.collate([ds[0], ds[1]])),
                     torch.device("cpu"))
    pose = build_pose_input(opt, b["joints"], b["laplace"], b["pose_img"])
    assert pose.shape == (2, 81, 32, 32)
    for k in range(2):
        npy = np.load(os.path.join(corpus["LaplaceProj78"],
                                   f"frame{k:05d}.npy"))
        np.testing.assert_array_equal(
            pose[k, 3:].numpy().transpose(1, 2, 0), npy.astype(np.float32))
    np.testing.assert_array_equal(pose[:, :3], b["pose_img"])


def test_pretrain_tex_step_input_nc_81_matches_jax():
    """One texture pretrain step under pretrain_tex.sh's --use_laplace
    --input_nc 81 with pose images (and --use_mask_texture), against the
    JAX package's jitted step: SGD lr 1 on both sides."""
    flags = dict(loadSize=32, tex_tile=16, batchSize=2, n_blocks_global=1,
                 n_downsample_global=1, ngf_global=4, dtype="float32",
                 no_flip=True, stem_s2d=2, head_s2d=2, pad_mode="same",
                 use_laplace=True, input_nc=81, use_mask_texture=True,
                 instance_feat=True)
    jopt, topt = JOptions(**flags), TOptions(**flags)
    rng = np.random.default_rng(3)
    syn = tds.SyntheticDataset(topt, length=2)
    static = np.clip(syn.texture_atlas() * 0.5, -1, 1)
    static[5] = -1.0
    mask = (np.abs(static + 1.0).sum(-1, keepdims=True) > 0.05).astype(
        np.float32)
    batch = {"joints": syn.joints,
             "pose_img": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
             "laplace": rng.uniform(-1, 1, (2, 32, 32, 78)).astype(np.float32),
             "part_texture": np.stack([np.clip(static + 0.1 * i, -1, 1)
                                       for i in range(2)]),
             "pose_texture": rng.uniform(-1, 1, (2,) + static.shape).astype(
                 np.float32)}
    jt = jg.TexG(24, 16, 4, 1, 1, stem_s2d=2, head_s2d=2, pad_mode="same",
                 dtype=jnp.float32)
    params = jax.tree.map(np.array, jax.jit(jt.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 81)))["params"])
    with torch.device("meta"):
        tt = tg.TexG(topt.pose_nc, 24, 16, 4, 1, 1, stem_s2d=2, head_s2d=2,
                     pad_mode="same")
    tt.to_empty(device="cpu").load_state_dict(params_from_jax(params))
    before = {k: v.clone() for k, v in tt.state_dict().items()}
    sgd = optax.sgd(1.0)
    jp = jax.tree.map(jnp.asarray, params)
    jstep = jsteps.make_pretrain_tex_step(jopt, jt, sgd, static,
                                          jnp.asarray(mask))
    j_new, _, jm = jstep(jp, sgd.init(jp),
                         {k: jnp.asarray(v) for k, v in batch.items()})

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))

    st = PretrainState(step=0, net=tt, device=torch.device("cpu"),
                       optimizer=torch.optim.SGD(tt.parameters(), lr=1.0))
    tm = make_pretrain_tex_step(topt, tt, st.optimizer, nchw(static),
                                nchw(mask))(st, batch)
    np.testing.assert_allclose(float(tm["Tex_L1"]), float(jm["Tex_L1"]),
                               rtol=LOSS_RTOL)
    ref = params_from_jax(jax.tree.map(np.array, j_new))
    dj = {k: ref[k] - before[k] for k in ref}
    scale = max(float(d.abs().max()) for d in dj.values())
    for k, d in dj.items():
        err = float(((tt.state_dict()[k] - before[k]) - d).abs().max())
        assert err <= 1e-5 * scale + 1e-4 * float(d.abs().max()), k


def _video_frames(path):
    import cv2
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def test_run_inference_pose_images_laplace_codes_video_vs_jax(
        corpus, tmp_path, capsys):
    """Pose-image driving with LaplaceProj frames, --load_features /
    --cluster_idx codes and --save_video, through the port's and the JAX
    package's run_inference: the same frames and the same video length."""
    centers = np.random.default_rng(0).uniform(-1, 1, (3, 25, 3)).astype(
        np.float32)
    np.savez(tmp_path / "feat.npz", centers=centers)
    args = TINY + [
        "--n_blocks_translate", "1", "--pose_path", corpus["openpose_img"],
        "--pose_tgt_path", corpus["openpose_json"], "--use_laplace",
        "--pose_plus_laplace", "--lapalce_path", corpus["LaplaceProj"],
        "--instance_feat", "--load_features", str(tmp_path / "feat.npz"),
        "--cluster_idx", "2", "--save_video", "--checkpoints_dir",
        str(tmp_path / "none"), "--infer_batch", "4"]
    n_t = td.run_inference(TTestOptions().parse(
        args + ["--results_dir", str(tmp_path / "t")], save=False))
    out = capsys.readouterr().out
    assert "pose-image driving cannot be retargeted" in out
    assert "cluster 2 codes" in out
    assert f"6-frame video -> {tmp_path / 't' / 'video.'}" in out
    from neural_human_video_rendering_tpu.infer.test_driver import \
        run_inference as j_run_inference
    jopt = JTestOptions().parse(args + ["--results_dir", str(tmp_path / "j")],
                                save=False)
    n_j = j_run_inference(jopt)
    assert n_t == n_j == 6
    tf = sorted(os.listdir(tmp_path / "t" / "images"))
    jf = sorted(os.listdir(tmp_path / "j" / "images"))
    assert [os.path.splitext(f)[0] for f in tf] == \
        [os.path.splitext(f)[0] for f in jf]
    vt = [f for f in os.listdir(tmp_path / "t") if f.startswith("video.")]
    vj = [f for f in os.listdir(tmp_path / "j") if f.startswith("video.")]
    assert len(vt) == len(vj) == 1
    assert _video_frames(str(tmp_path / "t" / vt[0])) == \
        _video_frames(str(tmp_path / "j" / vj[0])) == 6
    for bad, err in (([str(tmp_path / "missing.npz"), "0"], FileNotFoundError),
                     ([str(tmp_path / "feat.npz"), "3"], ValueError)):
        opt = TTestOptions().parse(args + [
            "--results_dir", str(tmp_path / "x"), "--load_features", bad[0],
            "--cluster_idx", bad[1]], save=False)
        with pytest.raises(err):
            td.run_inference(opt)


def test_save_video_is_refused_without_cv2(tmp_path, monkeypatch):
    opt = TTestOptions().parse(TINY + [
        "--pose_path", str(tmp_path), "--save_video", "--results_dir",
        str(tmp_path / "r")], save=False)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="--save_video"):
        td.run_inference(opt)
    assert not (tmp_path / "r").exists()


def _tiny_train_opt(tmp_path, *extra):
    return TrainOptions().parse(TINY + [
        "--batchSize", "2", "--no_flip", "--n_blocks_translate", "1",
        "--checkpoints_dir", str(tmp_path), "--name", "t",
        "--lambda_L2", "500", "--lambda_Temp", "500"] + list(extra))


def test_profile_window_writes_a_trace(tmp_path, capsys):
    """--profile_dir: a torch.profiler trace of this run's steps
    [profile_start, profile_start + profile_steps), as the JAX loop's
    window; the other steps run unprofiled."""
    prof = tmp_path / "prof"
    st = drivers.run_train(_tiny_train_opt(
        tmp_path, "--profile_dir", str(prof), "--profile_start", "1",
        "--profile_steps", "2"), max_steps=4)
    assert st.step == 4
    assert sorted(os.listdir(prof)) == ["steps_1-2.trace.json"]
    with open(prof / "steps_1-2.trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
    assert "[profile] trace of steps 1-2 written" in capsys.readouterr().out


def test_debug_nans_names_the_loss(tmp_path):
    """--debug_nans: the loop checks each step's losses and raises
    FloatingPointError naming the non-finite ones; without the flag the
    same step runs on."""
    opt = _tiny_train_opt(tmp_path, "--debug_nans")
    st = drivers.run_train(opt, max_steps=0)
    ds = tds.SyntheticDataset(opt, length=4)
    batch = tds.collate([ds[0], ds[1]])
    batch["image"][0, 3, 3, 0] = np.nan
    step = drivers.make_train_step(opt, st.renderer, st.disc, None,
                                   st.g_opt, st.d_opt)
    with pytest.raises(FloatingPointError, match="G_L2"):
        loop.run_training(opt, iter([batch]), step, st, 1)
    opt.debug_nans = False
    st = loop.run_training(opt, iter([batch]), step, st, 1)
    assert not np.isfinite(float(st.metrics["G_L2"]))


def test_transg_of_another_depth_loads_partially(tmp_path, capsys):
    """--load_pretrain_TransG from a stage 1 of fewer residual blocks (the
    reference's pretrain_trans.sh trains 5, train_e2e.sh builds 9): the
    blocks both have and every other tensor load, the extra block keeps
    its fresh init, and the run says which; a matching file loads
    strictly."""
    tiny = dict(ngf=4, tex_tile=16, n_downsample_translate=2, ngf_global=4,
                n_blocks_global=1, n_downsample_global=1, n_blocks_bg=1,
                n_downsample_bg=1)
    opt = TOptions(**_pose_flags(n_blocks_translate=2, **tiny))
    small = init_params(renderer_from_options(
        TOptions(**_pose_flags(n_blocks_translate=1, **tiny))), 1)
    ckpt.save_net(str(tmp_path), "TransG", 2, small.TransG.state_dict())
    r = init_params(renderer_from_options(opt), 0)
    fresh = {k: v.clone() for k, v in r.TransG.state_dict().items()}
    ckpt.load_transg_into(r, str(tmp_path), 2)
    out = capsys.readouterr().out
    assert "another number of residual blocks" in out
    assert "GlobalGenerator_0.ResnetBlock_1" in out
    for k, v in r.TransG.state_dict().items():
        want = small.TransG.state_dict().get(k, fresh[k])
        assert torch.equal(v, want), k
    same = init_params(renderer_from_options(opt), 3)
    ckpt.save_net(str(tmp_path), "TransG", 3, same.TransG.state_dict())
    ckpt.load_transg_into(r, str(tmp_path), 3)
    assert "residual blocks" not in capsys.readouterr().out
    for k, v in r.TransG.state_dict().items():
        assert torch.equal(v, same.TransG.state_dict()[k]), k


@pytest.mark.parametrize("other", [
    dict(ngf=8), dict(n_downsample_translate=1), dict(pose_heatmaps=False)])
def test_transg_of_another_structure_is_refused(tmp_path, other):
    """Only the number of residual blocks may differ: a stage-1 TransG of
    another width, downsampling or pose input is refused with a
    RuntimeError before anything loads, with or without a depth
    difference too."""
    tiny = dict(ngf=4, tex_tile=16, n_downsample_translate=2, ngf_global=4,
                n_blocks_global=1, n_downsample_global=1, n_blocks_bg=1,
                n_downsample_bg=1)
    r = init_params(renderer_from_options(
        TOptions(**_pose_flags(n_blocks_translate=2, **tiny))), 0)
    before = {k: v.clone() for k, v in r.TransG.state_dict().items()}
    for epoch, blocks in ((2, 2), (1, 1)):
        bad = init_params(renderer_from_options(TOptions(**_pose_flags(
            n_blocks_translate=blocks, **{**tiny, **other}))), 1)
        ckpt.save_net(str(tmp_path), "TransG", epoch, bad.TransG.state_dict())
        with pytest.raises(RuntimeError):
            ckpt.load_transg_into(r, str(tmp_path), epoch)
        for k, v in r.TransG.state_dict().items():
            assert torch.equal(v, before[k]), k


def test_reference_launchers_on_the_cpu(corpus, tmp_path, capsys):
    """Every script under launchers/ through the port's entry points, its
    argv read from the script with only paths and epoch caps edited and
    the tiny widths appended: pose retargeting, stage 1 (2 epochs: stage 2
    loads its epoch 2), the texture pretrain (pose images + 78 LaplaceProj
    channels), stage 2 (LaplaceProj, E, the partial TransG handoff), the
    encoder's cluster codes, then serving twice: stage 2's model with the
    codes and a video, and test_infer.sh's own flags on the aligned poses
    from a random init (its --pose_plus_laplace model is not stage 2's)."""
    ck, L = str(tmp_path / "ckpt"), LAUNCHERS
    env = {"TGT": corpus["align_target"], "SRC": corpus["align_source"],
           "OUT": str(tmp_path / "aligned"), "DATA": corpus["all"],
           "CKPTS": ck, "ROOT": corpus["root"]}
    d = chip_smoke.DANCE
    assert run_launcher(str(L / "run_align_pose.sh"), env=env) == 0
    assert run_launcher(str(L / "pretrain_trans.sh"), env=env, extra=TINY + [
        "--n_blocks_translate", "1", "--niter", "2"]) == 0
    assert os.path.isfile(f"{ck}/uvGenerator_pretrain/2_net_TransG.pth")
    assert run_launcher(str(L / "pretrain_tex.sh"), [corpus["seq"]], env=env,
                        extra=TINY + ["--niter", "1", "--checkpoints_dir",
                                      ck]) == 0
    assert os.path.isfile(f"{ck}/pretrain_tex_200/1_net_TexG.pth")
    s2 = TINY + ["--n_blocks_translate", "2", "--niter", "1",
                 "--niter_decay", "0"]
    assert run_launcher(str(L / "train_e2e.sh"), [d], env=env, extra=s2) == 0
    out = capsys.readouterr().out
    assert "another number of residual blocks" in out and "val_PSNR" in out
    run = f"{ck}/{d}_18Feature_Temporal"
    g = ckpt.load_net(run, "G", 1)
    assert any(k.startswith("FeatE.") for k in g)
    _, argv = launcher_argv(str(L / "train_e2e.sh"), [d], env)
    npz = str(tmp_path / "feat.npz")
    assert encode_features.main(argv + s2 + ["--out", npz,
                                             "--which_epoch", "1"]) == 0
    assert np.load(npz)["centers"].shape == (10, 25, 3)
    assert td.main(argv + s2 + [
        "--results_dir", str(tmp_path / "serve1"), "--which_epoch", "1",
        "--load_features", npz, "--cluster_idx", "0", "--save_video"]) == 0
    assert len(os.listdir(tmp_path / "serve1" / "images")) == 6
    assert _video_frames(str(tmp_path / "serve1" / "video.mp4")) == 6
    env2 = dict(env, ROOT=corpus["serve_root"], POSE=env["OUT"],
                CKPTS=str(tmp_path / "empty"), RESULTS=str(tmp_path / "s2"))
    assert run_launcher(str(L / "test_infer.sh"), [d], env=env2,
                        extra=TINY + ["--n_blocks_translate", "1"]) == 0
    out = capsys.readouterr().out
    assert "random-init demo render" in out and "scale 1.000" in out
    assert len(os.listdir(tmp_path / "s2" / f"tgt_{d}" / "images")) == 6
