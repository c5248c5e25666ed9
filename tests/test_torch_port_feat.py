"""PyTorch port, the feature encoder E (--instance_feat / --label_feat):
FeatE, region_mean and part_pool against the JAX package's with the JAX
weights carried across by the bridge; the renderer in its three feature
modes; one stage-2 step under --use_laplace --instance_feat; the
encode_features entry point against the JAX tool's on the same weights.

Argmax rule. The renderer pools E's features over the argmax of its part
probabilities. On random weights the two frameworks' probabilities differ
by ~1e-6, which would flip the argmax of a pixel whose two largest logits
are that close, and TexG's input would then differ by a whole code.
region_mean / part_pool are compared on a region map given to both. The
renderer and step tests assert that every pixel's two largest logits
are further apart than ten times the largest difference between the two
frameworks' logits, so both pick the same part everywhere.

Tolerances (absolute, float32): FeatE, the pooling and the renderer's
outputs 1e-5; the step's losses 1e-5 relative and parameter changes per
tensor 1e-5 * max|change| over the net + 1e-4 * max|change| of the
tensor, as tests/test_torch_port_train_step.py; the cluster centers 1e-5.
"""

import dataclasses
import importlib.util
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neural_human_video_rendering_tpu.config import Options as JOptions
from neural_human_video_rendering_tpu.data import dataset as jds
from neural_human_video_rendering_tpu.models import generators as jg
from neural_human_video_rendering_tpu.models.renderer import \
    renderer_from_options as j_renderer_from_options
from neural_human_video_rendering_tpu.train import state as jstate
from neural_human_video_rendering_tpu.train import steps as jsteps
from neural_human_video_rendering_tpu_torch import encode_features as tef
from neural_human_video_rendering_tpu_torch.config import Options as TOptions
from neural_human_video_rendering_tpu_torch.config import TrainOptions
from neural_human_video_rendering_tpu_torch.data.dataset import SyntheticDataset
from neural_human_video_rendering_tpu_torch.data.densepose import encode_iuv
from neural_human_video_rendering_tpu_torch.models import generators as tg
from neural_human_video_rendering_tpu_torch.models.bridge import params_from_jax
from neural_human_video_rendering_tpu_torch.models.renderer import (
    init_params, renderer_from_options)
from neural_human_video_rendering_tpu_torch.train import state as tstate
from neural_human_video_rendering_tpu_torch.train.steps import (
    build_pose_input, make_forward_fn, make_train_step)
from neural_human_video_rendering_tpu_torch.utils.image import save_image

REPO = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-5
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's CPU thread pool slows many-fold when they share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.array, tree)          # writable copies


def _perturb_biases(params, seed=2):
    """flax's zero-init biases + 0.01 N(0, 1), so every parameter is
    exercised (numpy copies)."""
    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_flatten_with_path(_np_tree(params))
    leaves = [v + 0.01 * rng.standard_normal(v.shape).astype(np.float32)
              if str(path[-1]).endswith("'bias']") else v
              for path, v in flat[0]]
    return jax.tree_util.tree_unflatten(flat[1], leaves)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("pad_mode,upsample_mode", [
    ("same", "deconv"), ("reflect", "deconv"), ("same", "resize")])
def test_feat_encoder_matches_jax(pad_mode, upsample_mode):
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    kw = dict(pad_mode=pad_mode, upsample_mode=upsample_mode)
    jm = jg.FeatEncoder(3, 4, 3, **kw)
    params = _perturb_biases(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                              jnp.asarray(x))["params"])
    tm = tg.FeatEncoder(3, 4, 3, **kw)
    tm.load_state_dict(params_from_jax(params))
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_region_mean_and_part_pool_match_jax():
    """On a region map given to both (no argmax): a random one with an
    empty region, 25 regions."""
    rng = np.random.default_rng(3)
    fmap = rng.standard_normal((2, 12, 10, 3)).astype(np.float32)
    regions = rng.integers(0, 24, (2, 12, 10))         # region 24 stays empty
    onehot = np.eye(25, dtype=np.float32)[regions]
    jm = np.asarray(jg.region_mean(jnp.asarray(fmap), jnp.asarray(onehot)))
    jp = np.asarray(jg.part_pool(jnp.asarray(fmap), jnp.asarray(onehot)))
    tm = tg.region_mean(_nchw(fmap), _nchw(onehot)).numpy()
    tp = _nhwc(tg.part_pool(_nchw(fmap), _nchw(onehot)))
    np.testing.assert_allclose(tm, jm, atol=ATOL)
    np.testing.assert_allclose(tp, jp, atol=ATOL)
    assert np.abs(tm[:, 24]).max() == 0


def _flags(**over):
    base = dict(loadSize=32, tex_tile=16, n_blocks_translate=1,
                n_downsample_translate=2, n_blocks_global=1,
                n_downsample_global=1, n_blocks_bg=1, n_downsample_bg=1,
                ngf=4, ngf_global=4, dtype="float32", pose_heatmaps=True,
                coord_conv=True, stem_s2d=2, head_s2d=2, bg_s2d=4,
                pad_mode="same", warp_topk=24, warp_eps=0.0,
                instance_feat=True, nef=4, n_downsample_E=2)
    base.update(over)
    return base


def _assert_clear_argmax(ref, got):
    """ref: JAX logits (B, H, W, C), got: the port's (B, C, H, W). Every
    pixel's two largest logits further apart than ten times the largest
    difference between the two."""
    ref = np.asarray(ref)
    diff = float(np.abs(_nhwc(got) - ref).max())
    top2 = np.sort(ref, axis=-1)[..., -2:]
    margin = float((top2[..., 1] - top2[..., 0]).min())
    assert margin > 10 * diff, (margin, diff)


@pytest.fixture(scope="module")
def pair():
    """A tiny renderer under --instance_feat --use_laplace
    --pose_plus_laplace in both packages, JAX weights (seed 0: a clear
    argmax) carried across strictly, FeatE included, and its inputs."""
    return _renderer_pair({"use_laplace": True, "pose_plus_laplace": True})


def _renderer_pair(opt_over, seed=0):
    jopt, topt = JOptions(**_flags(**opt_over)), TOptions(**_flags(**opt_over))
    syn = SyntheticDataset(topt, length=2)
    joints = syn.joints
    tex, bg = syn.texture_atlas(), syn.background()
    jr_ = j_renderer_from_options(jopt)
    lap = np.random.default_rng(4).uniform(
        -1, 1, (2, 32, 32, topt.laplace_nc_eff)).astype(np.float32)
    lap = lap if topt.use_laplace else None
    pose = jsteps.build_pose_input(jopt, jnp.asarray(joints),
                                   None if lap is None else jnp.asarray(lap))
    feat_img = np.random.default_rng(5).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    args = (pose, jnp.asarray(bg)[None], jnp.asarray(tex)[None])
    params = _perturb_biases(jax.jit(jr_.init)(
        jax.random.PRNGKey(seed), *args, None,
        feat_image=jnp.asarray(feat_img))["params"])
    model = init_params(renderer_from_options(topt), 0)
    model.load_state_dict(params_from_jax(params))
    tpose = build_pose_input(topt, torch.from_numpy(joints),
                             None if lap is None else _nchw(lap))
    return (jr_, params, args, model, tpose, feat_img, topt,
            _nchw(bg)[None], _nchw(tex)[None])


@pytest.mark.parametrize("mode", ["feat_image", "cluster_feats", "zero"])
def test_renderer_feature_modes_match_jax(mode, pair):
    """The whole renderer in each of its three feature modes."""
    jr_, params, args, model, tpose, feat_img, topt, tbg, ttex = pair
    assert model.TexG.GlobalGenerator_0.ConvNormRelu_0.Conv_0.weight.shape[
        1] == 4 * (topt.pose_nc + topt.feat_num)
    codes = np.random.default_rng(6).uniform(-1, 1, (25, 3)).astype(np.float32)
    jkw, tkw = {}, {}
    if mode == "feat_image":
        jkw["feat_image"] = jnp.asarray(feat_img)
        tkw["feat_image"] = _nchw(feat_img)
    elif mode == "cluster_feats":
        jkw["cluster_feats"] = jnp.asarray(codes)
        tkw["cluster_feats"] = torch.from_numpy(codes)
    ref = jax.jit(lambda p, kw: jr_.apply({"params": p}, *args, None, **kw))(
        params, jkw)
    with torch.no_grad():
        out = model(tpose, tbg, ttex, None, **tkw)
    _assert_clear_argmax(ref["logits"], out["logits"])
    for key in ("fake", "fg", "mask", "probs", "bg_refined"):
        np.testing.assert_allclose(_nhwc(out[key]), np.asarray(ref[key]),
                                   atol=ATOL, err_msg=key)
    np.testing.assert_allclose(out["texture"].numpy().transpose(0, 1, 3, 4, 2),
                               np.asarray(ref["texture"]), atol=ATOL)
    if mode != "zero":        # the codes reach the render
        with torch.no_grad():
            zero = model(tpose, tbg, ttex, None)["texture"]
        assert float((zero - out["texture"]).abs().max()) > 1e-3


def test_forward_fn_modes_and_renderer_options(pair):
    """make_forward_fn hands the renderer the codes of --load_features or a
    real frame (the held-out eval); with --netG local, --uv_refine or
    --ms_uv (the options the port once refused) it renders too."""
    _, _, _, model, tpose, feat_img, topt, tbg, ttex = pair
    syn = SyntheticDataset(topt, length=2)
    joints = torch.from_numpy(syn.joints)
    lap = tpose[:, -3:]
    assets = (ttex[0], tbg[0], None)
    codes = np.random.default_rng(6).uniform(-1, 1, (25, 3)).astype(np.float32)
    model.eval()
    with torch.no_grad():
        want_c = model(tpose, tbg, ttex, None,
                       cluster_feats=torch.from_numpy(codes))["fake"]
        want_e = model(tpose, tbg, ttex, None,
                       feat_image=_nchw(feat_img))["fake"]
    got_c = make_forward_fn(topt, model, codes)(assets, joints, lap)["fake"]
    got_e = make_forward_fn(topt, model, codes)(
        assets, joints, lap, feat_image=_nchw(feat_img))["fake"]
    assert torch.equal(got_c, want_c) and torch.equal(got_e, want_e)
    for over in ({"netG": "local"}, {"uv_refine": 1}, {"ms_uv": 1}):
        o = dataclasses.replace(topt, **over)
        m = init_params(renderer_from_options(o), 2).eval()
        out = make_forward_fn(o, m, codes)(assets, joints, lap)
        assert out["fake"].shape == got_c.shape
        assert bool(torch.isfinite(out["fake"]).all())


STEP_FLAGS = dict(
    loadSize=32, tex_tile=16, batchSize=2, n_blocks_translate=1,
    n_downsample_translate=2, n_blocks_global=1, n_downsample_global=1,
    n_blocks_bg=1, n_downsample_bg=1, ngf=4, ngf_global=4, ndf=4, num_D=2,
    n_layers_D=2, dtype="float32", no_flip=True, pose_heatmaps=True,
    coord_conv=True, stem_s2d=2, head_s2d=2, bg_s2d=4, pad_mode="same",
    warp_topk=24, warp_eps=0.0, lambda_L2=500, lambda_UV=1000,
    lambda_Prob=10, lambda_Temp=500, use_densepose_loss=True,
    no_vgg_loss=True, ema_decay=0.999, use_laplace=True, instance_feat=True,
    nef=4, n_downsample_E=2, temporal_prev="fake")


def _assert_deltas(name, got, ref, before):
    dj = {k: ref[k] - before[k] for k in ref}
    scale = max(float(d.abs().max()) for d in dj.values())
    assert scale > 0
    for k, d in dj.items():
        err = float(((got[k] - before[k]) - d).abs().max())
        tol = 1e-5 * scale + 1e-4 * float(d.abs().max())
        assert err <= tol, f"{name} {k}: {err:.3e} > {tol:.3e}"


def test_train_step_laplace_feat_matches_jax(tmp_path):
    """One stage-2 step under train_e2e.sh's --use_laplace --instance_feat
    (the pose input is then the LaplaceProj channels, with no skeleton,
    plus the tiny config's heatmaps and ramps), --temporal_prev fake: the
    real frame t is encoded for the render of t and image_prev for the
    detached t-1 render, whose pose reuses frame t's LaplaceProj. SGD lr
    1 on both sides, so each parameter's change is its gradient.

    Texel edges: bilinear sampling's gradient in uv jumps where a sample
    crosses a texel edge, and ~1e-6 differences between the frameworks
    would move a few samples across one. Here TransG's uv outputs have
    zero weights and one bias, so every sample sits mid-cell (u (T-1) =
    v (T-1) = 5.5), far from any edge, and off the synthetic DensePose
    uv, whose L1 gradient at 0 is 1 in JAX and 0 in torch (the uv head's
    weights still get their gradient); TexG and E are left random, so E's
    gradient flows through TexG into the warp."""
    flags = dict(STEP_FLAGS, checkpoints_dir=str(tmp_path))
    jopt = JOptions(**flags, use_pallas_warp=False)
    topt = TOptions(**flags, gpu_ids="-1")
    assert topt.pose_nc == 18 + 2 + 3 and not topt.use_pose_render
    ds = jds.SyntheticDataset(jopt, length=4)
    batch = jds.collate([ds[i] for i in (1, 2)])
    rng = np.random.default_rng(8)
    batch["laplace"] = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    batch["image_prev"] = np.clip(batch["image"] + rng.normal(
        0, 0.1, batch["image"].shape), -1, 1).astype(np.float32)
    atlas, bg = ds.texture_atlas(), ds.background()

    # PRNGKey 5: a clear argmax at every pixel of both renders
    bundle = jstate.create_train_state(jopt, jax.random.PRNGKey(5), atlas, bg)
    g0 = _np_tree(bundle["state"].g_params)
    assert "FeatE" in g0
    with torch.device("meta"):
        head = renderer_from_options(topt).TransG.GlobalGenerator_0.order[-1]
    conv = g0["TransG"]["GlobalGenerator_0"][head]["Conv_0"]
    C = topt.transg_out_nc
    uv_out = [k * C + c for k in range(4) for c in range(25, C)]
    conv["kernel"][..., uv_out] = 0.0
    uv_mid = 5.5 / (topt.tex_tile - 1)              # mid-cell: u*(T-1) = 5.5
    conv["bias"][uv_out] = np.arctanh(2 * uv_mid - 1)
    d0 = _np_tree(bundle["state"].d_params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    sgd = optax.sgd(1.0)
    jst0 = bundle["state"].replace(
        g_params=jax.tree.map(jnp.asarray, g0),
        d_params=jax.tree.map(jnp.asarray, d0),
        g_ema=jax.tree.map(jnp.asarray, g0),
        g_opt=sgd.init(g0), d_opt=sgd.init(d0))
    jstep = jsteps.make_train_step(jopt, bundle["renderer"], bundle["disc"],
                                   None, sgd, sgd)
    jst1, jm = jstep(jst0, jb)

    st = tstate.create_train_state(topt, atlas, bg,
                                   device=torch.device("cpu"))
    st.renderer.load_state_dict(params_from_jax(g0))
    st.disc.load_state_dict(params_from_jax(d0))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for key in ("joints", "joints_prev"):      # the renders of t and t-1
        out = bundle["renderer"].apply(
            {"params": g0}, jsteps.build_pose_input(jopt, jb[key],
                                                    jb["laplace"]),
            jnp.asarray(bg)[None], jnp.asarray(atlas)[None], None,
            feat_image=jb["image"])
        np.testing.assert_allclose(np.asarray(out["uv"]), uv_mid, atol=1e-6)
        with torch.no_grad():
            logits, _ = st.renderer.TransG(build_pose_input(
                topt, tb[key], _nchw(batch["laplace"])))
        _assert_clear_argmax(out["logits"], logits)
    st.g_ema = {k: v.detach().clone()
                for k, v in st.renderer.named_parameters()}
    assert any(k.startswith("FeatE.") for k in st.g_ema)
    g_before = {k: v.clone() for k, v in st.renderer.state_dict().items()}
    d_before = {k: v.clone() for k, v in st.disc.state_dict().items()}
    step = make_train_step(topt, st.renderer, st.disc, None,
                           torch.optim.SGD(st.renderer.parameters(), lr=1.0),
                           torch.optim.SGD(st.disc.parameters(), lr=1.0))
    tm = step(st, batch)

    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    g_ref = params_from_jax(_np_tree(jst1.g_params))
    _assert_deltas("G", st.renderer.state_dict(), g_ref, g_before)
    _assert_deltas("D", st.disc.state_dict(),
                   params_from_jax(_np_tree(jst1.d_params)), d_before)
    _assert_deltas("EMA", st.g_ema, params_from_jax(_np_tree(jst1.g_ema)),
                   g_before)
    moved = max(float((g_ref[k] - g_before[k]).abs().max())
                for k in g_ref if k.startswith("FeatE."))
    assert moved > 0, "E got no gradient"


def _write_feat_corpus(root, opt, n=6):
    syn = SyntheticDataset(opt, length=n, seed=0)
    for d in ("frames", "dp"):
        os.makedirs(os.path.join(root, d))
    for i in range(n):
        s = syn[i]
        save_image(os.path.join(root, "frames", f"frame{i:05d}.png"),
                   s["image"])
        with open(os.path.join(root, "dp", f"frame{i:05d}.png"), "wb") as f:
            from neural_human_video_rendering_tpu_torch.utils.image import \
                encode_png
            f.write(encode_png(encode_iuv(s["dp_parts"], s["dp_uv"])))
    return os.path.join(root, "frames"), os.path.join(root, "dp")


def test_encode_features_matches_jax_tool(tmp_path, monkeypatch, capsys):
    """tools/encode_features.py and the port's encode_features on the same
    corpus and the same G (the JAX tool's .msgpack, read by the port
    through the bridge): 6 frames, 3 clusters (k-means from RandomState(0)
    on both sides)."""
    small = ("--loadSize 32 --tex_tile 16 --ngf 4 --ngf_global 4 "
             "--n_blocks_translate 1 --n_downsample_translate 2 "
             "--n_blocks_global 1 --n_downsample_global 1 --n_blocks_bg 1 "
             "--n_downsample_bg 1 --nef 4 --n_downsample_E 2 "
             "--dtype float32 --instance_feat --no_flip --gpu_ids -1").split()
    topt = TrainOptions().parse(small, save=False)
    frames, dp = _write_feat_corpus(str(tmp_path / "c"), topt)
    ck = str(tmp_path / "ckpt")
    args = small + ["--img_path", frames, "--densepose_path", dp, "--name",
                    "fe", "--checkpoints_dir", ck, "--n_clusters", "3"]
    jopt = JOptions(**{k: getattr(topt, k) for k in (
        "loadSize", "tex_tile", "ngf", "ngf_global", "n_blocks_translate",
        "n_downsample_translate", "n_blocks_global", "n_downsample_global",
        "n_blocks_bg", "n_downsample_bg", "nef", "n_downsample_E", "dtype",
        "instance_feat")})
    g = jstate.create_train_state(jopt, jax.random.PRNGKey(2), np.zeros(
        (24, 16, 16, 3), np.float32), np.zeros((32, 32, 3), np.float32),
        with_discriminator=False)["state"].g_params
    from neural_human_video_rendering_tpu.utils import checkpoint as jckpt
    jckpt.save_net(os.path.join(ck, "fe"), "G", 1, jax.tree.map(np.asarray, g))

    from neural_human_video_rendering_tpu import runtime
    monkeypatch.setattr(runtime, "setup_jax", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        "_jax_encode_features", REPO / "tools" / "encode_features.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", ["encode_features.py", "--out",
                                      str(tmp_path / "j.npz")] + args)
    tool.main()
    assert tef.main(["--out", str(tmp_path / "t.npz")] + args) == 0
    assert "[feat] wrote" in capsys.readouterr().out
    ref = np.load(tmp_path / "j.npz")["centers"]
    got = np.load(tmp_path / "t.npz")["centers"]
    assert got.shape == ref.shape == (3, 25, 3)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, atol=1e-5)
    x = np.random.RandomState(1).rand(9, 3).astype(np.float32)
    np.testing.assert_array_equal(tef.kmeans(x, 4), tool.kmeans(x, 4))
    np.testing.assert_array_equal(tef.kmeans(x[:2], 4), tool.kmeans(x[:2], 4))
