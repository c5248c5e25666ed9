"""PyTorch port, models and pose input: each module held against its JAX
counterpart with the JAX-initialised weights carried across by
``models/bridge.params_from_jax``.

Inputs come from a numpy seed; everything runs in float32 on the CPU.
Tolerances (absolute): 1e-5 for single layers, 1e-4 for whole
generators and the renderer (float32 convolutions summed in another
order, through several instance norms), exact for the layout shuffles.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu.config import Options as JOptions
from neural_human_video_rendering_tpu.data import rasterize as jr
from neural_human_video_rendering_tpu.models import generators as jg
from neural_human_video_rendering_tpu.models import layers as jl
from neural_human_video_rendering_tpu.models.renderer import \
    renderer_from_options as j_renderer_from_options
from neural_human_video_rendering_tpu.train.steps import \
    build_pose_input as j_build_pose_input
from neural_human_video_rendering_tpu_torch.config import Options as TOptions
from neural_human_video_rendering_tpu_torch.data import rasterize as tr
from neural_human_video_rendering_tpu_torch.data.dataset import SyntheticDataset
from neural_human_video_rendering_tpu_torch.models import generators as tg
from neural_human_video_rendering_tpu_torch.models import layers as tl
from neural_human_video_rendering_tpu_torch.models.bridge import params_from_jax
from neural_human_video_rendering_tpu_torch.models.renderer import (
    init_params, renderer_from_options)
from neural_human_video_rendering_tpu_torch.train.steps import build_pose_input

LAYER_ATOL = 1e-5
NET_ATOL = 1e-4


def _nhwc(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _from_nchw(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _carry(jmod, tmod, x, seed=0):
    """Init the flax module on x, load its params into the torch module;
    -> (flax output, torch output) as NHWC numpy."""
    params = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x)).get(
        "params", {})
    if params:
        tmod.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _from_nchw(tmod(_to_nchw(x)))
    return ref, got


def test_instance_norm():
    x = _nhwc(np.random.default_rng(0), 2, 6, 5, 4) * 3 + 1
    ref, got = _carry(jl.InstanceNorm(), tl.InstanceNorm(), x)
    np.testing.assert_allclose(got, ref, atol=LAYER_ATOL)


@pytest.mark.parametrize("f", [2, 4])
def test_space_to_depth_channel_order(f):
    x = _nhwc(np.random.default_rng(f), 2, 8, 8, 3)
    ref = np.asarray(jl.space_to_depth(jnp.asarray(x), f))
    got = _from_nchw(tl.space_to_depth(_to_nchw(x), f))
    np.testing.assert_array_equal(got, ref)
    back = _from_nchw(tl.depth_to_space(_to_nchw(ref), f))
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(
        _from_nchw(tl.depth_to_space(_to_nchw(ref), f)),
        np.asarray(jl.depth_to_space(jnp.asarray(ref), f)))


@pytest.mark.parametrize("pad_mode", ["same", "reflect"])
@pytest.mark.parametrize("kernel,stride", [(7, 1), (3, 2), (3, 1)])
def test_conv_norm_relu(pad_mode, kernel, stride):
    x = _nhwc(np.random.default_rng(kernel), 2, 12, 12, 5)
    ref, got = _carry(
        jl.ConvNormRelu(6, kernel, stride, pad_mode=pad_mode),
        tl.ConvNormRelu(5, 6, kernel, stride, pad_mode=pad_mode), x)
    np.testing.assert_allclose(got, ref, atol=LAYER_ATOL)


@pytest.mark.parametrize("mode,pad_mode", [
    ("deconv", "same"), ("deconv", "reflect"), ("resize", "same")])
def test_upsample(mode, pad_mode):
    x = _nhwc(np.random.default_rng(3), 2, 5, 7, 6)
    ref, got = _carry(jl.Upsample(4, mode=mode, pad_mode=pad_mode),
                      tl.Upsample(6, 4, mode=mode, pad_mode=pad_mode), x)
    assert got.shape == (2, 10, 14, 4)
    np.testing.assert_allclose(got, ref, atol=LAYER_ATOL)


def test_resnet_block():
    x = _nhwc(np.random.default_rng(4), 1, 8, 8, 6)
    ref, got = _carry(jl.ResnetBlock(6, pad_mode="reflect"),
                      tl.ResnetBlock(6, pad_mode="reflect"), x)
    np.testing.assert_allclose(got, ref, atol=LAYER_ATOL)


@pytest.mark.parametrize("s2d,pad_mode", [(2, "same"), (4, "same"),
                                          (2, "reflect"), (1, "reflect")])
def test_global_generator(s2d, pad_mode):
    x = _nhwc(np.random.default_rng(s2d), 2, 32, 32, 5)
    kw = dict(ngf=4, n_downsampling=2, n_blocks=2, pad_mode=pad_mode,
              stem_s2d=s2d, head_s2d=s2d)
    ref, got = _carry(jg.GlobalGenerator(7, **kw),
                      tg.GlobalGenerator(5, 7, **kw), x)
    np.testing.assert_allclose(got, ref, atol=NET_ATOL)


def test_transg_split_iuv():
    x = _nhwc(np.random.default_rng(5), 2, 16, 16, 23)
    kw = dict(ngf=4, n_downsampling=2, n_blocks=1, stem_s2d=2, head_s2d=2,
              pad_mode="same")
    jm, tm = jg.TransG(24, **kw), tg.TransG(23, 24, **kw)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    logits, uv = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        tlog, tuv = tm(_to_nchw(x))
    np.testing.assert_allclose(_from_nchw(tlog), np.asarray(logits),
                               atol=NET_ATOL)
    # port uv (B, P, 2, H, W) -> JAX (B, H, W, P, 2)
    np.testing.assert_allclose(tuv.numpy().transpose(0, 3, 4, 1, 2),
                               np.asarray(uv), atol=NET_ATOL)


@pytest.mark.parametrize("size,tile", [(64, 16), (16, 16), (8, 16)])
def test_texg_resize(size, tile):
    x = _nhwc(np.random.default_rng(size), 2, size, size, 23)
    kw = dict(ngf=4, n_downsampling=1, n_blocks=1, stem_s2d=2, head_s2d=2,
              pad_mode="same")
    jm, tm = jg.TexG(24, tile, **kw), tg.TexG(23, 24, tile, **kw)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(_to_nchw(x)).numpy()            # (B, P, 3, T, T)
    np.testing.assert_allclose(got.transpose(0, 1, 3, 4, 2), ref,
                               atol=NET_ATOL)


def test_bgnet_s2d4():
    x = np.tanh(_nhwc(np.random.default_rng(6), 1, 32, 32, 3))
    kw = dict(n_downsampling=2, n_blocks=1, s2d=4, pad_mode="same")
    ref, got = _carry(jg.BGNet(8, **kw), tg.BGNet(8, **kw), x)
    np.testing.assert_allclose(got, ref, atol=NET_ATOL)


def _flags(**over):
    base = dict(loadSize=32, tex_tile=16, n_blocks_translate=1,
                n_downsample_translate=2, n_blocks_global=1,
                n_downsample_global=1, n_blocks_bg=1, n_downsample_bg=1,
                ngf=4, ngf_global=4, dtype="float32", pose_heatmaps=True,
                coord_conv=True, stem_s2d=2, head_s2d=2, bg_s2d=4,
                pad_mode="same", warp_topk=4, warp_eps=1e-3)
    base.update(over)
    return base


def _joints(S, n=2, seed=0):
    opt = TOptions(**_flags(loadSize=S))
    joints = SyntheticDataset(opt, length=n, seed=seed).joints
    joints[0, 3, 2] = 0.0         # an undetected joint gates its limbs
    return joints


def test_rasterize_matches_jax():
    j = _joints(48)
    ref_sk = np.asarray(jax.vmap(lambda x: jr.render_skeleton(x, 48, 40))(
        jnp.asarray(j)))
    got_sk = _from_nchw(tr.render_skeleton(torch.from_numpy(j), 48, 40))
    mismatch = np.abs(got_sk - ref_sk).max(-1) > 0
    # the capsule edge test d2 <= r^2 may flip a pixel on a float ulp
    assert mismatch.mean() < 1e-3, mismatch.sum()
    ref_hm = np.asarray(jax.vmap(lambda x: jr.joint_heatmaps(x, 48, 40))(
        jnp.asarray(j)))
    got_hm = _from_nchw(tr.joint_heatmaps(torch.from_numpy(j), 48, 40))
    np.testing.assert_allclose(got_hm, ref_hm, atol=1e-6)


def test_build_pose_input_matches_jax():
    j = _joints(32)
    ref = np.asarray(j_build_pose_input(JOptions(**_flags()),
                                        jnp.asarray(j), None))
    got = _from_nchw(build_pose_input(TOptions(**_flags()),
                                      torch.from_numpy(j)))
    assert got.shape == ref.shape == (2, 32, 32, 23)
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("over", [{}, {"pad_mode": "reflect"},
                                  {"upsample_mode": "resize"}])
def test_renderer_matches_jax(over):
    """The whole NeuralRenderer forward, JAX weights carried across."""
    jopt, topt = JOptions(**_flags(**over)), TOptions(**_flags(**over))
    rng = np.random.default_rng(7)
    S, T = 32, 16
    joints = _joints(S)
    syn = SyntheticDataset(topt)
    tex, bg = syn.texture_atlas(), syn.background()
    jr_ = j_renderer_from_options(jopt)
    pose = j_build_pose_input(jopt, jnp.asarray(joints), None)
    args = (pose, jnp.asarray(bg)[None], jnp.asarray(tex)[None])
    params = jr_.init(jax.random.PRNGKey(3), *args)["params"]
    # perturb the zero-init biases so every parameter is exercised
    params = jax.tree.map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params)
    ref = jr_.apply({"params": params}, *args)

    model = init_params(renderer_from_options(topt), 0)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        out = model(build_pose_input(topt, torch.from_numpy(joints)),
                    torch.from_numpy(bg.transpose(2, 0, 1))[None],
                    torch.from_numpy(tex.transpose(0, 3, 1, 2))[None])
    assert sorted(out) == sorted(k for k in ref if k != "ms_aux")
    for key in ("fake", "fg", "mask", "probs", "bg_refined"):
        np.testing.assert_allclose(_from_nchw(out[key]), np.asarray(ref[key]),
                                   atol=NET_ATOL, err_msg=key)
    np.testing.assert_allclose(out["uv"].numpy().transpose(0, 3, 4, 1, 2),
                               np.asarray(ref["uv"]), atol=NET_ATOL)
    np.testing.assert_allclose(out["texture"].numpy().transpose(0, 1, 3, 4, 2),
                               np.asarray(ref["texture"]), atol=NET_ATOL)


def test_init_params_is_seeded_and_flax_scaled():
    topt = TOptions(**_flags())
    a = init_params(renderer_from_options(topt), 5)
    b = init_params(renderer_from_options(topt), 5)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.TransG.GlobalGenerator_0.ResnetBlock_0.ConvNormRelu_0.Conv_0.weight
    fan_in = w.shape[1] * 9
    assert abs(float(w.detach().std()) * fan_in ** 0.5 - 1.0) < 0.15


def test_unported_options_raise():
    for over in ({"netG": "local"}, {"uv_refine": 1}, {"ms_uv": 1}):
        with pytest.raises(NotImplementedError):
            renderer_from_options(dataclasses.replace(TOptions(**_flags()),
                                                      **over))
