"""PyTorch port, training models and data: the multiscale discriminator,
the VGG19 feature extractor and the perceptual loss, the weight bridge on
the JAX package's discriminator and VGG trees, the wire format and the
synthetic training data, each held against the JAX package on the same
numpy inputs with the JAX weights carried across.

Tolerances: 1e-5 absolute for the discriminator's features (float32, a
few convolutions and instance norms); VGG taps and loss in float32 at
1e-5 relative to the largest activation; the VGG loss in bfloat16 (as the
train step runs it) at 2e-2 relative, since bf16 rounds activations at
other places in the two frameworks; the data exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu.data import dataset as jds
from neural_human_video_rendering_tpu.data import wire as jwire
from neural_human_video_rendering_tpu.losses.perceptual import \
    vgg_loss as j_vgg_loss
from neural_human_video_rendering_tpu.models import vgg as jvgg
from neural_human_video_rendering_tpu.models.discriminator import \
    MultiscaleDiscriminator as JDisc
from neural_human_video_rendering_tpu.train.state import \
    create_train_state as j_create_train_state
from neural_human_video_rendering_tpu_torch.config import Options as TOptions
from neural_human_video_rendering_tpu_torch.data import dataset as tds
from neural_human_video_rendering_tpu_torch.data import wire as twire
from neural_human_video_rendering_tpu_torch.losses.perceptual import vgg_loss
from neural_human_video_rendering_tpu_torch.models import vgg as tvgg
from neural_human_video_rendering_tpu_torch.models.bridge import params_from_jax
from neural_human_video_rendering_tpu_torch.models.discriminator import (
    MultiscaleDiscriminator, discriminator_from_options)
from neural_human_video_rendering_tpu_torch.models.renderer import init_params

D_ATOL = 1e-5
VGG_RTOL = 1e-5
VGG_BF16_RTOL = 2e-2


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("stem_s2d,size", [(1, 32), (2, 32), (2, 20),
                                           (4, 32)])
def test_discriminator_matches_jax(stem_s2d, size):
    """Both stem modes; at size 20 the second scale (10) does not divide by
    4 but does by 2, at (4, 32) the second scale (16) keeps the packed
    stem."""
    rng = np.random.default_rng(stem_s2d)
    x = rng.standard_normal((2, size, size, 7)).astype(np.float32)
    jd = JDisc(num_D=2, ndf=4, n_layers=3, stem_s2d=stem_s2d)
    params = jd.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = jd.apply({"params": params}, jnp.asarray(x))
    with torch.device("meta"):
        td = MultiscaleDiscriminator(7, size, num_D=2, ndf=4, n_layers=3,
                                     stem_s2d=stem_s2d)
    td = init_params(td, 0)
    td.load_state_dict(params_from_jax(_np_tree(params)))
    with torch.no_grad():
        got = td(_nchw(x))
    assert len(got) == len(ref) == 2
    for d, (rs, gs) in enumerate(zip(ref, got)):
        assert len(rs) == len(gs) == 5
        for i, (r, g) in enumerate(zip(rs, gs)):
            r = np.asarray(r)
            assert g.shape == (r.shape[0], r.shape[3], r.shape[1], r.shape[2])
            np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), r,
                                       atol=D_ATOL, err_msg=f"scale {d} {i}")


def _vgg_pair(size=32, seed=0):
    params = jvgg.init_vgg_params(jax.random.PRNGKey(seed), size)
    with torch.device("meta"):
        tm = tvgg.VGG19Features()
    tm = init_params(tm, 0)
    tm.load_state_dict(params_from_jax(_np_tree(params)))
    return params, tm


def test_vgg_features_match_jax_float32():
    params, tm = _vgg_pair()
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    ref = jvgg.VGG19Features(dtype=jnp.float32).apply({"params": params},
                                                      jnp.asarray(x))
    with torch.no_grad():
        got = tm(_nchw(x))
    assert len(got) == len(ref) == 5
    for i, (r, g) in enumerate(zip(ref, got)):
        r = np.asarray(r)
        tol = VGG_RTOL * float(np.abs(r).max())
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), r,
                                   atol=tol, err_msg=f"tap {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vgg_loss_matches_jax(dtype):
    params, tm = _vgg_pair(seed=1)
    rng = np.random.default_rng(4)
    fake = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    real = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = float(j_vgg_loss(params, jnp.asarray(fake), jnp.asarray(real),
                           dtype=jdt))
    tm.dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    with torch.no_grad():
        got = float(vgg_loss(tm, _nchw(fake), _nchw(real)))
    rtol = VGG_BF16_RTOL if dtype == "bfloat16" else VGG_RTOL
    np.testing.assert_allclose(got, ref, rtol=rtol)


def test_vgg_pack_and_pretrained_loader(tmp_path):
    """pack_conv_weights is the JAX package's; a torchvision-layout .npz
    loads into the packed module, and build_vgg is seeded and frozen."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((3, 3, 3, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    for got, ref in zip(tvgg.pack_conv_weights(w, b),
                        jvgg.pack_conv_weights(w, b)):
        np.testing.assert_array_equal(got, ref)
    arrays = {}
    widths = [64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512, 512]
    cin = 3
    for i, tv in enumerate(tvgg._TV_CONV_IDX[:13]):
        arrays[f"features.{tv}.weight"] = (rng.standard_normal(
            (widths[i], cin, 3, 3)) * 0.1).astype(np.float32)
        arrays[f"features.{tv}.bias"] = rng.standard_normal(
            widths[i]).astype(np.float32) * 0.1
        cin = widths[i]
    path = str(tmp_path / "vgg19.npz")
    np.savez(path, **arrays)
    ref_params = _np_tree(jvgg.load_pretrained(path))
    vgg = tvgg.build_vgg(0, path, dtype=torch.float32)
    sd = params_from_jax(ref_params)
    for k, v in vgg.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)
    assert not any(p.requires_grad for p in vgg.parameters())
    a, b2 = tvgg.build_vgg(7), tvgg.build_vgg(7)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b2.state_dict().values()))


def test_bridge_carries_train_state_trees(tiny_opt):
    """One JAX TrainState's g_params, d_params and VGG params load into the
    port's renderer, discriminator and VGG with every key matched."""
    from neural_human_video_rendering_tpu_torch.models.renderer import \
        renderer_from_options
    opt = dataclasses.replace(tiny_opt, stem_s2d=2)
    ds = jds.SyntheticDataset(opt, length=2)
    bundle = j_create_train_state(opt, jax.random.PRNGKey(0),
                                  ds.texture_atlas(), ds.background())
    st = bundle["state"]
    topt = TOptions(**{f.name: getattr(opt, f.name)
                       for f in dataclasses.fields(TOptions)})
    g = init_params(renderer_from_options(topt), 0)
    d = init_params(discriminator_from_options(topt), 0)
    with torch.device("meta"):
        v = tvgg.VGG19Features()
    v = init_params(v, 0)
    for mod, tree in ((g, st.g_params), (d, st.d_params),
                      (v, bundle["vgg_params"])):
        sd = params_from_jax(_np_tree(tree))
        assert sorted(sd) == sorted(mod.state_dict())
        mod.load_state_dict(sd)
    k = "scale_1.Conv_0.weight"
    np.testing.assert_array_equal(
        d.state_dict()[k].numpy(),
        np.asarray(st.d_params["scale_1"]["Conv_0"]["kernel"]).transpose(
            3, 2, 0, 1))


def _items(opt, idx=(0, 3, 1)):
    j = jds.SyntheticDataset(opt, length=5, seed=2)
    topt = TOptions(**{f.name: getattr(opt, f.name)
                       for f in dataclasses.fields(TOptions)})
    t = tds.SyntheticDataset(topt, length=5, seed=2)
    return j, t, idx


def test_synthetic_items_and_batches_match_jax(tiny_opt):
    j, t, idx = _items(tiny_opt)
    assert len(t) == len(j) == 5
    for i in idx:
        a, b = j[i], t[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    ja = jds.collate([j[i] for i in idx])
    tb = tds.collate([t[i] for i in idx])
    for k in ja:
        np.testing.assert_array_equal(tb[k], ja[k])
    jp, tp = jwire.pack_batch(ja), twire.pack_batch(tb)
    for k in jp:
        assert tp[k].dtype == jp[k].dtype, k
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)


def test_unpack_batch_matches_jax(tiny_opt):
    j, t, idx = _items(tiny_opt)
    packed = jwire.pack_batch(jds.collate([j[i] for i in idx]))
    ref = jwire.unpack_batch({k: jnp.asarray(v) for k, v in packed.items()})
    got = twire.unpack_batch(packed, torch.device("cpu"))
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        g = got[k].numpy()
        if r.ndim == 4:                    # NHWC -> the port's NCHW
            g = g.transpose(0, 2, 3, 1)
        assert g.shape == r.shape, k
        np.testing.assert_allclose(g, r, atol=1e-7, err_msg=k)
    assert got["dp_parts"].dtype == torch.int64
    assert got["image"].dtype == torch.float32
    # raw float32 batches pass through the dtype conversions untouched
    raw = twire.unpack_batch(tds.collate([t[i] for i in idx]),
                             torch.device("cpu"))
    np.testing.assert_array_equal(raw["flow"].numpy().transpose(0, 2, 3, 1),
                                  jds.collate([j[i] for i in idx])["flow"])


def test_batch_loader_orders_and_transforms(tiny_opt):
    _, t, _ = _items(tiny_opt)
    loader = tds.BatchLoader(t, 2, shuffle=True, seed=3,
                             transform=twire.pack_batch)
    assert len(loader) == 2
    order = np.arange(5)
    np.random.RandomState(3).shuffle(order)
    batches = list(loader)
    assert [list(b["index"]) for b in batches] == [list(order[:2]),
                                                    list(order[2:4])]
    assert batches[0]["image"].dtype == np.uint8
    assert loader.epoch == 1
    # stopping early leaves no worker behind and does not count an epoch
    it = iter(loader)
    next(it)
    it.close()
    assert loader.epoch == 1
    in_order = tds.BatchLoader(t, 2, shuffle=False)
    assert [list(b["index"]) for b in in_order] == [[0, 1], [2, 3]]
