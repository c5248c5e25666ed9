"""PyTorch port, the model options: pix2pixHD's LocalEnhancer (--netG
local), GlobalGenerator's aux heads (--ms_uv), TransG's refinement stack
(--uv_refine), the renderer with each of them and with the mirrored
background of flip augmentation (bg_flip), JAX checkpoints of those
models served through the port, and the UV-gradient and multi-scale IUV
losses. Each is held against the JAX package's function with the JAX
weights carried across (``models/bridge.params_from_jax``); inputs come
from a numpy seed; float32 on the CPU.

Tolerances (absolute): 1e-5 for a layer, 1e-4 for a net or the renderer
(float32 convolutions summed in another order through several instance
norms); the losses 1e-5 relative. Renderers blend every part
(--warp_topk 24 --warp_eps 0): a top-k selection among near-equal random
probabilities flips on the frameworks' rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu.config import Options as JOptions
from neural_human_video_rendering_tpu.losses import recon as jrecon
from neural_human_video_rendering_tpu.models import generators as jg
from neural_human_video_rendering_tpu.models.renderer import \
    renderer_from_options as j_renderer_from_options
from neural_human_video_rendering_tpu.train import steps as jsteps
from neural_human_video_rendering_tpu.utils import checkpoint as jckpt
from neural_human_video_rendering_tpu_torch.config import Options as TOptions
from neural_human_video_rendering_tpu_torch.data.dataset import SyntheticDataset
from neural_human_video_rendering_tpu_torch.infer import test_driver as td
from neural_human_video_rendering_tpu_torch.losses import recon as trecon
from neural_human_video_rendering_tpu_torch.models import generators as tg
from neural_human_video_rendering_tpu_torch.models.bridge import params_from_jax
from neural_human_video_rendering_tpu_torch.models.renderer import (
    init_params, renderer_from_options)
from neural_human_video_rendering_tpu_torch.train.steps import make_forward_fn

LAYER_ATOL = 1e-5
NET_ATOL = 1e-4
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nhwc(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _back(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _perturbed(params, seed):
    """Every parameter moved off flax's init (its biases are 0)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
            p.shape).astype(np.float32), params)


def _carry(jmod, tmod, x, seed=0):
    """Init the flax module on x, perturb, load into the torch module
    (strict); -> (flax output, torch output)."""
    params = _perturbed(jmod.init(jax.random.PRNGKey(seed),
                                  jnp.asarray(x))["params"], seed)
    tmod.load_state_dict(params_from_jax(params), strict=True)
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(_nchw(x))
    return params, ref, got


@pytest.mark.parametrize("levels", [1, 2])
def test_local_enhancer_matches_jax(levels):
    """Both pyramid depths, the trunk's stem s2d, flax's names
    (global_trunk, enh{l}_*, head)."""
    x = _nhwc(np.random.default_rng(levels), 2, 32, 32, 5) * 0.5
    jm = jg.LocalEnhancer(3, 4, 2, 1, levels, 2, stem_s2d=2, pad_mode="same")
    tm = tg.LocalEnhancer(5, 3, 4, 2, 1, levels, 2, stem_s2d=2,
                          pad_mode="same")
    params, ref, got = _carry(jm, tm, x)
    assert {"global_trunk", "head", f"enh{levels}_stem", "enh1_up"} <= set(
        params)
    assert got.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(_back(got), np.asarray(ref), atol=NET_ATOL)


def test_local_enhancer_pools_like_flax():
    """The pyramid counts the padding, as flax's avg_pool does (pix2pixHD's
    AvgPool2d does not): one 3x3 stride-2 pool, layer tolerance."""
    x = _nhwc(np.random.default_rng(3), 2, 16, 16, 4)
    import flax.linen as fnn
    ref = fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                       padding=((1, 1), (1, 1)))
    got = torch.nn.functional.avg_pool2d(_nchw(x), 3, 2, 1,
                                         count_include_pad=True)
    np.testing.assert_allclose(_back(got), np.asarray(ref), atol=LAYER_ATOL)


def test_aux_heads_match_jax():
    """--ms_uv 2 on the r5 recipe's shape (4 downsamplings, stem and head
    s2d 2): the aux heads sit on stride-1 decoder convs, at 1/4 and 1/2
    of the input; shapes and values against JAX."""
    x = _nhwc(np.random.default_rng(4), 2, 32, 32, 5)
    jm = jg.TransG(24, 4, 4, 1, stem_s2d=2, head_s2d=2, ms_uv=2,
                   pad_mode="same")
    tm = tg.TransG(5, 24, 4, 4, 1, stem_s2d=2, head_s2d=2, ms_uv=2,
                   pad_mode="same")
    params, ref, got = _carry(jm, tm, x)
    assert {"aux_head1", "aux_head2"} <= set(params["GlobalGenerator_0"])
    assert len(ref[2]) == len(got[2]) == 2
    for (jl, ju), (tl, tu) in zip(ref[2], got[2]):
        assert tuple(tl.shape) == (2, 25) + jl.shape[1:3]
        assert tuple(tu.shape) == (2, 24, 2) + ju.shape[1:3]
        np.testing.assert_allclose(_back(tl), np.asarray(jl), atol=NET_ATOL)
        np.testing.assert_allclose(tu.numpy().transpose(0, 3, 4, 1, 2),
                                   np.asarray(ju), atol=NET_ATOL)
    assert [a[0].shape[2] for a in got[2]] == [8, 16]
    np.testing.assert_allclose(_back(got[0]), np.asarray(ref[0]),
                               atol=NET_ATOL)


@pytest.mark.parametrize("height", [32, 15])
def test_uv_refine_matches_jax(height):
    """The refinement stack at an even height (space-to-depth by 2) and an
    odd one (none; a backbone without downsampling keeps the height)."""
    downs = 2 if height % 2 == 0 else 0
    x = _nhwc(np.random.default_rng(height), 2, height, height, 5)
    jm = jg.TransG(24, 4, downs, 1, uv_refine=2, uv_refine_ngf=8,
                   pad_mode="same")
    tm = tg.TransG(5, 24, 4, downs, 1, uv_refine=2, uv_refine_ngf=8,
                   refine_f=2 if height % 2 == 0 else 1, pad_mode="same")
    params, ref, got = _carry(jm, tm, x)
    assert {"refine_stem", "refine_block1", "refine_head"} <= set(params)
    np.testing.assert_allclose(_back(got[0]), np.asarray(ref[0]),
                               atol=NET_ATOL)
    np.testing.assert_allclose(got[1].numpy().transpose(0, 3, 4, 1, 2),
                               np.asarray(ref[1]), atol=NET_ATOL)


def _flags(**over):
    base = dict(loadSize=32, tex_tile=16, n_blocks_translate=1,
                n_downsample_translate=2, n_blocks_global=1,
                n_downsample_global=1, n_blocks_bg=1, n_downsample_bg=1,
                ngf=4, ngf_global=4, dtype="float32", pose_heatmaps=True,
                coord_conv=True, stem_s2d=2, head_s2d=2, bg_s2d=4,
                pad_mode="same", warp_topk=24, warp_eps=0.0, n_blocks_local=1)
    base.update(over)
    return base


OPTIONS = {"local": dict(netG="local"),
           "refine_msuv": dict(uv_refine=1, uv_refine_ngf=8, ms_uv=1),
           "bg_flip": {}}


def _renderer_pair(name, seed=3):
    """The JAX renderer of an option set with perturbed params and the
    port's with them; the shared inputs (NHWC numpy)."""
    jopt, topt = JOptions(**_flags(**OPTIONS[name])), \
        TOptions(**_flags(**OPTIONS[name]))
    syn = SyntheticDataset(topt, length=2)
    pose = np.asarray(jsteps.build_pose_input(
        jopt, jnp.asarray(syn.joints), None))
    tex, bg = syn.texture_atlas(), syn.background()
    jr = j_renderer_from_options(dataclasses.replace(jopt,
                                                     use_pallas_warp=False))
    params = _perturbed(jr.init(jax.random.PRNGKey(seed), jnp.asarray(pose),
                                jnp.asarray(bg)[None],
                                jnp.asarray(tex)[None])["params"], seed)
    model = init_params(renderer_from_options(topt), 0)
    model.load_state_dict(params_from_jax(params), strict=True)
    return jopt, topt, jr, params, model.eval(), syn, pose, tex, bg


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_renderer_options_match_jax(name):
    """The whole renderer with --netG local (TransG and TexG as
    LocalEnhancers, named LocalEnhancer_0), with --uv_refine and --ms_uv
    (ms_aux), and with per-sample bg_flip flags."""
    jopt, topt, jr, params, model, syn, pose, tex, bg = _renderer_pair(name)
    kw_j, kw_t = {}, {}
    if name == "bg_flip":
        flags = np.array([1.0, 0.0], np.float32)
        kw_j["bg_flip"], kw_t["bg_flip"] = jnp.asarray(flags), \
            torch.from_numpy(flags)
    ref = jr.apply({"params": params}, jnp.asarray(pose),
                   jnp.asarray(bg)[None], jnp.asarray(tex)[None], **kw_j)
    with torch.no_grad():
        out = model(_nchw(pose), _nchw(bg[None]), _nchw(tex), **kw_t)
    if name == "local":
        assert "LocalEnhancer_0" in params["TransG"]
        assert "LocalEnhancer_0" in params["TexG"]
    assert sorted(out) == sorted(ref)
    for key in ("fake", "fg", "mask", "probs", "bg_refined"):
        np.testing.assert_allclose(_back(out[key]), np.asarray(ref[key]),
                                   atol=NET_ATOL, err_msg=key)
    np.testing.assert_allclose(out["uv"].numpy().transpose(0, 3, 4, 1, 2),
                               np.asarray(ref["uv"]), atol=NET_ATOL)
    if name == "refine_msuv":
        for (jl, ju), (tl, tu) in zip(ref["ms_aux"], out["ms_aux"]):
            np.testing.assert_allclose(_back(tl), np.asarray(jl),
                                       atol=NET_ATOL)
            np.testing.assert_allclose(tu.numpy().transpose(0, 3, 4, 1, 2),
                                       np.asarray(ju), atol=NET_ATOL)
    if name == "bg_flip":      # sample 0 mirrored, sample 1 as it was
        bgr = out["bg_refined"]
        assert torch.equal(bgr[0], bgr[1].flip(2))


@pytest.mark.parametrize("name", ["local", "refine_msuv"])
def test_jax_checkpoint_serves_through_the_port(name, tmp_path):
    """A G file written by the JAX package's own save_net loads strictly
    through the port's serving loader (build_renderer) and renders the
    JAX package's frames (make_forward_fn on both sides) within 1e-4."""
    jopt, topt, jr, params, _, syn, pose, tex, bg = _renderer_pair(name, 5)
    run = tmp_path / "ckpt" / "run"
    jckpt.save_net(str(run), "G", 3, params)
    topt = dataclasses.replace(topt, checkpoints_dir=str(tmp_path / "ckpt"),
                               name="run", which_epoch="3", gpu_ids="-1")
    model = td.build_renderer(topt, torch.device("cpu"))
    joints = syn.joints
    ref = jsteps.make_forward_fn(dataclasses.replace(
        jopt, use_pallas_warp=False), jr)(
        params, (jnp.asarray(tex), jnp.asarray(bg), None), jnp.asarray(joints))
    out = make_forward_fn(topt, model)(
        td.assets_to_device(topt, tex, bg, torch.device("cpu")),
        torch.from_numpy(joints))
    np.testing.assert_allclose(_back(out["fake"]), np.asarray(ref["fake"]),
                               atol=NET_ATOL)


def _dp(seed, B=2, H=32, W=32):
    """Pseudo-GT with part regions (runs of equal labels) and background,
    UV in [0, 1], a mask; (NHWC for JAX, NCHW for the port)."""
    rng = np.random.default_rng(seed)
    parts = rng.integers(0, 25, (B, H // 4, W // 4))
    parts = np.repeat(np.repeat(parts, 4, 1), 4, 2).astype(np.int32)
    uv = rng.uniform(0, 1, (B, H, W, 2)).astype(np.float32)
    mask = (rng.uniform(0, 1, (B, H, W, 1)) > 0.3).astype(np.float32)
    return parts, uv, mask


def test_uv_grad_loss_matches_jax():
    parts, uv, _ = _dp(0)
    pred = np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 24, 2)) \
        .astype(np.float32)
    ref = float(jrecon.uv_grad_loss(jnp.asarray(pred), jnp.asarray(uv),
                                    jnp.asarray(parts)))
    got = float(trecon.uv_grad_loss(
        torch.from_numpy(pred.transpose(0, 3, 4, 1, 2).copy()), _nchw(uv),
        torch.from_numpy(parts)))
    assert ref > 0
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)


@pytest.mark.parametrize("with_mask", [False, True])
def test_ms_iuv_loss_matches_jax(with_mask):
    """Two aux scales (8 and 16 of 32: strides 4 and 2), the subsampled
    pseudo-GT, with the mask (the UV pretrain) and without (stage 2)."""
    parts, uv, mask = _dp(2)
    rng = np.random.default_rng(3)
    aux_j, aux_t = [], []
    for h in (8, 16):
        lg = rng.standard_normal((2, h, h, 25)).astype(np.float32)
        u = rng.uniform(0, 1, (2, h, h, 24, 2)).astype(np.float32)
        aux_j.append((jnp.asarray(lg), jnp.asarray(u)))
        aux_t.append((_nchw(lg),
                      torch.from_numpy(u.transpose(0, 3, 4, 1, 2).copy())))
    ref = jrecon.ms_iuv_loss(tuple(aux_j), jnp.asarray(uv), jnp.asarray(parts),
                             jnp.asarray(mask) if with_mask else None)
    got = trecon.ms_iuv_loss(tuple(aux_t), _nchw(uv), torch.from_numpy(parts),
                             _nchw(mask) if with_mask else None)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(float(g), float(r), rtol=LOSS_RTOL)
    assert [float(z) for z in trecon.ms_iuv_loss((), _nchw(uv),
                                                 torch.from_numpy(parts))] \
        == [0.0, 0.0]
