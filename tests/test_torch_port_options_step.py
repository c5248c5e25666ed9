"""PyTorch port, the stage-2 train step with the training options: one
step of the port's make_train_step against the JAX package's on the same
batch with the same weights, for three option groups:
  * the symmetric temporal mode (--no_temporal_detach_prev: t and t-1 in
    one 2B forward, the gradient through the t-1 render and the flow
    warp's backward) with flip (bg_flip flags), the image pool (full, so
    D's fake input mixes history; the JAX package's own draws fed to the
    port's pool_update) and --lambda_UVgrad;
  * --ms_uv with --uv_refine on a crop-mode batch (a background window
    per sample);
  * --netG local.
As in test_torch_port_train_step: every part blended, SGD(1) on both
sides so each parameter's change is its gradient, a linear atlas with
TexG's head conv at zero (texel edges), no VGG. Tolerances: losses 1e-5
relative; parameter deltas per tensor 1e-5 * max|delta| of the module +
1e-4 * max|delta| of the tensor; the pool after the step 1e-4 (the fresh
fakes differ by float32 rounding), its count exactly.

Three JAX step compiles, about 15-25 s each on one core.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neural_human_video_rendering_tpu.config import Options as JOptions
from neural_human_video_rendering_tpu.data import dataset as jds
from neural_human_video_rendering_tpu.train import state as jstate
from neural_human_video_rendering_tpu.train import steps as jsteps
from neural_human_video_rendering_tpu_torch.config import Options as TOptions
from neural_human_video_rendering_tpu_torch.models.bridge import params_from_jax
from neural_human_video_rendering_tpu_torch.train import state as tstate
from neural_human_video_rendering_tpu_torch.train import steps as tsteps
from test_torch_port_train_step import (LOSS_RTOL, STEP_FLAGS, _assert_deltas,
                                        _linear_atlas, _np_tree)

POOL_ATOL = 1e-4
GROUPS = {
    "symmetric_flip_pool_uvgrad": dict(
        temporal_prev="fake", temporal_detach_prev=False, pool_size=3,
        lambda_UVgrad=2.0),
    "msuv_refine_crop": dict(temporal_prev="fake", ms_uv=1, uv_refine=1,
                             uv_refine_ngf=8, lambda_MS=0.3),
    "netg_local": dict(temporal_prev="real", netG="local", n_blocks_local=1),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zero_texg_head(g0):
    """TexG's last conv at zero: the texture stays the linear atlas."""
    texg = g0["TexG"]
    if "LocalEnhancer_0" in texg:
        head = texg["LocalEnhancer_0"]["head"]
    else:
        gen = texg["GlobalGenerator_0"]
        head = gen[max((k for k in gen if k.startswith("ConvNormRelu_")),
                       key=lambda k: int(k.rsplit("_", 1)[1]))]
    head["Conv_0"]["kernel"][...] = 0.0


def _mixed_pool_key(B, K):
    """A pool key whose coins swap some lanes and keep others."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        _, k_coin, _ = jax.random.split(key, 3)
        heads = np.asarray(jax.random.uniform(k_coin, (B,))) < 0.5
        if heads.any() and not heads.all():
            return key
    raise AssertionError("no mixed key")


def _jax_draws(key, B, K):
    """The draws pool_query makes from `key`, as the port's pool_draws
    returns them."""
    k_idx, k_coin, _ = jax.random.split(key, 3)
    return (torch.from_numpy(np.array(jax.random.uniform(k_idx, (B,)))),
            torch.from_numpy(np.array(jax.random.permutation(k_idx, K),
                                      np.int64)),
            torch.from_numpy(np.array(jax.random.uniform(k_coin, (B,)))))


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_option_step_matches_jax(group, tmp_path, monkeypatch):
    flags = dict(STEP_FLAGS, **GROUPS[group], checkpoints_dir=str(tmp_path))
    jopt = JOptions(**flags, use_pallas_warp=False)
    topt = TOptions(**flags, gpu_ids="-1")
    ds = jds.SyntheticDataset(jopt, length=4)
    batch = jds.collate([ds[i] for i in (1, 2)])
    B, S = 2, jopt.train_size
    rng = np.random.default_rng(11)
    if group == "symmetric_flip_pool_uvgrad":
        batch["bg_flip"] = np.array([1.0, 0.0], np.float32)
    if group == "msuv_refine_crop":
        batch["bg"] = np.clip(ds.background()[None] + rng.uniform(
            -0.3, 0.3, (B, 1, 1, 3)), -1, 1).astype(np.float32)
    atlas, bg = _linear_atlas(), ds.background()

    bundle = jstate.create_train_state(jopt, jax.random.PRNGKey(0), atlas, bg)
    g0 = _np_tree(bundle["state"].g_params)
    _zero_texg_head(g0)
    d0 = _np_tree(bundle["state"].d_params)
    sgd = optax.sgd(1.0)
    extra = {}
    if jopt.pool_size:
        K, C = jopt.pool_size, jopt.pose_nc + 3
        hist = rng.uniform(-1, 1, (K, S, S, C)).astype(np.float32)
        key = _mixed_pool_key(B, K)
        extra = dict(pool_buf=jnp.asarray(hist), pool_n=jnp.int32(K),
                     pool_rng=key)
        draws = _jax_draws(key, B, K)
        monkeypatch.setattr(tsteps, "pool_draws", lambda gen, b, k: draws)
    jst0 = bundle["state"].replace(
        g_params=jax.tree.map(jnp.asarray, g0),
        d_params=jax.tree.map(jnp.asarray, d0),
        g_ema=jax.tree.map(jnp.asarray, g0),
        g_opt=sgd.init(g0), d_opt=sgd.init(d0), **extra)
    jstep = jsteps.make_train_step(jopt, bundle["renderer"], bundle["disc"],
                                   None, sgd, sgd)
    jst1, jm = jstep(jst0, {k: jnp.asarray(v) for k, v in batch.items()})

    st = tstate.create_train_state(topt, atlas, bg,
                                   device=torch.device("cpu"))
    st.renderer.load_state_dict(params_from_jax(g0), strict=True)
    st.disc.load_state_dict(params_from_jax(d0), strict=True)
    st.g_ema = {k: v.detach().clone()
                for k, v in st.renderer.named_parameters()}
    if jopt.pool_size:
        st.pool_buf[:K] = torch.from_numpy(hist.transpose(0, 3, 1, 2).copy())
        st.pool_n.fill_(K)
    g_before = {k: v.clone() for k, v in st.renderer.state_dict().items()}
    d_before = {k: v.clone() for k, v in st.disc.state_dict().items()}
    step = tsteps.make_train_step(
        topt, st.renderer, st.disc, None,
        torch.optim.SGD(st.renderer.parameters(), lr=1.0),
        torch.optim.SGD(st.disc.parameters(), lr=1.0))
    tm = step(st, batch)

    assert sorted(tm) == sorted(jm)
    want = {"symmetric_flip_pool_uvgrad": "G_UVgrad",
            "msuv_refine_crop": "G_MSUV", "netg_local": "G_Temp"}[group]
    assert want in tm
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    _assert_deltas("G", st.renderer.state_dict(),
                   params_from_jax(_np_tree(jst1.g_params)), g_before)
    _assert_deltas("D", st.disc.state_dict(),
                   params_from_jax(_np_tree(jst1.d_params)), d_before)
    if jopt.pool_size:
        assert int(st.pool_n) == int(jst1.pool_n) == K
        np.testing.assert_allclose(
            st.pool_buf[:K].numpy().transpose(0, 2, 3, 1),
            np.asarray(jst1.pool_buf), atol=POOL_ATOL)
        # the swapped lanes took a history entry's place
        assert not np.allclose(np.asarray(jst1.pool_buf), hist)
