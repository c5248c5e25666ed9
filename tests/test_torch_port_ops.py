"""PyTorch port, texture-warp ops: the plain versions of the two CUDA
kernels and the reference warps, held against the JAX package.

Inputs come from a numpy seed and go through both packages in float32.
The JAX Pallas kernels run in interpret mode on the CPU, as the JAX
package's own tests run them (tile 128, H*W a multiple of 1024).
Tolerances: the top-k selection is compared for exact equality; warps
at 2e-6 absolute (a few float32 ulps of values in [-1, 1]).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu.ops import pallas_warp2 as jpw
from neural_human_video_rendering_tpu.ops.grid_sample import (
    texture_warp_reference as j_reference, texture_warp_topk as j_topk)
from neural_human_video_rendering_tpu_torch.ops import grid_sample as tgs
from neural_human_video_rendering_tpu_torch.ops import texture_warp as ttw
from neural_human_video_rendering_tpu_torch.ops import texture_warp_kernel as tk

WARP_ATOL = 2e-6


def _inputs(B=2, P=5, T=128, H=32, W=32, seed=0, C=3):
    rng = np.random.RandomState(seed)
    tex = (rng.rand(B, P, T, T, C) * 2 - 1).astype(np.float32)
    uv = rng.rand(B, H, W, P, 2).astype(np.float32)
    lg = rng.rand(B, H, W, P + 1).astype(np.float32) * 3
    probs = (np.exp(lg) / np.exp(lg).sum(-1, keepdims=True)).astype(np.float32)
    return tex, uv, probs


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _tied_fg(B=2, P=7, N=3072, seed=5):
    """Random fg with constructed ties at and around the k-th largest."""
    rng = np.random.RandomState(seed)
    fg = rng.rand(B, P, N).astype(np.float32)
    fg[:, 1:4, ::3] = 0.5           # three-way tie, often at the threshold
    fg[:, 0, ::3] = 0.9
    fg[:, 4:, ::3] = 0.1
    return fg


@pytest.mark.parametrize("k,cap,eps", [
    (3, 0, 0.0), (3, 0, 1e-3), (2, 4, 0.0), (2, 4, 0.3), (7, 2, 0.0),
    (1, 0, 0.0), (7, 0, 0.5)])
def test_topk_plain_matches_dense_weights_and_pallas(k, cap, eps):
    fg = np.random.RandomState(11 + k).rand(2, 7, 3072).astype(np.float32)
    ref = _np(jpw._topk_dense_weights(jnp.asarray(fg), k, cap, eps))
    pal = _np(jpw._topk_call(jnp.asarray(fg).reshape(2, 7, 3, 8, 128), k, cap,
                             eps)).reshape(2, 7, 3072)
    got = _np(tk.topk_select_plain(torch.from_numpy(fg), k, cap, eps))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pal)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        _np(tk.topk_select(torch.from_numpy(fg), k, cap, eps)), ref)


@pytest.mark.parametrize("k,cap", [(3, 0), (2, 0), (2, 3)])
def test_topk_ties_widen_the_set(k, cap):
    fg = _tied_fg()
    ref = _np(jpw._topk_dense_weights(jnp.asarray(fg), k, cap))
    pal = _np(jpw._topk_call(jnp.asarray(fg).reshape(2, 7, 3, 8, 128), k,
                             cap)).reshape(fg.shape)
    got = _np(tk.topk_select_plain(torch.from_numpy(fg), k, cap))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pal)
    if cap == 0:
        # each pass of the max/mask loop removes every value tied with the
        # max: k=2 keeps 0.9 and all three 0.5s, k=3 reaches 0.1 (all 7)
        assert ((got[:, :, ::3] > 0).sum(1) == {2: 4, 3: 7}[k]).all()


def test_topk_wrapper_validates_arguments():
    fg = torch.rand(1, 4, 1000)
    with pytest.raises(ValueError):
        tk.topk_select(fg, 0)
    with pytest.raises(ValueError):
        tk.topk_select(fg, 2, block_parts=2)      # N % 1024 != 0


@pytest.mark.parametrize("k,P,eps", [(3, 5, 0.0), (4, 24, 1e-3), (5, 5, 0.0)])
def test_warp_matches_pallas_interpret(k, P, eps):
    tex, uv, probs = _inputs(P=P, seed=k)
    ref = _np(jpw.texture_warp_pallas(jnp.asarray(tex), jnp.asarray(uv),
                                      jnp.asarray(probs), k, 0, eps))
    got = _np(ttw.texture_warp(torch.from_numpy(tex), torch.from_numpy(uv),
                               torch.from_numpy(probs), k=k, eps=eps))
    np.testing.assert_allclose(got, ref, atol=WARP_ATOL)


def test_warp_small_tile_matches_padded_pallas():
    """The port samples a 64 tile directly; the TPU pads it to 128 and
    samples on the (ext-1) grid. Same values, boundary texels included."""
    tex, uv, probs = _inputs(T=64, seed=7)
    uv[0, 0, 0] = 1.0
    uv[0, 0, 1] = 31.0 / 63.0
    tex_pad = np.pad(tex, ((0, 0), (0, 0), (0, 64), (0, 64), (0, 0)))
    ref = _np(jpw.texture_warp_pallas(jnp.asarray(tex_pad), jnp.asarray(uv),
                                      jnp.asarray(probs), 3, 0, 0.0, 64))
    got = _np(ttw.texture_warp(torch.from_numpy(tex), torch.from_numpy(uv),
                               torch.from_numpy(probs), k=3))
    np.testing.assert_allclose(got, ref, atol=WARP_ATOL)


def test_warp_bf16_texture_matches_pallas_bf16():
    tex, uv, probs = _inputs(P=5, seed=12)
    ref = _np(jpw.texture_warp_pallas(jnp.asarray(tex), jnp.asarray(uv),
                                      jnp.asarray(probs), 3,
                                      compute_dtype="bfloat16"))
    got = _np(ttw.texture_warp(torch.from_numpy(tex), torch.from_numpy(uv),
                               torch.from_numpy(probs), k=3,
                               compute_dtype="bfloat16"))
    np.testing.assert_allclose(got, ref, atol=WARP_ATOL)


@pytest.mark.parametrize("k,eps", [(2, 0.0), (3, 1e-3)])
def test_warp_matches_xla_topk(k, eps):
    tex, uv, probs = _inputs(T=16, H=8, W=12, P=6, seed=3)
    ref = _np(j_topk(jnp.asarray(tex), jnp.asarray(uv), jnp.asarray(probs),
                     k, eps))
    got = _np(ttw.texture_warp(torch.from_numpy(tex), torch.from_numpy(uv),
                               torch.from_numpy(probs), k=k, eps=eps))
    np.testing.assert_allclose(got, ref, atol=WARP_ATOL)


def test_warp_all_parts_matches_reference():
    tex, uv, probs = _inputs(T=16, H=8, W=12, P=6, seed=4)
    ref = _np(j_reference(jnp.asarray(tex), jnp.asarray(uv),
                          jnp.asarray(probs)))
    for k in (0, 6):
        got = _np(ttw.texture_warp(torch.from_numpy(tex), torch.from_numpy(uv),
                                   torch.from_numpy(probs), k=k))
        np.testing.assert_allclose(got, ref, atol=WARP_ATOL)


def test_reference_ops_match_jax():
    tex, uv, probs = _inputs(T=16, H=8, W=12, P=6, seed=9)
    uv[0, 0, 0] = (1.0, 0.0)
    args_j = [jnp.asarray(a) for a in (tex, uv, probs)]
    args_t = [torch.from_numpy(a) for a in (tex, uv, probs)]
    np.testing.assert_allclose(
        _np(tgs.texture_warp_reference(*args_t)),
        _np(j_reference(*args_j)), atol=WARP_ATOL)
    for k, eps in ((3, 0.0), (2, 0.1), (6, 0.0)):
        np.testing.assert_allclose(
            _np(tgs.texture_warp_topk(*args_t, k=k, eps=eps)),
            _np(j_topk(*args_j, k=k, eps=eps)),
            atol=WARP_ATOL, err_msg=f"k={k} eps={eps}")


def test_planes_forward_reads_strided_views_and_broadcast_texture():
    """The renderer's path: fg, u, v as strided channel views of NCHW
    tensors and a batch-1 texture, equal to the JAX-layout call."""
    tex, uv, probs = _inputs(B=2, T=16, H=8, W=12, P=6, seed=2)
    tex[1] = tex[0]
    ref = _np(ttw.texture_warp(torch.from_numpy(tex), torch.from_numpy(uv),
                               torch.from_numpy(probs), k=3))
    tex_p = torch.from_numpy(tex[:1]).permute(0, 1, 4, 2, 3).contiguous()
    uv_p = torch.from_numpy(uv).permute(0, 3, 4, 1, 2).contiguous()
    probs_p = torch.from_numpy(probs).permute(0, 3, 1, 2).contiguous()
    got = ttw.texture_warp_planes(tex_p, uv_p, probs_p, k=3)
    np.testing.assert_array_equal(_np(got.permute(0, 2, 3, 1)), ref)


def test_cpu_path_launches_no_kernel():
    tk.reset_launch_counts()
    tex, uv, probs = _inputs(T=16, H=8, W=8, P=4)
    ttw.texture_warp(torch.from_numpy(tex), torch.from_numpy(uv),
                     torch.from_numpy(probs), k=2)
    assert tk.topk_select.launches == 0
    assert tk.texture_warp_fwd.launches == 0
