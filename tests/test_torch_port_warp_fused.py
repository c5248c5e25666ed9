"""PyTorch port, the texture-warp forward with the selection fused in
(``texture_warp_topk_fwd``) and the dispatcher's two routes, held against
the JAX package on the CPU.

Inputs come from a numpy seed and go through both packages in float32.
The JAX Pallas kernels run in interpret mode on the CPU, as the JAX
package's own tests run them (tile 128, H*W a multiple of 1024; a 64 tile
is zero-padded to 128 and sampled on its own grid, ext=64). On the CPU the
wrapper runs its plain version (topk_select_plain, then
texture_warp_fwd_plain); the kernel itself is held against that on the
card (tests/test_torch_port_cuda.py, chip_smoke.py).
Tolerances: the selection w exactly; warps 2e-6 absolute (a few float32
ulps of values in [-1, 1]); the two dispatcher routes exactly (the same
plain functions in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu.ops import pallas_warp2 as jpw
from neural_human_video_rendering_tpu_torch.ops import texture_warp as ttw
from neural_human_video_rendering_tpu_torch.ops import texture_warp_kernel as tk

WARP_ATOL = 2e-6


def _inputs(B=2, P=24, T=128, H=32, W=32, seed=0, C=3):
    rng = np.random.RandomState(seed)
    tex = (rng.rand(B, P, T, T, C) * 2 - 1).astype(np.float32)
    uv = rng.rand(B, H, W, P, 2).astype(np.float32)
    lg = rng.rand(B, H, W, P + 1).astype(np.float32) * 3
    probs = (np.exp(lg) / np.exp(lg).sum(-1, keepdims=True)).astype(np.float32)
    return tex, uv, probs


def _planes(tex, uv, probs):
    """JAX layout (numpy) -> the port's tex (B, P, C, T, T) and the (B, P,
    N) views fg = probs[:, 1:], u, v of NCHW tensors, as the renderer
    hands them to the kernels."""
    tex_p = torch.from_numpy(np.ascontiguousarray(tex.transpose(0, 1, 4, 2, 3)))
    uv_p = torch.from_numpy(np.ascontiguousarray(uv.transpose(0, 3, 4, 1, 2)))
    probs_p = torch.from_numpy(np.ascontiguousarray(probs.transpose(0, 3, 1, 2)))
    return (tex_p, probs_p[:, 1:].flatten(2), uv_p[:, :, 0].flatten(2),
            uv_p[:, :, 1].flatten(2))


def _hwc(out, H, W):
    """(B, C, N) -> (B, H, W, C) numpy."""
    return out.reshape(out.shape[0], out.shape[1], H, W).permute(0, 2, 3, 1).numpy()


def _tied_fg(B=2, P=7, N=3072, seed=5):
    """Random fg with constructed ties at and around the k-th largest."""
    rng = np.random.RandomState(seed)
    fg = rng.rand(B, P, N).astype(np.float32)
    fg[:, 1:4, ::3] = 0.5           # three-way tie, often at the threshold
    fg[:, 0, ::3] = 0.9
    fg[:, 4:, ::3] = 0.1
    return fg


@pytest.mark.parametrize("k", [3, 4, 24])
@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_topk_fwd_matches_pallas_interpret(k, eps):
    """Both modes against texture_warp_pallas; the kept w equals
    _topk_dense_weights exactly."""
    tex, uv, probs = _inputs(seed=k)
    ref = np.asarray(jpw.texture_warp_pallas(
        jnp.asarray(tex), jnp.asarray(uv), jnp.asarray(probs), k, 0, eps))
    tex_p, fg, u, v = _planes(tex, uv, probs)
    out = tk.texture_warp_topk_fwd(tex_p, fg, u, v, k, eps)
    out_w, w = tk.texture_warp_topk_fwd(tex_p, fg, u, v, k, eps, return_w=True)
    np.testing.assert_allclose(_hwc(out, 32, 32), ref, atol=WARP_ATOL)
    np.testing.assert_array_equal(out_w.numpy(), out.numpy())
    w_ref = np.asarray(jpw._topk_dense_weights(jnp.asarray(fg.numpy()), k, 0, eps))
    np.testing.assert_array_equal(w.numpy(), w_ref)


def test_topk_fwd_small_tile_matches_padded_pallas():
    """A 64 tile sampled directly against the TPU's pad to 128 sampled on
    the (ext-1) grid, boundary texels included."""
    tex, uv, probs = _inputs(P=5, T=64, seed=7)
    uv[0, 0, 0] = 1.0
    uv[0, 0, 1] = 31.0 / 63.0
    tex_pad = np.pad(tex, ((0, 0), (0, 0), (0, 64), (0, 64), (0, 0)))
    ref = np.asarray(jpw.texture_warp_pallas(
        jnp.asarray(tex_pad), jnp.asarray(uv), jnp.asarray(probs), 3, 0, 0.0,
        64))
    tex_p, fg, u, v = _planes(tex, uv, probs)
    out = tk.texture_warp_topk_fwd(tex_p, fg, u, v, 3)
    np.testing.assert_allclose(_hwc(out, 32, 32), ref, atol=WARP_ATOL)


@pytest.mark.parametrize("k", [2, 3])
def test_topk_fwd_ties_widen_the_set(k):
    """Tied fg: w equals _topk_dense_weights exactly (every part tied with
    the k-th largest stays), and the warp equals texture_warp_pallas on
    probs whose foreground is that fg."""
    fg = _tied_fg()
    B, P, N = fg.shape
    H, W = 48, 64
    rng = np.random.RandomState(k)
    tex = (rng.rand(B, P, 128, 128, 3) * 2 - 1).astype(np.float32)
    uv = rng.rand(B, H, W, P, 2).astype(np.float32)
    probs = np.concatenate([np.full((B, 1, N), 0.25, np.float32), fg], 1)
    probs = np.ascontiguousarray(probs.reshape(B, P + 1, H, W).transpose(0, 2, 3, 1))
    tex_p, fg_t, u, v = _planes(tex, uv, probs)
    np.testing.assert_array_equal(fg_t.numpy(), fg)
    out, w = tk.texture_warp_topk_fwd(tex_p, fg_t, u, v, k, return_w=True)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jpw._topk_dense_weights(jnp.asarray(fg), k)))
    assert ((w.numpy()[:, :, ::3] > 0).sum(1) == {2: 4, 3: 7}[k]).all()
    ref = np.asarray(jpw.texture_warp_pallas(
        jnp.asarray(tex), jnp.asarray(uv), jnp.asarray(probs), k))
    np.testing.assert_allclose(_hwc(out, H, W), ref, atol=WARP_ATOL)


@pytest.mark.parametrize("compute_dtype,tex_batch,block_parts", [
    ("float32", 2, 0), ("bfloat16", 2, 0), ("float32", 1, 0),
    ("float32", 2, 3)])
def test_planes_no_grad_route_equals_grad_route(compute_dtype, tex_batch,
                                                block_parts):
    """texture_warp_planes without a gradient (no_grad, inference_mode, or
    no input requiring grad) gives the values of the grad route, with no
    autograd graph; the grad route has one and its backward runs."""
    tex, uv, probs = _inputs(B=2, P=6, T=16, H=32, W=32, seed=3)
    tex_p, _, _, _ = _planes(tex, uv, probs)
    tex_p = tex_p[:tex_batch]
    uv_p = torch.from_numpy(np.ascontiguousarray(uv.transpose(0, 3, 4, 1, 2)))
    probs_p = torch.from_numpy(np.ascontiguousarray(probs.transpose(0, 3, 1, 2)))
    kw = dict(k=3, block_parts=block_parts, eps=1e-3,
              compute_dtype=compute_dtype)
    tk.reset_launch_counts()
    with torch.no_grad():
        a = ttw.texture_warp_planes(tex_p, uv_p, probs_p, **kw)
    with torch.inference_mode():
        b = ttw.texture_warp_planes(tex_p, uv_p, probs_p, **kw)
    c = ttw.texture_warp_planes(tex_p, uv_p, probs_p, **kw)
    leaves = [t.clone().requires_grad_() for t in (tex_p, uv_p, probs_p)]
    d = ttw.texture_warp_planes(*leaves, **kw)
    for got in (a, b, c):
        assert got.grad_fn is None
        assert torch.equal(got, d.detach())
    assert d.grad_fn is not None
    d.square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in leaves)
    assert (tk.topk_select.launches, tk.texture_warp_fwd.launches,
            tk.texture_warp_topk_fwd.launches,
            tk.texture_warp_bwd.launches) == (0, 0, 0, 0)


def test_topk_fwd_refuses_what_the_kernel_does_not_take():
    tex, uv, probs = _inputs(B=1, P=4, T=16, H=8, W=8)
    tex_p, fg, u, v = _planes(tex, uv, probs)
    for k in (0, 5):
        with pytest.raises(ValueError, match="k="):
            tk.texture_warp_topk_fwd(tex_p, fg, u, v, k)
    with pytest.raises(ValueError, match="C <= 4"):
        tk.texture_warp_topk_fwd(tex_p.repeat(1, 1, 2, 1, 1), fg, u, v, 2)
    tex, uv, probs = _inputs(B=1, P=33, T=4, H=8, W=8)
    tex_p, fg, u, v = _planes(tex, uv, probs)
    with pytest.raises(ValueError, match="P <= 32"):
        tk.texture_warp_topk_fwd(tex_p, fg, u, v, 2)
    with pytest.raises(ValueError):           # a texture of another part count
        tk.texture_warp_topk_fwd(tex_p[:, :32], fg, u, v, 2)
