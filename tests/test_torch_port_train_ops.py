"""PyTorch port, training ops: the texture warp's gradient (the autograd
Function over the backward kernel's plain version), the flow warp and its
gradient, and every loss of the stage-2 step, held against the JAX
package on the same numpy inputs in float32 on the CPU.

The JAX Pallas kernels run in interpret mode, as the JAX package's own
tests run them: a sub-128 texture tile is zero-padded to 128 and sampled
on its own (T-1) grid (``ext=T``), and dtex is cropped back.

Tolerances: warp gradients atol 1e-5 + rtol 1e-5 * max|ref| (du and dv
scale with T-1; float32 sums in another order); the flow warp 2e-6
absolute (values in [-1, 1]) and its gradient 1e-5 + 1e-5 * max|ref|;
losses 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu import losses as JL
from neural_human_video_rendering_tpu.ops.grid_sample import \
    flow_warp as j_flow_warp
from neural_human_video_rendering_tpu.ops import pallas_flow_warp as jpf
from neural_human_video_rendering_tpu.ops import pallas_warp2 as jpw
from neural_human_video_rendering_tpu_torch import losses as TL
from neural_human_video_rendering_tpu_torch.ops import flow_warp_kernel as fk
from neural_human_video_rendering_tpu_torch.ops import grid_sample as tgs
from neural_human_video_rendering_tpu_torch.ops import texture_warp as ttw
from neural_human_video_rendering_tpu_torch.ops import texture_warp_kernel as tk

FLOW_ATOL = 2e-6
LOSS_RTOL = 1e-5


def _close(got, ref, rtol=1e-5, atol=1e-5, msg=""):
    ref = np.asarray(ref)
    tol = atol + rtol * float(np.abs(ref).max(initial=0.0))
    err = float(np.abs(np.asarray(got) - ref).max(initial=0.0))
    assert err <= tol, f"{msg}: max abs err {err:.3e} > {tol:.3e}"


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _warp_inputs(B=2, P=5, T=16, H=32, W=32, seed=0, C=3):
    rng = np.random.RandomState(seed)
    tex = (rng.rand(B, P, T, T, C) * 2 - 1).astype(np.float32)
    uv = rng.rand(B, H, W, P, 2).astype(np.float32)
    uv[0, 0, 0] = (1.0, 0.0)                 # the tile's far border
    lg = rng.rand(B, H, W, P + 1).astype(np.float32) * 6
    probs = (np.exp(lg) / np.exp(lg).sum(-1, keepdims=True)).astype(np.float32)
    g = rng.randn(B, H, W, C).astype(np.float32)
    return tex, uv, probs, g


def _pallas_vjp(tex, uv, probs, g, k, eps):
    """jax.vjp of texture_warp_pallas (interpret mode, tile padded to 128,
    ext = T) -> (out, dtex cropped to T, duv, dprobs)."""
    T = tex.shape[2]
    pad = ((0, 0), (0, 0), (0, 128 - T), (0, 128 - T), (0, 0))
    fn = lambda a, b, c: jpw.texture_warp_pallas(a, b, c, k, 0, eps, T)  # noqa: E731
    out, vjp = jax.vjp(fn, jnp.asarray(np.pad(tex, pad)), jnp.asarray(uv),
                       jnp.asarray(probs))
    dtex, duv, dprobs = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    return np.asarray(out), dtex[:, :, :T, :T], duv, dprobs


def _port_grads(tex, uv, probs, g, k, eps):
    tt, tu, tp = (torch.from_numpy(a).requires_grad_() for a in (tex, uv, probs))
    out = ttw.texture_warp(tt, tu, tp, k=k, eps=eps)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), tt.grad.numpy(), tu.grad.numpy(), tp.grad.numpy()


@pytest.mark.parametrize("k,eps,tex_batch", [
    (4, 0.0, 2), (4, 1e-3, 2), (5, 0.0, 2), (5, 1e-3, 1)])
def test_warp_gradients_match_pallas_vjp(k, eps, tex_batch):
    """dtex, duv and dprobs through the port's autograd Function (its plain
    backward on CPU tensors) against jax.vjp of the Pallas kernel; a
    batch-1 texture gets the gradient summed over the batch."""
    tex, uv, probs, g = _warp_inputs(seed=k)
    if tex_batch == 1:
        tex[1] = tex[0]
    ref = _pallas_vjp(tex, uv, probs, g, k, eps)
    got = _port_grads(tex[:tex_batch], uv, probs, g, k, eps)
    ref_dtex = ref[1].sum(0, keepdims=True) if tex_batch == 1 else ref[1]
    for name, a, b in zip(("out", "dtex", "duv", "dprobs"), got,
                          (ref[0], ref_dtex, ref[2], ref[3])):
        _close(a, b, msg=name)


def test_warp_gradients_with_ties_match_pallas_vjp():
    """Probabilities tied at the k-th largest widen the selection in both."""
    tex, uv, probs, g = _warp_inputs(P=5, seed=9)
    probs[:, ::2, ::3, 1:4] = 0.2            # three-way tie
    probs[:, ::2, ::3, 0] = 0.1
    probs[:, ::2, ::3, 4] = 0.25
    probs[:, ::2, ::3, 5] = 0.05
    ref = _pallas_vjp(tex, uv, probs, g, 2, 0.0)
    got = _port_grads(tex, uv, probs, g, 2, 0.0)
    for name, a, b in zip(("out", "dtex", "duv", "dprobs"), got, ref):
        _close(a, b, msg=name)
    # part 4 and the three tied parts are selected: 4 nonzero dprobs
    assert ((got[3][:, ::2, ::3, 1:] != 0).sum(-1) == 4).all()


@pytest.mark.parametrize("k,eps,tex_batch", [(2, 0.0, 2), (3, 0.05, 1),
                                             (5, 0.0, 2)])
def test_bwd_plain_matches_autograd_of_fwd_plain(k, eps, tex_batch):
    """texture_warp_bwd_plain against torch.autograd through
    texture_warp_fwd_plain on the same selected weights w."""
    tex, uv, probs, g = _warp_inputs(B=2, P=5, T=8, H=6, W=10, seed=3)
    tex_p = torch.from_numpy(np.ascontiguousarray(
        tex[:tex_batch].transpose(0, 1, 4, 2, 3)))
    uv_p = torch.from_numpy(np.ascontiguousarray(uv.transpose(0, 3, 4, 1, 2)))
    fg = torch.from_numpy(np.ascontiguousarray(
        probs[..., 1:].transpose(0, 3, 1, 2))).flatten(2)
    w = tk.topk_select_plain(fg, k, 0, eps)
    u = uv_p[:, :, 0].flatten(2).clone().requires_grad_()
    v = uv_p[:, :, 1].flatten(2).clone().requires_grad_()
    wr = w.clone().requires_grad_()
    tr = tex_p.clone().requires_grad_()
    gp = _nchw(g).flatten(2)
    tk.texture_warp_fwd_plain(tr, u, v, wr).backward(gp)
    duv, dprobs, dtex = tk.texture_warp_bwd_plain(tex_p, u.detach(),
                                                  v.detach(), w, gp)
    _close(duv[:, :, 0], u.grad, msg="du")
    _close(duv[:, :, 1], v.grad, msg="dv")
    _close(dtex, tr.grad, msg="dtex")
    sel = w > 0
    _close(dprobs[:, 1:][sel], wr.grad[sel], msg="dw")
    assert (dprobs[:, 0] == 0).all()
    # the selection is stop-gradient: unselected and sub-eps parts get 0
    assert (dprobs[:, 1:][~sel] == 0).all()
    assert (duv[:, :, 0][~sel] == 0).all() and (duv[:, :, 1][~sel] == 0).all()
    # the wrapper takes the plain version for CPU tensors
    got = tk.texture_warp_bwd(tex_p, u.detach(), v.detach(), w, gp)
    for a, b in zip(got, (duv, dprobs, dtex)):
        assert torch.equal(a, b)


def test_sub_eps_parts_get_exactly_zero_gradient():
    tex, uv, probs, g = _warp_inputs(P=5, seed=4)
    probs[..., 2] = 5e-4                     # below eps everywhere
    _, dtex, duv, dprobs = _port_grads(tex, uv, probs, g, 5, 1e-3)
    assert (dprobs[..., 2] == 0).all() and (dprobs[..., 0] == 0).all()
    assert (duv[..., 1, :] == 0).all()
    assert (dtex[:, 1] == 0).all()


def test_bf16_warp_keeps_a_float32_texture_gradient():
    """--warp_dtype bfloat16 rounds the texture inside the Function; dtex
    is the float32 gradient at the rounded texture (passed straight
    through), not a bf16-rounded one."""
    tex, uv, probs, g = _warp_inputs(P=5, seed=6)
    got = _port_grads(tex, uv, probs, g, 3, 0.0)
    tt = torch.from_numpy(tex).requires_grad_()
    out = ttw.texture_warp(tt, torch.from_numpy(uv), torch.from_numpy(probs),
                           k=3, compute_dtype="bfloat16")
    out.backward(torch.from_numpy(g))
    assert tt.grad.dtype == torch.float32
    # dtex does not depend on the texture's values: equal to the f32 path
    np.testing.assert_array_equal(tt.grad.numpy(), got[1])
    rounded = tex.astype(np.float32)
    rounded = torch.from_numpy(rounded).bfloat16().float()
    ref = ttw.texture_warp(rounded, torch.from_numpy(uv),
                           torch.from_numpy(probs), k=3)
    np.testing.assert_array_equal(out.detach().numpy(), ref.numpy())


def _flow_inputs(B=2, C=5, H=128, W=128, seed=0, scale=8.0):
    rng = np.random.RandomState(seed)
    img = (rng.rand(B, H, W, C) * 2 - 1).astype(np.float32)
    flow = (rng.randn(B, H, W, 2) * scale).astype(np.float32)
    flow[0, :4] = 200.0                      # leaves the image
    flow[1, 5, 7] = (-7.0, -5.0)             # lands exactly on the corner
    return img, flow


def test_flow_warp_matches_pallas_interpret_and_reference():
    img, flow = _flow_inputs()
    ref_pallas = np.asarray(jpf.flow_warp_pallas(jnp.asarray(img),
                                                 jnp.asarray(flow)))
    ref_xla = np.asarray(j_flow_warp(jnp.asarray(img), jnp.asarray(flow)))
    got = tgs.flow_warp_nhwc(torch.from_numpy(img), torch.from_numpy(flow))
    np.testing.assert_allclose(got.numpy(), ref_pallas, atol=FLOW_ATOL)
    np.testing.assert_allclose(got.numpy(), ref_xla, atol=FLOW_ATOL)
    assert (got.numpy()[0, :4] == 0).all()
    # the wrapper and the Function take the plain version for CPU tensors
    fk.reset_launch_counts()
    via = fk.flow_warp(_nchw(img), _nchw(flow))
    assert fk.flow_warp_fwd.launches == 0
    np.testing.assert_array_equal(via.numpy(),
                                  np.moveaxis(got.numpy(), -1, 1))


def test_flow_warp_gradient_matches_jax_vjp():
    img, flow = _flow_inputs(H=24, W=20, seed=1, scale=3.0)
    g = np.random.RandomState(2).randn(*img.shape).astype(np.float32)
    _, vjp = jax.vjp(j_flow_warp, jnp.asarray(img), jnp.asarray(flow))
    dimg, dflow = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    ti = _nchw(img).requires_grad_()
    tf = _nchw(flow).requires_grad_()
    fk.flow_warp(ti, tf).backward(_nchw(g))
    _close(ti.grad.numpy(), np.moveaxis(dimg, -1, 1), msg="dimg")
    _close(tf.grad.numpy(), np.moveaxis(dflow, -1, 1), msg="dflow")
    # the Function's backward is the plain version's VJP
    ti2 = _nchw(img).requires_grad_()
    tgs.flow_warp(ti2, _nchw(flow)).backward(_nchw(g))
    np.testing.assert_array_equal(ti.grad.numpy(), ti2.grad.numpy())


def test_flow_warp_refuses_bad_shapes():
    with pytest.raises(ValueError):
        fk.flow_warp_fwd(torch.zeros(1, 3, 4, 4), torch.zeros(1, 3, 4, 4))


# ----------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------

def _loss_close(got, ref, msg):
    np.testing.assert_allclose(float(got), float(ref), rtol=LOSS_RTOL,
                               atol=1e-7, err_msg=msg)


def _disc_outs(rng, num_d=2, n_layers=2):
    outs = []
    for d in range(num_d):
        feats = [rng.standard_normal((2, 6 >> d, 6 >> d, 4)).astype(np.float32)
                 for _ in range(n_layers)]
        feats.append(rng.standard_normal((2, 3, 3, 1)).astype(np.float32))
        outs.append(feats)
    return outs


@pytest.mark.parametrize("lsgan", [True, False])
def test_gan_losses_match_jax(lsgan):
    rng = np.random.default_rng(0)
    real, fake = _disc_outs(rng), _disc_outs(rng)
    j = lambda o: [[jnp.asarray(f) for f in s] for s in o]  # noqa: E731
    t = lambda o: [[_nchw(f) for f in s] for s in o]        # noqa: E731
    _loss_close(TL.lsgan_loss_g(t(fake), lsgan),
                JL.lsgan_loss_g(j(fake), lsgan), "G")
    _loss_close(TL.lsgan_loss_d(t(real), t(fake), lsgan),
                JL.lsgan_loss_d(j(real), j(fake), lsgan), "D")
    _loss_close(TL.feature_matching_loss(t(real), t(fake), 10.0),
                JL.feature_matching_loss(j(real), j(fake), 10.0), "FM")


def test_recon_losses_match_jax():
    rng = np.random.default_rng(1)
    B, H, W, P = 2, 8, 6, 5
    fake = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    real = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    uv = rng.uniform(0, 1, (B, H, W, P, 2)).astype(np.float32)
    dp_uv = rng.uniform(0, 1, (B, H, W, 2)).astype(np.float32)
    parts = rng.integers(0, P + 1, (B, H, W)).astype(np.int32)
    logits = rng.standard_normal((B, H, W, P + 1)).astype(np.float32)
    mask = rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    gt = (rng.uniform(0, 1, (B, H, W, 1)) > 0.5).astype(np.float32)
    uv_t = torch.from_numpy(np.ascontiguousarray(uv.transpose(0, 3, 4, 1, 2)))
    _loss_close(TL.l2_loss(_nchw(fake), _nchw(real)),
                JL.l2_loss(jnp.asarray(fake), jnp.asarray(real)), "L2")
    _loss_close(TL.uv_loss(uv_t, _nchw(dp_uv), torch.from_numpy(parts)),
                JL.uv_loss(jnp.asarray(uv), jnp.asarray(dp_uv),
                           jnp.asarray(parts)), "UV")
    _loss_close(TL.part_ce_loss(_nchw(logits), torch.from_numpy(parts)),
                JL.part_ce_loss(jnp.asarray(logits), jnp.asarray(parts)),
                "CE")
    _loss_close(TL.part_ce_loss(_nchw(logits), torch.from_numpy(parts),
                                _nchw(gt)),
                JL.part_ce_loss(jnp.asarray(logits), jnp.asarray(parts),
                                jnp.asarray(gt)), "CE masked")
    _loss_close(TL.mask_loss(_nchw(mask), _nchw(gt)),
                JL.mask_loss(jnp.asarray(mask), jnp.asarray(gt)), "mask")


def test_temporal_losses_match_jax():
    rng = np.random.default_rng(2)
    B, H, W = 2, 16, 12
    cur = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    prev = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    flow = (rng.standard_normal((B, H, W, 2)) * 2).astype(np.float32)
    flow_inv = -flow + rng.standard_normal((B, H, W, 2)).astype(np.float32)
    _loss_close(TL.temporal_flow_loss(_nchw(cur), _nchw(prev), _nchw(flow),
                                      _nchw(flow_inv)),
                JL.temporal_flow_loss(jnp.asarray(cur), jnp.asarray(prev),
                                      jnp.asarray(flow), jnp.asarray(flow_inv)),
                "temporal")
