"""PyTorch port, the convolutions' memory layout (``models/layers.py``):
each network run with the card's layout (NHWC, channels_last) on the CPU
against the same network run NCHW, in float32 with the same weights and
inputs: each output within 1e-5 of its largest magnitude and every
parameter's gradient within 1e-5 of the largest gradient (oneDNN sums a
conv's products in another order in NHWC). Then space_to_depth /
depth_to_space against the JAX package's channel order in both
layouts, InstanceNorm in both, the weights held
channels_last from construction, every conv of an eager flagship-shaped
stage-2 step counted NHWC, and the warp kernels handed pixel-contiguous
operands with the same launches a step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu.models import layers as jl
from neural_human_video_rendering_tpu_torch.models import layers
from neural_human_video_rendering_tpu_torch.models import generators as tg
from neural_human_video_rendering_tpu_torch.models.discriminator import \
    MultiscaleDiscriminator
from neural_human_video_rendering_tpu_torch.models.vgg import VGG19Features

NHWC = torch.channels_last
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _card_layout(monkeypatch):
    """The card's rule on the CPU: every conv NHWC."""
    monkeypatch.setattr(layers, "layout", lambda x: NHWC)


def _tensors(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return [out]


POSE = 23


def _modules():
    """(name, build(), input shape) of each network at small widths."""
    return {
        "TransG": (lambda: tg.TransG(POSE, 4, 8, 2, 1, stem_s2d=2,
                                     head_s2d=2, pad_mode="same"),
                   (2, POSE, 32, 32)),
        "TransG_reflect_resize_refine_ms": (
            lambda: tg.TransG(POSE, 4, 8, 2, 1, uv_refine=1,
                              uv_refine_ngf=8, ms_uv=1, pad_mode="reflect",
                              upsample_mode="resize"),
            (2, POSE, 32, 32)),
        "TexG": (lambda: tg.TexG(POSE, 4, 16, 8, 1, 1, stem_s2d=2,
                                 head_s2d=2, pad_mode="same"),
                 (2, POSE, 32, 32)),
        "BGNet": (lambda: tg.BGNet(8, 2, 1, s2d=4, pad_mode="same"),
                  (1, 3, 32, 32)),
        "LocalEnhancer": (lambda: tg.LocalEnhancer(
            POSE, 5, 4, 2, 1, 1, 1, stem_s2d=2, pad_mode="same"),
            (2, POSE, 32, 32)),
        "LocalEnhancer_reflect": (lambda: tg.LocalEnhancer(
            POSE, 5, 4, 2, 1, 1, 1, pad_mode="reflect"), (2, POSE, 32, 32)),
        "FeatEncoder": (lambda: tg.FeatEncoder(3, 4, 2), (2, 3, 32, 32)),
        "D": (lambda: MultiscaleDiscriminator(POSE + 3, 32, 2, 8, 3),
              (2, POSE + 3, 32, 32)),
        "D_s2d": (lambda: MultiscaleDiscriminator(POSE + 3, 32, 2, 8, 3,
                                                  stem_s2d=2),
                  (2, POSE + 3, 32, 32)),
        "VGG": (lambda: VGG19Features(), (1, 3, 32, 32)),
    }


def _run(model, x, seed=3):
    """-> (outputs, parameter gradients, conv counts (nhwc, calls)) of one
    forward and a backward of a fixed random projection of the outputs."""
    model.zero_grad(set_to_none=True)
    before = layers.conv_counts()
    outs = _tensors(model(x))
    after = layers.conv_counts()
    g = torch.Generator().manual_seed(seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=g)).sum()
               for o in outs)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    counts = (after[0] - before[0], after[1] - before[1])
    return [o.detach().clone() for o in outs], grads, counts


def _close(got, want, what, scale=None):
    err = float((got - want).abs().max())
    scale = float(want.abs().max()) if scale is None else scale
    assert err <= TOL * max(scale, 1e-30), (what, err, scale)


@pytest.mark.parametrize("name", list(_modules()))
def test_network_in_nhwc_matches_nchw(name, monkeypatch):
    build, shape = _modules()[name]
    torch.manual_seed(0)
    model = build()
    with torch.no_grad():                 # every parameter exercised
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    convs = [m for m in model.modules()
             if isinstance(m, (layers.Conv, layers.ConvTranspose))]
    assert convs and all(layers.is_nhwc(m.weight) for m in convs)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    if name.startswith("VGG") or name == "FeatEncoder":
        x = torch.tanh(x)
    want, want_g, nchw_counts = _run(model, x)
    _card_layout(monkeypatch)
    got, got_g, counts = _run(model, x)
    # on the card's route every conv found both operands NHWC already
    assert counts == (len(convs), len(convs)), counts
    assert nchw_counts[1] == len(convs)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        assert b.is_contiguous(), i
        _close(a, b, f"output {i}")
    # a bias before InstanceNorm has a zero gradient up to rounding: the
    # gradients are held at the scale of the largest
    scale = max(float(g.abs().max()) for g in want_g.values())
    for n, g in want_g.items():
        _close(got_g[n], g, n, scale)
        assert got_g[n].stride() == model.get_parameter(n).stride(), n


@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("fmt", ["nchw", "nhwc"])
def test_space_to_depth_keeps_the_jax_channel_order(f, fmt):
    x = torch.randn(2, 6, 16, 8, generator=torch.Generator().manual_seed(f))
    if fmt == "nhwc":
        x = x.contiguous(memory_format=NHWC)
    nhwc = np.ascontiguousarray(x.permute(0, 2, 3, 1).numpy())
    s2d = layers.space_to_depth(x, f)
    want = np.asarray(jl.space_to_depth(jnp.asarray(nhwc), f))
    np.testing.assert_array_equal(s2d.permute(0, 2, 3, 1).numpy(), want)
    d2s = layers.depth_to_space(s2d, f)
    np.testing.assert_array_equal(
        d2s.permute(0, 2, 3, 1).numpy(),
        np.asarray(jl.depth_to_space(jnp.asarray(want), f)))
    torch.testing.assert_close(d2s, x, rtol=0, atol=0)
    if fmt == "nhwc":
        # one copy each way, the result channels_last
        assert layers.is_nhwc(s2d) and not s2d.is_contiguous()
        assert layers.is_nhwc(d2s) and not d2s.is_contiguous()
    else:
        assert s2d.is_contiguous() and d2s.is_contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_is_the_same_in_both_layouts(dtype):
    x = (torch.randn(2, 16, 12, 10, generator=torch.Generator().manual_seed(4))
         * 3 + 1).to(dtype)
    norm = layers.InstanceNorm()
    want = norm(x)
    got = norm(x.contiguous(memory_format=NHWC))
    assert layers.is_nhwc(got) and not got.is_contiguous()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("fmt", ["nchw", "nhwc"])
def test_centered_instance_norm_holds_a_small_spread(fmt):
    """Over 2x2 pixels whose mean is 300 times their spread, E[x^2] -
    mean^2 loses the variance to float32 rounding; the centered norm
    (E's, ``FeatEncoder``) gives float64's output and gradient."""
    g = torch.Generator().manual_seed(5)
    x = 30.0 + 0.1 * torch.randn(2, 8, 2, 2, generator=g)
    gy = torch.randn(x.shape, generator=g)
    xd = x.double().requires_grad_()
    m = xd.mean(dim=(2, 3), keepdim=True)
    v = ((xd - m) ** 2).mean(dim=(2, 3), keepdim=True)
    want = (xd - m) * torch.rsqrt(v + 1e-5)
    want.backward(gy.double())
    errs = {}
    for centered in (False, True):
        xi = x.clone()
        if fmt == "nhwc":
            xi = xi.contiguous(memory_format=NHWC)
        xi.requires_grad_()
        y = layers.InstanceNorm(centered=centered)(xi)
        y.backward(gy)
        errs[centered] = (float((y.double() - want).abs().max()),
                          float((xi.grad.double() - xd.grad).abs().max()
                                / xd.grad.abs().max()))
    # float32 holds x near 30 to ~2e-6, a fiftieth of the spread's
    # thousandth: the centered norm keeps to that, E[x^2] - mean^2 not
    assert errs[True][0] < 1e-4 and errs[True][1] < 1e-4, errs
    assert errs[False][0] > 1e-2, errs
    e = tg.FeatEncoder(3, 4, 2)
    norms = [n for n in e.modules() if isinstance(n, layers.InstanceNorm)]
    assert len(norms) == 1 + 2 * 2 and all(n.centered for n in norms)
    assert not layers.InstanceNorm().centered


def test_conv_weights_are_channels_last_from_construction():
    from neural_human_video_rendering_tpu_torch.models.renderer import (
        init_params, renderer_from_options)
    from neural_human_video_rendering_tpu_torch.config import Options
    opt = Options(loadSize=32, tex_tile=16, ngf=4, ngf_global=4,
                  n_blocks_translate=1, n_downsample_translate=2,
                  n_blocks_global=1, n_downsample_global=1, n_blocks_bg=1,
                  n_downsample_bg=1, stem_s2d=2, head_s2d=2, bg_s2d=4)
    meta = renderer_from_options(opt)            # built on the meta device
    weights = [p for p in meta.parameters() if p.dim() == 4]
    assert weights and all(layers.is_nhwc(p) and not p.is_contiguous()
                           for p in weights)
    model = init_params(renderer_from_options(opt), 0)
    assert all(layers.is_nhwc(p) for p in model.parameters() if p.dim() == 4)
    # the seeded init draws the same numbers as into NCHW weights
    gen = torch.Generator().manual_seed(0)
    w0 = model.TransG.backbone.ConvNormRelu_0.Conv_0.weight
    ref = torch.empty(w0.shape)
    fan_in = w0.shape[1] * w0.shape[2] * w0.shape[3]
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    torch.nn.init.trunc_normal_(ref, std=std, a=-2 * std, b=2 * std,
                                generator=gen)
    assert torch.equal(w0, ref)


_FLAGSHIP_SMALL = ("--loadSize 32 --tex_tile 16 --ngf 8 --ngf_global 8 "
                   "--ndf 8 --n_layers_D 3 --n_blocks_translate 1 "
                   "--n_downsample_translate 2 --n_blocks_global 1 "
                   "--n_downsample_global 1 --n_blocks_bg 1 "
                   "--n_downsample_bg 2 --stem_s2d 2 --head_s2d 2 "
                   "--bg_s2d 4 --pad_mode same --dtype bfloat16 "
                   "--pose_heatmaps --coord_conv --no_flip --ema_decay 0.999 "
                   "--lambda_L2 500 --lambda_UV 1000 --lambda_Prob 10 "
                   "--lambda_Temp 500 --lambda_Mask 1 --use_densepose_loss "
                   "--temporal_prev real --batchSize 2 --gpu_ids -1").split()


def test_flagship_step_runs_every_conv_nhwc_and_the_warps_as_before(
        monkeypatch):
    """An eager flagship-shaped stage-2 step (the recipe's flags at small
    widths, bf16, D and VGG) with the card's layout on the CPU: every conv
    of the step found its input and weight NHWC; the warp kernels' wrappers
    got operands that pass the card's checks (pixel axis contiguous, g
    contiguous), one fused forward keeping w, one backward and one flow
    warp a step, as in NCHW."""
    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.data.wire import pack_batch
    from neural_human_video_rendering_tpu_torch.ops import \
        flow_warp_kernel as fk
    from neural_human_video_rendering_tpu_torch.ops import texture_warp as ttw
    from neural_human_video_rendering_tpu_torch.ops import \
        texture_warp_kernel as tk
    from neural_human_video_rendering_tpu_torch.train.state import \
        create_train_state
    from neural_human_video_rendering_tpu_torch.train.steps import \
        make_train_step
    opt = TrainOptions().parse(_FLAGSHIP_SMALL, save=False)
    syn = dsm.SyntheticDataset(opt, length=4, seed=opt.seed)
    batch = pack_batch(dsm.collate([syn[0], syn[1]]))
    calls = {"topk_fwd": [], "bwd": 0, "flow": 0}

    def topk_fwd(tex, fg, u, v, k, eps, return_w=False):
        tk._check_cuda_warp("texture_warp_topk_fwd", tex, u, v, fg, sel="fg")
        calls["topk_fwd"].append(return_w)
        return tk.texture_warp_topk_fwd(tex, fg, u, v, k, eps, return_w)

    def bwd(tex, u, v, w, g):
        tk._check_cuda_warp("texture_warp_bwd", tex, u, v, w)
        assert g.dtype == torch.float32 and g.is_contiguous()
        calls["bwd"] += 1
        return tk.texture_warp_bwd(tex, u, v, w, g)

    flow_fwd = fk.flow_warp_fwd

    def flow(img, fl):
        assert img.stride(3) == 1 and fl.stride(3) == 1
        calls["flow"] += 1
        return flow_fwd(img, fl)

    monkeypatch.setattr(ttw, "texture_warp_topk_fwd", topk_fwd)
    monkeypatch.setattr(ttw, "texture_warp_bwd", bwd)
    monkeypatch.setattr(fk, "flow_warp_fwd", flow)
    for rule in ("nchw", "nhwc"):
        if rule == "nhwc":
            _card_layout(monkeypatch)
        st = create_train_state(opt, syn.texture_atlas(), syn.background(),
                                device=torch.device("cpu"))
        step = make_train_step(opt, st.renderer, st.disc, st.vgg, st.g_opt,
                               st.d_opt)
        calls.update(topk_fwd=[], bwd=0, flow=0)
        before = layers.conv_counts()
        metrics = step(st, batch)
        after = layers.conv_counts()
        nhwc, n = after[0] - before[0], after[1] - before[1]
        assert calls == {"topk_fwd": [True], "bwd": 1, "flow": 1}, calls
        assert all(np.isfinite(float(v)) for v in metrics.values())
    # G (TransG, TexG, BGNet) once, D four times (for G's loss, its real
    # features, and D's step on both), the VGG twice (fake and real)
    convs = [sum(isinstance(m, (layers.Conv, layers.ConvTranspose))
                 for m in net.modules())
             for net in (st.renderer, st.disc, st.vgg)]
    assert nhwc == n == convs[0] + 4 * convs[1] + 2 * convs[2], (nhwc, n)
    moments = [s[k] for o in (st.g_opt, st.d_opt) for p, s in o.state.items()
               if p.dim() == 4 for k in ("exp_avg", "exp_avg_sq")]
    assert moments and all(layers.is_nhwc(m) for m in moments)
    assert all(layers.is_nhwc(t) for t in st.g_ema.values() if t.dim() == 4)


def test_a_capture_counts_its_convs_and_prints_them(monkeypatch, capsys):
    """Program keeps each capture's (NHWC, all) conv calls, counted while
    the capture runs the closure (a stand-in here), and its capture line
    prints them; a capture without convs prints none."""
    from neural_human_video_rendering_tpu_torch.train import graphs
    _card_layout(monkeypatch)
    cpu = torch.device("cpu")
    first, second = layers.Conv(3, 8, 3, padding=1), layers.Conv(8, 8, 1)
    norm = layers.InstanceNorm()
    prog = graphs.Program("toy", cpu, stand_in=True)
    x = torch.randn(2, 3, 8, 8)
    out = prog("k", {"x": x}, lambda st: lambda: second(norm(first(
        layers.conv_input(st["x"], x.dtype)))))
    assert out.shape == (2, 8, 8, 8) and layers.is_nhwc(out)
    prog2 = graphs.Program("toy2", cpu, stand_in=True)
    prog2("k", {"x": x}, lambda st: lambda: st["x"] * 2)
    assert prog.convs == [(2, 2)] and prog2.convs == [(0, 0)]
    err = capsys.readouterr().err
    assert "[toy] graphed (stand-in, capture 1: batch 2, 1 segment, " in err
    assert ", nhwc 2/2)" in err
    assert "nhwc" not in err.split("[toy2]")[1]
    assert graphs.capture_line(
        "step", False, 1, 2, 3, 4.5, {"num_ooms": 0, "peak_reserved": 9.9e9},
        (126, 126)) == ("[step] graphed (CUDA graph, capture 1: batch 2, 3 "
                        "segments, 4.50 s, nhwc 126/126, num_ooms 0, peak "
                        "reserved 9.90 GB)")
