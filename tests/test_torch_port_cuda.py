"""PyTorch port, CUDA kernels on the card: each kernel against its plain
PyTorch version at small shapes, the launch counters, the wrappers'
refusals, a backward through a tiny renderer on the card against the CPU,
a checkpoint saved on the card read on the CPU, a stage-2 resume on the
card, the served program graphed (queued requests sharing a replay),
the image pool's colliding writes on the card against the CPU,
quality_profile's tile sweep through the fused kernel against the plain
warp, a bench_trained_regime window's launches, and the native loader's
worker pool against its plain version on the card's host. Marked
``gpu``; every test skips (inside the ``cuda`` fixture) where
torch.cuda.is_available() is False. Run on the card with

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Tolerances: the selection exactly (also the w that the fused forward
keeps); the forward (with w given or the selection fused in) and the flow warp 2e-5
absolute (float32, fused multiply-adds on the card); the warp backward
1e-5 + 1e-5 * max|plain| (float atomics add dtex in a run-dependent
order); the flow warp of flow channels (tens of pixels) 2e-5 relative; the
renderer's gradients 1e-5 * max|grad| + 1e-4 of each tensor's
largest (cuDNN sums convolutions in another order than the CPU).
"""

import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu_torch.ops import flow_warp_kernel as fk
from neural_human_video_rendering_tpu_torch.ops import texture_warp as ttw
from neural_human_video_rendering_tpu_torch.ops import texture_warp_kernel as tk

pytestmark = pytest.mark.gpu
FWD_TOL = 2e-5
BWD_ATOL, BWD_RTOL = 1e-5, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(dev, B=2, P=7, H=32, W=32, T=16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    probs = torch.softmax(torch.randn((B, P + 1, H, W), generator=g,
                                      device=dev) * 2, dim=1)
    uv = torch.rand((B, P, 2, H, W), generator=g, device=dev)
    uv[0, 0, :, 0, 0] = 1.0                        # the tile's far border
    tex = torch.rand((B, P, 3, T, T), generator=g, device=dev) * 2 - 1
    return tex, uv, probs


@pytest.mark.parametrize("k,cap,eps", [(3, 0, 0.0), (4, 0, 1e-3), (7, 0, 0.0),
                                       (2, 3, 1e-3), (1, 0, 0.1)])
def test_topk_select_matches_plain(cuda, k, cap, eps):
    _, uv, probs = _inputs(cuda)
    fg = probs[:, 1:].flatten(2)                   # strided view
    got = tk.topk_select(fg, k, cap, eps)
    want = tk.topk_select_plain(fg, k, cap, eps)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_topk_select_ties(cuda):
    fg = torch.rand((1, 6, 2048), device=cuda)
    fg[:, 1:4, ::2] = 0.5
    fg[:, 0, ::2] = 0.9
    fg[:, 4:, ::2] = 0.1
    for k in (2, 3):
        assert torch.equal(tk.topk_select(fg, k), tk.topk_select_plain(fg, k))


@pytest.mark.parametrize("T,B_tex", [(16, 2), (64, 1), (128, 2)])
def test_texture_warp_fwd_matches_plain(cuda, T, B_tex):
    tex, uv, probs = _inputs(cuda, T=T)
    tex = tex[:B_tex]
    fg, u, v = probs[:, 1:].flatten(2), uv[:, :, 0].flatten(2), uv[:, :, 1].flatten(2)
    w = tk.topk_select_plain(fg, 3, 0, 1e-3)
    got = tk.texture_warp_fwd(tex, u, v, w)
    want = tk.texture_warp_fwd_plain(tex, u, v, w)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= FWD_TOL


def _launches():
    return (tk.topk_select.launches, tk.texture_warp_fwd.launches,
            tk.texture_warp_topk_fwd.launches, tk.texture_warp_bwd.launches)


def test_dispatcher_launches_each_kernel_once(cuda):
    """Without a gradient one fused launch and no w; with one, the fused
    launch keeps w, and .backward() launches the backward once; the lossy
    block_parts cap takes top-k and the forward with w given."""
    tex, uv, probs = _inputs(cuda, H=64, W=64)
    tk.reset_launch_counts()
    with torch.inference_mode():
        out = ttw.texture_warp_planes(tex, uv, probs, k=4, eps=1e-3,
                                      compute_dtype="bfloat16")
    assert _launches() == (0, 0, 1, 0)
    cpu = ttw.texture_warp_planes(tex.cpu(), uv.cpu(), probs.cpu(), k=4,
                                  eps=1e-3, compute_dtype="bfloat16")
    assert float((out.cpu() - cpu).abs().max()) <= FWD_TOL
    tk.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (tex, uv, probs)]
    out_g = ttw.texture_warp_planes(*leaves, k=4, eps=1e-3,
                                    compute_dtype="bfloat16")
    assert _launches() == (0, 0, 1, 0)
    assert torch.equal(out_g.detach(), out)
    out_g.square().sum().backward()
    assert _launches() == (0, 0, 1, 1)
    tk.reset_launch_counts()
    with torch.no_grad():
        capped = ttw.texture_warp_planes(tex, uv, probs, k=4, block_parts=3)
    assert _launches() == (1, 1, 0, 0)
    want = ttw.texture_warp_planes(tex.cpu(), uv.cpu(), probs.cpu(), k=4,
                                   block_parts=3)
    assert float((capped.cpu() - want).abs().max()) <= FWD_TOL


def _ties(dev, B=2, P=6, H=32, W=64):
    """fg (a strided view of probs) with three-way ties at and around the
    k-th largest on every third pixel."""
    probs = torch.rand((B, P + 1, H, W), device=dev)
    fg = probs[:, 1:].flatten(2)
    fg[:, 1:4, ::3] = 0.5
    fg[:, 0, ::3] = 0.9
    fg[:, 4:, ::3] = 0.1
    return probs


@pytest.mark.parametrize("T,B_tex", [(16, 2), (64, 1), (128, 2)])
@pytest.mark.parametrize("k,eps", [(1, 0.0), (3, 1e-3), (24, 0.0)])
def test_texture_warp_topk_fwd_matches_plain(cuda, T, B_tex, k, eps):
    """Both fused modes against topk_select_plain + texture_warp_fwd_plain
    (P=24, W=37: N is odd), the kept w equal to topk_select's, and two
    calls bit-identical."""
    tex, uv, probs = _inputs(cuda, P=24, H=40, W=37, T=T, seed=T + k)
    tex = tex[:B_tex]
    fg, u, v = probs[:, 1:].flatten(2), uv[:, :, 0].flatten(2), uv[:, :, 1].flatten(2)
    want_w = tk.topk_select_plain(fg, k, 0, eps)
    want = tk.texture_warp_fwd_plain(tex, u, v, want_w)
    tk.reset_launch_counts()
    out = tk.texture_warp_topk_fwd(tex, fg, u, v, k, eps)
    out_w, w = tk.texture_warp_topk_fwd(tex, fg, u, v, k, eps, return_w=True)
    again = tk.texture_warp_topk_fwd(tex, fg, u, v, k, eps)
    assert tk.texture_warp_topk_fwd.launches == 3
    torch.cuda.synchronize()
    assert float((out - want).abs().max()) <= FWD_TOL
    assert float((out_w - want).abs().max()) <= FWD_TOL
    assert torch.equal(w, want_w)
    assert torch.equal(w, tk.topk_select(fg, k, 0, eps))
    assert torch.equal(out, again)


@pytest.mark.parametrize("k", [2, 3])
def test_texture_warp_topk_fwd_ties(cuda, k):
    probs = _ties(cuda)
    tex, uv, _ = _inputs(cuda, P=6, H=32, W=64)
    fg, u, v = probs[:, 1:].flatten(2), uv[:, :, 0].flatten(2), uv[:, :, 1].flatten(2)
    out, w = tk.texture_warp_topk_fwd(tex, fg, u, v, k, return_w=True)
    want_w = tk.topk_select_plain(fg, k)
    torch.cuda.synchronize()
    assert torch.equal(w, want_w)
    assert ((w[:, :, ::3] > 0).sum(1) == {2: 4, 3: 6}[k]).all()
    assert float((out - tk.texture_warp_fwd_plain(tex, u, v, want_w)).abs().max()) \
        <= FWD_TOL


@pytest.mark.parametrize("P", [1, 8, 13, 32])
def test_texture_warp_fwds_part_bounds(cuda, P):
    """Each part bound of the kernels (8, 16, 24, 32) and a single part,
    with w given and with the selection fused in."""
    tex, uv, probs = _inputs(cuda, P=P, T=16, seed=P)
    fg, u, v = probs[:, 1:].flatten(2), uv[:, :, 0].flatten(2), uv[:, :, 1].flatten(2)
    k = min(3, P)
    w = tk.topk_select_plain(fg, k, 0, 0.0)
    want = tk.texture_warp_fwd_plain(tex, u, v, w)
    got = tk.texture_warp_fwd(tex, u, v, w)
    fused = tk.texture_warp_topk_fwd(tex, fg, u, v, k)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= FWD_TOL
    assert float((fused - want).abs().max()) <= FWD_TOL


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    tex, uv, probs = _inputs(cuda)
    fg = probs[:, 1:].flatten(2)
    with pytest.raises(ValueError):
        tk.topk_select(fg.double(), 2)
    with pytest.raises(ValueError):
        tk.topk_select(fg.transpose(1, 2).contiguous().transpose(1, 2), 2)
    w = tk.topk_select(fg, 2)
    with pytest.raises(ValueError):
        tk.texture_warp_fwd(tex.cpu(), uv[:, :, 0].flatten(2),
                            uv[:, :, 1].flatten(2), w)


def test_texture_warp_topk_fwd_refuses_what_the_kernel_does_not_take(cuda):
    tex, uv, probs = _inputs(cuda)
    fg, u, v = probs[:, 1:].flatten(2), uv[:, :, 0].flatten(2), uv[:, :, 1].flatten(2)
    bad = {
        "fg float64": (tex, fg.double(), u, v, 2),
        "fg parts not N apart": (tex, fg.transpose(1, 2).contiguous()
                                 .transpose(1, 2), u, v, 2),
        "u on the CPU": (tex, fg, u.cpu(), v, 2),
        "tex on the CPU": (tex.cpu(), fg, u, v, 2),
        "tex float64": (tex.double(), fg, u, v, 2),
        "u and v strides differ": (tex, fg, u, v.contiguous(), 2),
        "k = 0": (tex, fg, u, v, 0),
        "k > P": (tex, fg, u, v, 8),
        "C = 5": (torch.cat([tex, tex[:, :, :2]], 2), fg, u, v, 2),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            tk.texture_warp_topk_fwd(*args)
            pytest.fail(name)
    tex33, uv33, probs33 = _inputs(cuda, P=33, T=4)
    with pytest.raises(ValueError, match="P <= 32"):
        tk.texture_warp_topk_fwd(tex33, probs33[:, 1:].flatten(2),
                                 uv33[:, :, 0].flatten(2),
                                 uv33[:, :, 1].flatten(2), 2)
    with pytest.raises(ValueError, match="P <= 32"):
        tk.texture_warp_fwd(tex33, uv33[:, :, 0].flatten(2),
                            uv33[:, :, 1].flatten(2),
                            tk.topk_select_plain(probs33[:, 1:].flatten(2), 2))


def _bwd_close(got, want):
    for name, a, b in zip(("duv", "dprobs", "dtex"), got, want):
        tol = BWD_ATOL + BWD_RTOL * float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("k,eps,T,B_tex", [(3, 0.0, 16, 2), (4, 1e-3, 16, 2),
                                           (7, 0.0, 16, 1), (3, 1e-3, 64, 1),
                                           (4, 0.0, 128, 2)])
def test_texture_warp_bwd_matches_plain(cuda, k, eps, T, B_tex):
    tex, uv, probs = _inputs(cuda, T=T)
    tex = tex[:B_tex]
    fg, u, v = probs[:, 1:].flatten(2), uv[:, :, 0].flatten(2), uv[:, :, 1].flatten(2)
    w = tk.topk_select(fg, k, 0, eps)
    g = torch.randn((2, 3, fg.shape[2]), device=cuda)
    tk.reset_launch_counts()
    got = tk.texture_warp_bwd(tex, u, v, w, g)
    assert tk.texture_warp_bwd.launches == 1
    want = tk.texture_warp_bwd_plain(tex, u, v, w, g)
    torch.cuda.synchronize()
    assert got[2].shape == tex.shape
    _bwd_close(got, want)
    sel = w > 0
    assert (got[1][:, 1:][~sel] == 0).all() and (got[1][:, 0] == 0).all()
    assert (got[0][:, :, 0][~sel] == 0).all()


def _smooth_uv(dev, B, P, H, W, seed=0):
    """Renderer-like uv: each part a smooth, slowly turning map that puts
    many neighbouring pixels on one texel (and many lanes of a warp on
    one shared-memory address)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ys = torch.linspace(0, 1, H, device=dev)[:, None].expand(H, W)
    xs = torch.linspace(0, 1, W, device=dev)[None, :].expand(H, W)
    a = torch.rand((B, P, 1, 1), generator=g, device=dev)
    s = 0.05 + 0.2 * torch.rand((B, P, 1, 1), generator=g, device=dev)
    u = (a + s * (xs + 0.3 * torch.sin(6 * ys))).clamp(0, 1)
    v = (1 - a + s * (ys - 0.2 * xs)).clamp(0, 1)
    return torch.stack([u, v], dim=2)


@pytest.mark.parametrize("k,B_tex", [(4, 2), (24, 2), (4, 1)])
def test_texture_warp_bwd_smooth_uv_matches_plain(cuda, k, B_tex):
    """Many pixels per texel: the warp-aggregated shared atomics."""
    P, H, W, T = 24, 96, 96, 16
    tex, _, probs = _inputs(cuda, B=2, P=P, H=H, W=W, T=T)
    uv = _smooth_uv(cuda, 2, P, H, W)
    fg, u, v = probs[:, 1:].flatten(2), uv[:, :, 0].flatten(2), uv[:, :, 1].flatten(2)
    w = tk.topk_select(fg, k, 0, 1e-3)
    g = torch.randn((2, 3, H * W), device=cuda)
    got = tk.texture_warp_bwd(tex[:B_tex], u, v, w, g)
    want = tk.texture_warp_bwd_plain(tex[:B_tex], u, v, w, g)
    torch.cuda.synchronize()
    _bwd_close(got, want)


@pytest.mark.parametrize("H,W,B_tex", [(64, 64, 2), (31, 31, 2), (30, 30, 1)])
def test_texture_warp_bwd_writes_every_element(cuda, H, W, B_tex):
    """The outputs come from torch.empty and no memset: blocks filled with
    NaN and freed first are reused, and no NaN may come out (31 x 31: N is
    odd, so the kernel takes its scalar accesses)."""
    tex, uv, probs = _inputs(cuda, H=H, W=W)
    tex = tex[:B_tex]
    fg, u, v = probs[:, 1:].flatten(2), uv[:, :, 0].flatten(2), uv[:, :, 1].flatten(2)
    w = tk.topk_select(fg, 3, 0, 1e-3)
    g = torch.randn((2, 3, H * W), device=cuda)
    B, P, N = w.shape
    torch.cuda.synchronize()
    nan = [torch.full(s, float("nan"), device=cuda)
           for s in ((B, P, 2, N), (B, P + 1, N), tuple(tex.shape))]
    del nan
    got = tk.texture_warp_bwd(tex, u, v, w, g)
    torch.cuda.synchronize()
    for name, t in zip(("duv", "dprobs", "dtex"), got):
        assert not torch.isnan(t).any(), name
    assert (got[1][:, 0] == 0).all()
    _bwd_close(got, tk.texture_warp_bwd_plain(tex, u, v, w, g))


@pytest.mark.parametrize("W,view", [(48, "contiguous"), (50, "contiguous"),
                                    (48, "channels of cat"),
                                    (50, "channels of cat")])
def test_flow_warp_fwd_widths_and_views(cuda, W, view):
    """W % 4 == 0 and not, on the temporal loss's strided channel views
    (one torch.cat for the image and the flow), against the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(W)
    H = 40
    img = torch.rand((2, 3, H, W), generator=g, device=cuda) * 2 - 1
    flow = torch.randn((2, 2, H, W), generator=g, device=cuda) * 8
    flow[1, :, -4:] = -1000.0                      # leaves the image
    if view == "channels of cat":
        cat = torch.cat([img, flow], dim=1)
        img, flow = cat[:, 1:], cat[:, 3:]
    fk.reset_launch_counts()
    got = fk.flow_warp_fwd(img, flow)
    assert fk.flow_warp_fwd.launches == 1
    want = fk.flow_warp_fwd_plain(img.contiguous(), flow.contiguous())
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) \
        <= FWD_TOL * max(1.0, float(want.abs().max()))
    assert (got[1, :, -4:] == 0).all()


@pytest.mark.parametrize("C,H,W", [(5, 64, 48), (3, 37, 50), (2, 128, 128)])
def test_flow_warp_fwd_matches_plain(cuda, C, H, W):
    g = torch.Generator(device=cuda).manual_seed(C)
    img = torch.rand((2, C, H, W), generator=g, device=cuda) * 2 - 1
    flow = torch.randn((2, 2, H, W), generator=g, device=cuda) * 8
    flow[0, :, :3] = 1000.0                        # leaves the image
    fk.reset_launch_counts()
    got = fk.flow_warp_fwd(img, flow)
    assert fk.flow_warp_fwd.launches == 1
    want = fk.flow_warp_fwd_plain(img, flow)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= FWD_TOL
    assert (got[0, :, :3] == 0).all()
    # a strided channel view, as the temporal loss's 5-channel input
    cat = torch.cat([img, flow], dim=1)[:, 1:]
    want = fk.flow_warp_fwd_plain(cat.contiguous(), flow)
    assert float((fk.flow_warp_fwd(cat, flow) - want).abs().max()) \
        <= FWD_TOL * max(1.0, float(want.abs().max()))


def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    tex, uv, probs = _inputs(cuda)
    fg, u, v = probs[:, 1:].flatten(2), uv[:, :, 0].flatten(2), uv[:, :, 1].flatten(2)
    w = tk.topk_select(fg, 2)
    g = torch.randn((2, 3, fg.shape[2]), device=cuda)
    with pytest.raises(ValueError):
        tk.texture_warp_bwd(tex, u, v, w, g.double())
    with pytest.raises(ValueError):
        tk.texture_warp_bwd(tex, u, v, w, g[:, :2])
    with pytest.raises(ValueError):
        tk.texture_warp_bwd(tex.cpu(), u, v, w, g)
    img = torch.rand((1, 3, 8, 8), device=cuda)
    with pytest.raises(ValueError):
        fk.flow_warp_fwd(img.double(), torch.zeros((1, 2, 8, 8), device=cuda))
    with pytest.raises(ValueError):
        fk.flow_warp_fwd(img.transpose(2, 3), torch.zeros((1, 2, 8, 8),
                                                          device=cuda))
    with pytest.raises(ValueError):
        fk.flow_warp_fwd(img, torch.zeros((1, 2, 8, 8)))


@pytest.mark.parametrize("bad", ["smem short of the layout", "chunk not a "
                                 "multiple of 4", "ranks leave pixels out"])
def test_texture_warp_bwd_refuses_a_bad_launch_plan(cuda, monkeypatch, bad):
    """The C entry point checks the plan it is handed from Python against
    the kernel's own shared-memory layout and windows, and the wrapper
    raises; a good plan still runs afterwards."""
    tex, uv, probs = _inputs(cuda, H=64, W=64)
    fg, u, v = probs[:, 1:].flatten(2), uv[:, :, 0].flatten(2), uv[:, :, 1].flatten(2)
    w = tk.topk_select(fg, 3)
    g = torch.randn((2, 3, fg.shape[2]), device=cuda)
    good = tk.bwd_launch_plan(2, 2, 7, 3, 16, 64 * 64)
    plan = {"smem short of the layout": good._replace(smem=good.smem - 4),
            "chunk not a multiple of 4": good._replace(chunk=good.chunk - 2),
            "ranks leave pixels out": good._replace(chunk=good.chunk // 2),
            }[bad]
    monkeypatch.setattr(tk, "bwd_launch_plan", lambda *args: plan)
    with pytest.raises(RuntimeError, match="texture_warp_bwd"):
        tk.texture_warp_bwd(tex, u, v, w, g)
    monkeypatch.undo()
    _bwd_close(tk.texture_warp_bwd(tex, u, v, w, g),
               tk.texture_warp_bwd_plain(tex, u, v, w, g))


def _linear_atlas(P, T, seed=5):
    yy, xx = np.mgrid[0:T, 0:T].astype(np.float32) / (T - 1)
    coef = np.random.default_rng(seed).uniform(-0.4, 0.4, (P, 3, 2))
    return (coef[:, None, None, :, 0] * xx[None, :, :, None]
            + coef[:, None, None, :, 1] * yy[None, :, :, None]
            ).astype(np.float32)


def test_renderer_backward_on_the_card_matches_cpu(cuda):
    """A backward through a tiny renderer on the card gives TransG's UV head
    (and every other parameter) the gradient it gets on the CPU: the warp
    is differentiable on the card (all parts blended, TF32 off; a linear
    atlas and TexG's head at 0 keep the bilinear gradient continuous at
    texel edges, where float rounding could move a sample across)."""
    from neural_human_video_rendering_tpu_torch.config import Options
    from neural_human_video_rendering_tpu_torch.data.dataset import \
        SyntheticDataset
    from neural_human_video_rendering_tpu_torch.models.renderer import (
        init_params, renderer_from_options)
    from neural_human_video_rendering_tpu_torch.train.steps import \
        build_pose_input
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = Options(loadSize=32, tex_tile=16, n_blocks_translate=1,
                  n_downsample_translate=2, n_blocks_global=1,
                  n_downsample_global=1, n_blocks_bg=1, n_downsample_bg=1,
                  ngf=4, ngf_global=4, dtype="float32", pose_heatmaps=True,
                  coord_conv=True, stem_s2d=2, head_s2d=2, bg_s2d=4,
                  pad_mode="same", warp_topk=24, warp_eps=0.0)
    syn = SyntheticDataset(opt, length=2)
    joints = torch.from_numpy(syn.joints)
    atlas = torch.from_numpy(_linear_atlas(24, 16).transpose(0, 3, 1, 2))
    bg = torch.from_numpy(syn.background().transpose(2, 0, 1))
    cpu = init_params(renderer_from_options(opt), 0)
    texg = cpu.TexG.GlobalGenerator_0
    with torch.no_grad():
        getattr(texg, texg.order[-1]).Conv_0.weight.zero_()
    card = init_params(renderer_from_options(opt), 0).to(cuda)
    card.load_state_dict(cpu.state_dict())
    R = torch.randn((2, 3, 32, 32), generator=torch.Generator().manual_seed(1))
    grads = {}
    tk.reset_launch_counts()
    for name, m, d in (("cpu", cpu, torch.device("cpu")), ("card", card, cuda)):
        out = m(build_pose_input(opt, joints.to(d)), bg[None].to(d),
                atlas[None].to(d))
        (out["fake"] * R.to(d)).sum().backward()
        grads[name] = {k: p.grad.cpu() for k, p in m.named_parameters()}
    assert _launches() == (0, 0, 1, 1)
    scale = max(float(g.abs().max()) for g in grads["cpu"].values())
    for k, ref in grads["cpu"].items():
        err = float((grads["card"][k] - ref).abs().max())
        assert err <= 1e-5 * scale + 1e-4 * float(ref.abs().max()), k
    head = "TransG.GlobalGenerator_0." + \
        cpu.TransG.GlobalGenerator_0.order[-1] + ".Conv_0.weight"
    assert float(grads["card"][head].abs().max()) > 0


_TINY_TRAIN = ("--loadSize 32 --tex_tile 16 --ngf 4 --ngf_global 4 --ndf 4 "
               "--n_layers_D 2 --n_blocks_translate 1 "
               "--n_downsample_translate 2 --n_blocks_global 1 "
               "--n_downsample_global 1 --n_blocks_bg 1 --n_downsample_bg 1 "
               "--stem_s2d 2 --head_s2d 2 --bg_s2d 4 --pad_mode same "
               "--dtype float32 --pose_heatmaps --coord_conv --warp_topk 24 "
               "--warp_eps 0 --no_flip --no_vgg_loss --ema_decay 0.999 "
               "--lambda_L2 500 --lambda_UV 1000 --lambda_Prob 10 "
               "--lambda_Temp 500 --use_densepose_loss --temporal_prev real "
               "--batchSize 8 --print_freq 100 --gpu_ids 0").split()


def test_checkpoint_saved_on_the_card_loads_on_the_cpu(cuda, tmp_path):
    """G saved from the card (save_net moves it to the CPU) loads into a
    CPU renderer bit for bit, and the two forwards agree (all parts
    blended, TF32 off; cuDNN sums in another order than the CPU: 1e-3)."""
    from neural_human_video_rendering_tpu_torch.config import TestOptions
    from neural_human_video_rendering_tpu_torch.data.dataset import \
        SyntheticDataset
    from neural_human_video_rendering_tpu_torch.infer import test_driver as td
    from neural_human_video_rendering_tpu_torch.models.renderer import (
        init_params, renderer_from_options)
    from neural_human_video_rendering_tpu_torch.train.steps import \
        make_forward_fn
    from neural_human_video_rendering_tpu_torch.utils import checkpoint as ckpt
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = TestOptions().parse(_TINY_TRAIN[:-2] + [
        "--checkpoints_dir", str(tmp_path), "--name", "t", "--which_epoch",
        "1"], save=False)
    card = init_params(renderer_from_options(opt), 4).to(cuda)
    ckpt.save_net(opt.run_dir, "G", 1, card.state_dict())
    cpu = td.build_renderer(opt, torch.device("cpu"))
    for k, v in card.state_dict().items():
        assert torch.equal(cpu.state_dict()[k], v.cpu()), k
    syn = SyntheticDataset(opt, length=2)
    outs = {}
    for name, m, d in (("cpu", cpu, torch.device("cpu")),
                       ("card", card.eval(), cuda)):
        outs[name] = make_forward_fn(opt, m)(
            td.assets_to_device(opt, syn.texture_atlas(), syn.background(), d),
            torch.from_numpy(syn.joints).to(d))["fake"].cpu()
    assert float((outs["card"] - outs["cpu"]).abs().max()) <= 1e-3


def test_stage2_resume_on_the_card_is_bit_identical(cuda, tmp_path):
    """A tiny stage-2 run on the card, one epoch, its epoch save, then
    --continue_train into a fresh state: weights, both Adam states and
    counts, the EMA and the step equal the saving run's bit for bit (the
    saving run's state is the straight run's at that point); the resumed
    run then trains on (finite losses, 4 more steps)."""
    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.train.drivers import run_train
    base = _TINY_TRAIN + ["--checkpoints_dir", str(tmp_path), "--name", "r",
                          "--niter", "2", "--no_decay"]
    first = run_train(TrainOptions().parse(base), epochs=1)
    resumed = run_train(TrainOptions().parse(base + ["--continue_train"]),
                        max_steps=0)
    assert resumed.start_epoch == 2 and resumed.step == first.step == 4

    def tensors(st):
        out = {f"G.{k}": v for k, v in st.renderer.state_dict().items()}
        out.update({f"D.{k}": v for k, v in st.disc.state_dict().items()})
        out.update({f"EMA.{k}": v for k, v in st.g_ema.items()})
        for name, o in (("g", st.g_opt), ("d", st.d_opt)):
            assert o.count == 4
            for i, s in o.state_dict()["state"].items():
                out.update({f"{name}.{i}.{k}": v for k, v in s.items()})
        return out

    a, b = tensors(first), tensors(resumed)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].device == b[k].device, k
        assert torch.equal(a[k], b[k]), k
    on = run_train(TrainOptions().parse(base + ["--continue_train"]))
    assert on.step == 8
    assert all(torch.isfinite(v).all() for v in on.metrics.values())


def test_stage2_step_laplace_feat_on_the_card_matches_cpu(cuda):
    """One tiny stage-2 step under train_e2e.sh's --use_laplace
    --instance_feat (--temporal_prev fake: E encodes frame t with gradient
    and image_prev for the detached t-1 render) on the card and on the CPU
    from the same weights, SGD lr 1, TF32 off: the losses within 1e-4
    relative and every parameter's change within 1e-4 * max|change| over
    the net + 1e-3 * max|change| of the tensor (chip_smoke's tiny step).
    E pools over the argmax of the part probabilities: TransG's weights
    are drawn from numpy's generator (seed 0, the same on any torch
    version), which gives every pixel a top-two logit gap of ten times the
    card-CPU difference or more (asserted). TransG's uv outputs are held
    mid-cell (zero weights, one bias) so no sample lies near a texel edge,
    where the bilinear gradient jumps."""
    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.train.state import \
        create_train_state
    from neural_human_video_rendering_tpu_torch.train.steps import (
        build_pose_input, make_train_step)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = TrainOptions().parse(_TINY_TRAIN + [
        "--use_laplace", "--instance_feat", "--nef", "4", "--n_downsample_E",
        "2", "--temporal_prev", "fake", "--batchSize", "2", "--seed", "12"],
        save=False)
    syn = dsm.SyntheticDataset(opt, length=4, seed=opt.seed)
    batch = dsm.collate([syn[i] for i in (1, 2)])
    rng = np.random.default_rng(8)
    batch["laplace"] = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    batch["image_prev"] = np.clip(batch["image"] + rng.normal(
        0, 0.1, batch["image"].shape), -1, 1).astype(np.float32)
    states = {name: create_train_state(opt, syn.texture_atlas(),
                                       syn.background(), device=d)
              for name, d in (("cpu", torch.device("cpu")), ("card", cuda))}
    cpu, card = states["cpu"], states["card"]
    draw = np.random.default_rng(0)
    with torch.no_grad():
        for m in cpu.renderer.TransG.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                w = m.weight
                fan_in = w[0].numel() if isinstance(m, torch.nn.Conv2d) \
                    else w.shape[0] * w.shape[2] * w.shape[3]
                w.copy_(torch.from_numpy((draw.standard_normal(w.shape)
                                          / np.sqrt(fan_in)).astype(np.float32)))
    head = getattr(cpu.renderer.TransG.GlobalGenerator_0,
                   cpu.renderer.TransG.GlobalGenerator_0.order[-1]).Conv_0
    C = opt.transg_out_nc
    uv_out = [k * C + c for k in range(4) for c in range(25, C)]
    with torch.no_grad():
        head.weight[uv_out] = 0.0
        head.bias[uv_out] = float(np.arctanh(2 * 5.5 / 15 - 1))
    card.renderer.load_state_dict(cpu.renderer.state_dict())
    card.disc.load_state_dict(cpu.disc.state_dict())
    lap = torch.from_numpy(batch["laplace"].transpose(0, 3, 1, 2).copy())
    for key in ("joints", "joints_prev"):
        logits = {}
        for name, st in states.items():
            d = st.device
            with torch.no_grad():
                logits[name] = st.renderer.TransG(build_pose_input(
                    opt, torch.from_numpy(batch[key]).to(d), lap.to(d)))[0].cpu()
        diff = float((logits["card"] - logits["cpu"]).abs().max())
        top2 = logits["cpu"].sort(1).values[:, -2:]
        assert float((top2[:, 1] - top2[:, 0]).min()) > 10 * diff, key
    before = {"G": {k: v.clone() for k, v in cpu.renderer.state_dict().items()},
              "D": {k: v.clone() for k, v in cpu.disc.state_dict().items()}}
    metrics = {}
    tk.reset_launch_counts()
    fk.reset_launch_counts()
    for name, st in states.items():
        step = make_train_step(
            opt, st.renderer, st.disc, None,
            torch.optim.SGD(st.renderer.parameters(), lr=1.0),
            torch.optim.SGD(st.disc.parameters(), lr=1.0))
        metrics[name] = {k: float(v) for k, v in step(st, batch).items()}
    assert _launches() == (0, 0, 2, 1) and fk.flow_warp_fwd.launches == 1
    for k, ref in metrics["cpu"].items():
        assert abs(metrics["card"][k] - ref) <= 1e-4 * max(abs(ref), 1e-12), k
    for tag, mods in (("G", (cpu.renderer, card.renderer)),
                      ("D", (cpu.disc, card.disc))):
        b = before[tag]
        ref = {k: v - b[k] for k, v in mods[0].state_dict().items()}
        got = {k: v.cpu() - b[k] for k, v in mods[1].state_dict().items()}
        scale = max(float(d.abs().max()) for d in ref.values())
        for k, d in ref.items():
            err = float((got[k] - d).abs().max())
            assert err <= 1e-4 * scale + 1e-3 * float(d.abs().max()), k
    assert max(float(ref.abs().max()) for k, ref in (
        (k, cpu.renderer.state_dict()[k] - before["G"][k])
        for k in before["G"] if k.startswith("FeatE."))) > 0


def test_evaluate_dirs_on_the_card_matches_cpu(cuda, tmp_path):
    """infer/evaluate on the card against the CPU on the same dirs (LPIPS
    and flicker on): PSNR within 1e-3 dB, SSIM 1e-5, the flicker metrics
    1e-5 relative, the VGG distance and LPIPS 3e-2 relative (the bf16 VGG
    rounds differently on the two devices). 6 frames at batch 4: the
    last batch is padded."""
    import os
    from neural_human_video_rendering_tpu_torch.infer.evaluate import \
        evaluate_dirs
    from neural_human_video_rendering_tpu_torch.utils.image import save_image
    rng = np.random.default_rng(3)
    res, gt = str(tmp_path / "res"), str(tmp_path / "gt")
    os.makedirs(res)
    os.makedirs(gt)
    S = 64
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32) / S
    for i in range(6):
        img = np.stack([np.sin(7 * xx + 0.4 * i), np.cos(5 * yy - 0.3 * i),
                        np.sin(4 * (xx + yy))], -1) * 0.7
        save_image(os.path.join(gt, f"frame{i:05d}.png"), img)
        save_image(os.path.join(res, f"frame{i:05d}_synthesized.png"),
                   np.clip(img + rng.normal(0, 0.1, img.shape), -1, 1))
    kw = dict(size=S, batch_size=4, use_vgg=True, use_lpips=True,
              use_temporal=True)
    card = evaluate_dirs(res, gt, device=cuda, **kw)
    cpu = evaluate_dirs(res, gt, device=torch.device("cpu"), **kw)
    assert set(card) == set(cpu) and card["frames"] == 6
    assert abs(card["psnr"] - cpu["psnr"]) <= 1e-3
    assert abs(card["ssim"] - cpu["ssim"]) <= 1e-5
    for k in ("temporal_l1", "temporal_l1_gt", "flicker_ratio"):
        assert card[k] == pytest.approx(cpu[k], rel=1e-5), k
    for k in ("vgg_dist", "lpips"):
        assert card[k] == pytest.approx(cpu[k], rel=3e-2), k
        assert card[k] > 0, k


def test_pool_update_on_the_card_matches_cpu(cuda):
    """The image pool's writes on the card: swap lanes that draw the same
    slot (B > K) keep the later lane's image, as on the CPU (an index copy
    on the card would race on duplicate indices)."""
    from neural_human_video_rendering_tpu_torch.train.image_pool import \
        pool_update
    B, K, C, S = 6, 2, 26, 64
    results = {}
    for dev in (torch.device("cpu"), cuda):
        pool = torch.zeros((K + 1, C, S, S), device=dev)
        count = torch.zeros((), dtype=torch.int64, device=dev)
        outs = []
        gg = torch.Generator().manual_seed(4)
        for _ in range(3):
            imgs = torch.rand((B, C, S, S), generator=gg).to(dev)
            draws = (torch.rand(B, generator=gg).to(dev), None,
                     torch.zeros(B).to(dev))       # every full lane swaps
            ret, count = pool_update(pool, count, imgs, draws)
            outs.append(ret.cpu())
        results[dev.type] = (outs, pool[:K].cpu(), int(count))
    for a, b in zip(results["cpu"][0], results["cuda"][0]):
        assert torch.equal(a, b)
    assert torch.equal(results["cpu"][1], results["cuda"][1])
    assert results["cpu"][2] == results["cuda"][2] == K


def _op_inputs(dev):
    """Inputs of each nhvr_torch operator (the CPU's own tensors moved to
    `dev`): name -> (op, args, tolerance kind)."""
    g = torch.Generator().manual_seed(5)
    probs = torch.softmax(torch.randn((2, 8, 32, 32), generator=g) * 2, 1)
    uv = torch.rand((2, 7, 2, 32, 32), generator=g)
    tex = torch.rand((2, 7, 3, 16, 16), generator=g) * 2 - 1
    img = torch.randn((2, 5, 24, 40), generator=g)
    flow = 6 * torch.randn((2, 2, 24, 40), generator=g)
    fg_cap = torch.softmax(torch.randn((1, 6, 32, 64), generator=g) * 2,
                           1)[:, 1:].flatten(2)
    probs, uv, tex, img, flow, fg_cap = (t.to(dev) for t in (
        probs, uv, tex, img, flow, fg_cap))
    fg = probs[:, 1:].flatten(2)
    u, v = uv[:, :, 0].flatten(2), uv[:, :, 1].flatten(2)
    w = tk.topk_select_plain(fg, 3, 0, 1e-3)
    gr = torch.randn((2, 3, 1024), generator=torch.Generator().manual_seed(6)
                     ).to(dev)
    ops = torch.ops.nhvr_torch
    return {
        "topk_select": (ops.topk_select.default, (fg, 3, 0, 1e-3), "exact"),
        "topk_select block_parts": (ops.topk_select.default,
                                    (fg_cap, 2, 2, 0.0), "exact"),
        "texture_warp_fwd": (ops.texture_warp_fwd.default, (tex, u, v, w),
                             "fwd"),
        "texture_warp_topk_fwd": (ops.texture_warp_topk_fwd.default,
                                  (tex, fg, u, v, 3, 1e-3, False), "fwd"),
        "texture_warp_topk_fwd keep w": (
            ops.texture_warp_topk_fwd.default,
            (tex[:1], fg, u, v, 3, 1e-3, True), "fwd"),
        "texture_warp_bwd": (ops.texture_warp_bwd.default,
                             (tex, u, v, w, gr), "bwd"),
        "flow_warp_fwd": (ops.flow_warp_fwd.default, (img, flow), "fwd"),
    }


@pytest.mark.parametrize("case", list(_op_inputs(torch.device("cpu"))))
def test_operator_on_cuda_matches_its_cpu_kernel(cuda, case):
    """Each nhvr_torch operator: its CUDA kernel (opcheck on the card:
    the fake kernel's shapes, dtypes and strides against the real one) and
    the same operator on the CPU (the plain version)."""
    op, args, kind = _op_inputs(cuda)[case]
    _, cpu_args, _ = _op_inputs(torch.device("cpu"))[case]
    torch.library.opcheck(op, args)
    tk.reset_launch_counts()
    fk.reset_launch_counts()
    got = op(*args)
    torch.cuda.synchronize()
    assert sum(getattr(tk, n).launches for n in (
        "topk_select", "texture_warp_fwd", "texture_warp_topk_fwd",
        "texture_warp_bwd")) + fk.flow_warp_fwd.launches == 1
    want = op(*cpu_args)
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    for a, b in zip(got, want):
        a = a.cpu()
        assert a.shape == b.shape and a.dtype == b.dtype
        if kind == "exact" or a.numel() == 0:
            assert torch.equal(a, b)
        elif kind == "bwd":
            assert float((a - b).abs().max()) <= \
                BWD_ATOL + BWD_RTOL * float(b.abs().max())
        else:
            assert float((a - b).abs().max()) <= FWD_TOL * max(
                1.0, float(b.abs().max()))


def test_export_serving_on_cuda(cuda, tmp_path):
    """A tiny serving program traced on the card: the fused operator is its
    one warp node, a call launches it once (the trace launched nothing),
    and its frames equal the live forward's."""
    from neural_human_video_rendering_tpu_torch import export_serving as es
    from neural_human_video_rendering_tpu_torch.config import TestOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.infer import test_driver as td
    from neural_human_video_rendering_tpu_torch.train.steps import \
        make_forward_fn
    opt = TestOptions().parse((
        "--loadSize 64 --tex_tile 16 --ngf 8 --ngf_global 8 "
        "--n_blocks_translate 1 --n_downsample_translate 2 "
        "--n_blocks_global 1 --n_downsample_global 1 --n_blocks_bg 1 "
        "--n_downsample_bg 1 --pose_heatmaps --coord_conv --dtype float32 "
        f"--gpu_ids 0 --checkpoints_dir {tmp_path}").split(), save=False)
    tk.reset_launch_counts()
    path = str(tmp_path / "m.pt2")
    es.save_artifact(opt, 2, path)
    assert tk.texture_warp_topk_fwd.launches == 0
    loaded = torch.export.load(path)
    assert [str(n.target) for n in loaded.graph.nodes
            if "nhvr_torch" in str(n.target)] == [
                "nhvr_torch.texture_warp_topk_fwd.default"]
    side = torch.load(path + es.SIDECAR, map_location=cuda, weights_only=True)
    ds = dsm.SyntheticDataset(opt, length=2)
    joints = torch.from_numpy(np.stack([ds[i]["joints"] for i in range(2)])
                              .astype(np.float32)).to(cuda)
    with torch.no_grad():
        got = loaded.module()(side, joints)
    torch.cuda.synchronize()
    assert tk.texture_warp_topk_fwd.launches == 1
    renderer = es.load_weights(opt, es.init_params(
        es.renderer_from_options(opt), opt.seed)).to(cuda).eval()
    live = make_forward_fn(opt, renderer)(td.assets_to_device(
        opt, ds.texture_atlas(), ds.background(), cuda), joints)["fake"]
    want = es.quantize(live).permute(0, 2, 3, 1)
    assert int((got.int() - want.int()).abs().max()) <= 1


def test_jax_run_resumes_on_cuda_as_on_the_cpu(cuda, tmp_path):
    """The committed JAX run dir (testdata/jax_resume_tiny) resumed on the
    card and on the CPU: the same step, epoch, counts and Adam moments."""
    import json
    import os
    import shutil

    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.train import drivers
    from neural_human_video_rendering_tpu_torch.train.state import \
        create_train_state
    fixture = os.path.join(os.path.dirname(tk.__file__), "..", "testdata",
                           "jax_resume_tiny")
    shutil.copytree(fixture, str(tmp_path / "run"))
    with open(tmp_path / "run" / "flags.json") as f:
        fx = json.load(f)
    out = {}
    for name, gpu in (("cpu", "-1"), ("cuda", "0")):
        opt = TrainOptions().parse(fx["argv"] + [
            "--gpu_ids", gpu, "--checkpoints_dir", str(tmp_path), "--name",
            "run", "--continue_train"], save=False)
        P, T, S = opt.n_parts, opt.tex_tile, opt.train_size
        st = create_train_state(opt, np.zeros((P, T, T, 3), np.float32),
                                np.zeros((S, S, 3), np.float32),
                                steps_per_epoch=fx["steps_per_epoch"])
        start = drivers.resume_train(opt, st, fx["steps_per_epoch"])
        assert (start, st.step) == (fx["epoch"] + 1, fx["step"])
        out[name] = st
    for o in ("g_opt", "d_opt"):
        a = getattr(out["cpu"], o).state_dict()
        b = getattr(out["cuda"], o).state_dict()
        assert (a["count"], a["freeze_count"]) == (b["count"],
                                                   b["freeze_count"])
        assert a["state"].keys() == b["state"].keys() and a["state"]
        for i, s in a["state"].items():
            for k, v in s.items():
                assert torch.equal(v, b["state"][i][k].cpu()), (o, i, k)


def test_two_ranks_on_one_card_match_one_rank(cuda, tmp_path):
    """Data parallel on the card (parallel/selfcheck.py): two ranks on
    cuda:0 (gloo: NCCL refuses two ranks on one card), each on 1 sample
    of a fixed global batch of 2, against one rank of 2. One SGD(1) step:
    the losses within 1e-4 relative and the changes of G, D and the EMA
    within the parity tests' form (1e-5 of the largest change + 1e-4 of
    each tensor's); then the ranks' parameters, Adam moments, EMA and pool
    bit-equal after 5 steps of Adam."""
    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.parallel import selfcheck as sc
    from neural_human_video_rendering_tpu_torch.parallel.mesh import \
        DataParallel
    from neural_human_video_rendering_tpu_torch.runtime import launch
    flags = ("--loadSize 32 --tex_tile 16 --ngf 4 --ngf_global 4 --ndf 4 "
             "--n_layers_D 2 --n_blocks_translate 1 --n_downsample_translate "
             "2 --n_blocks_global 1 --n_downsample_global 1 --n_blocks_bg 1 "
             "--n_downsample_bg 1 --dtype float32 --pose_heatmaps "
             "--coord_conv --no_flip --no_vgg_loss --warp_topk 24 "
             "--warp_eps 0 --batchSize 2 --lambda_L2 500 --lambda_UV 1000 "
             "--lambda_Prob 10 --use_densepose_loss --lambda_Temp 500 "
             "--temporal_prev real --ema_decay 0.999 --pool_size 4").split()
    one = TrainOptions().parse(flags + ["--gpu_ids", "0"], save=False)
    two = TrainOptions().parse(flags + ["--gpu_ids", "0,0"], save=False)
    syn = dsm.SyntheticDataset(one, length=12, seed=0)
    batch = dsm.collate([syn[i] for i in (1, 11)])
    atlas = sc.linear_atlas(one.n_parts, one.tex_tile)
    sc.rank_step(one, batch, atlas, syn.background(), str(tmp_path / "one"),
                 5, dp=DataParallel.solo(cuda))
    launch(sc.rank_step, two, batch, atlas, syn.background(),
           str(tmp_path / "two"), 5, where=str(tmp_path), batch=2)
    got = sc.compare(str(tmp_path / "one"), str(tmp_path / "two"))
    assert got["world"] == 2 and got["n_rank_files"] == 2
    assert got["same_loss_keys"] and got["loss_max_rel"] <= 1e-4
    assert max(r["ratio"] for r in got["delta_ratio"].values()) <= 1.0, \
        got["delta_ratio"]
    assert got["ranks_bit_equal"], got["checksums"]


def _plain_warp(tex, uv, probs, k, eps):
    """The renderer's warp through the plain versions (on any device)."""
    B, _, H, W = probs.shape
    tex32, fg, u, v = ttw._operands(tex, uv, probs, "float32")
    w = tk.topk_select_plain(fg, k, 0, eps)
    return tk.texture_warp_fwd_plain(tex32, u, v, w).view(B, -1, H, W)


def test_quality_profile_model_free_on_the_card_matches_plain(cuda):
    """quality_profile's tile sweep (one-hot probabilities, one UV copied
    to every part) through the fused kernel against the plain version on
    the card: 1e-3 dB PSNR and 1e-4 SSIM, one launch a frame and tile."""
    from neural_human_video_rendering_tpu_torch import quality_profile as qp
    from neural_human_video_rendering_tpu_torch.config import Options
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.data import \
        synthetic_video as sv
    S, P, k, eps = 128, 24, 4, 1e-3
    syn = dsm.SyntheticDataset(Options(loadSize=S), length=3, seed=0)
    bg = qp.nchw(sv.background_image(S), cuda)
    atlas = qp.atlas_tensor(sv.part_texture_atlas(P, tile=64), cuda)
    exact = []
    for j in syn.joints:
        onehot, mask, uv = qp.exact_gt(j, S, P, cuda)
        real = qp.compose(mask, qp.gt_warp(_plain_warp, atlas, uv, onehot,
                                           k, eps), bg)
        exact.append((onehot, mask, uv, real))
    tk.reset_launch_counts()
    got = qp.tile_ceiling(exact, bg, (16, 32), P, k, eps)
    torch.cuda.synchronize()
    assert tk.texture_warp_topk_fwd.launches == 2 * len(exact)
    want = qp.tile_ceiling(exact, bg, (16, 32), P, k, eps, _plain_warp)
    for t, ref in want.items():
        assert abs(got[t]["PSNR"] - ref["PSNR"]) <= 1e-3, (t, got, want)
        assert abs(got[t]["SSIM"] - ref["SSIM"]) <= 1e-4, (t, got, want)
        assert 10.0 < ref["PSNR"] < 100.0


def test_bench_trained_regime_window_launches_on_the_card(cuda, monkeypatch):
    """A window of bench_trained_regime at tiny widths on the card: each
    step launches the fused forward twice (keeping w; the t-1 render
    without), the backward and the flow warp once."""
    from neural_human_video_rendering_tpu_torch import bench
    from neural_human_video_rendering_tpu_torch import bench_trained_regime as btr
    opt = bench.bench_options(16, "bfloat16", "0")
    for key, val in dict(loadSize=32, ngf=4, ngf_global=4, ndf=4,
                         n_blocks_translate=1, n_downsample_translate=2,
                         n_blocks_global=1, n_downsample_global=1,
                         n_blocks_bg=1, n_downsample_bg=1,
                         n_layers_D=2).items():
        setattr(opt, key, val)
    seen = []

    def on_window(wi, state, batch):
        torch.cuda.synchronize()
        seen.append({"topk_select": tk.topk_select.launches,
                     "texture_warp_fwd": tk.texture_warp_fwd.launches,
                     "texture_warp_topk_fwd": tk.texture_warp_topk_fwd.launches,
                     "texture_warp_bwd": tk.texture_warp_bwd.launches,
                     "flow_warp_fwd": fk.flow_warp_fwd.launches})
        tk.reset_launch_counts()
        fk.reset_launch_counts()

    tk.reset_launch_counts()
    fk.reset_launch_counts()
    summary, lines = btr.run(opt, cuda, 2, 3, on_window)
    # the first window also holds the untimed first step
    assert seen == [{"topk_select": 0, "texture_warp_fwd": 0,
                     "texture_warp_topk_fwd": 2 * n, "texture_warp_bwd": n,
                     "flow_warp_fwd": n} for n in (4, 3)]
    assert summary["metric"] == "trained_regime_speedup_512px_bs2"
    assert [x["window"] for x in lines] == [0, 1]


def test_native_batcher_on_the_card_host_matches_plain(cuda, tmp_path):
    """The card's host decoding a 1024 px PNG frame to 512 through the
    native loader's worker pool: equal to decode_image_plain on the
    file's pixels in all three modes (skips where the loader does not
    build on that host, which then decodes with OpenCV)."""
    from neural_human_video_rendering_tpu_torch.data import native_loader as nl
    from neural_human_video_rendering_tpu_torch.utils.image import (
        encode_png, read_png)
    if not nl.available():
        pytest.skip(f"native loader unavailable: {nl.unavailable_reason()}")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:1024, 0:1024].astype(np.float32)
    img = np.clip(np.stack([np.sin(xx / 40), np.cos(yy / 60),
                            np.sin((xx + yy) / 90)], -1) * 100 + 128
                  + rng.normal(0, 20, (1024, 1024, 3)), 0, 255).astype(np.uint8)
    path = str(tmp_path / "frame.png")
    with open(path, "wb") as f:
        f.write(encode_png(img))
    pixels = read_png(path)
    for mode in (nl.MODE_RGB, nl.MODE_GRAY, nl.MODE_LABEL):
        b = nl.NativeBatcher([path], 512, mode, threads=4)
        b.submit([0, 0])
        got = b.wait()
        b.close()
        want = nl.decode_image_plain(pixels, 512, mode)
        for item in got:
            np.testing.assert_array_equal(item, want)


def test_graphed_step_matches_eager_on_the_card(cuda, capsys):
    """make_train_step's graphed route (train/graphs.py) against its eager
    route (a call with a mark) from one tiny state, cuDNN deterministic.
    One SGD(1) step: the losses within 1e-5 relative and the changes of
    G, D and the EMA (the gradients) within the parity tests' form (1e-5
    of the largest change + 1e-4 of each tensor's). Then 4 steps with the
    state's own Adam, the EMA and the pool: step 1's losses within 1e-5,
    every graphed update (Adam, the EMA) equal to the eager update on the
    graph's own gradients (two runs' gradients differ in the last bits:
    texture_warp_bwd's float atomics, which Adam turns into different
    steps), the pool's count and generator equal, each replay counting
    the eager step's launches, one capture a batch shape."""
    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.data.wire import pack_batch
    from neural_human_video_rendering_tpu_torch.kernel_ab import \
        graphed_update_err
    from neural_human_video_rendering_tpu_torch.parallel.selfcheck import \
        delta_ratio
    from neural_human_video_rendering_tpu_torch.train.state import \
        create_train_state
    from neural_human_video_rendering_tpu_torch.train.steps import \
        make_train_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    opt = TrainOptions().parse(_TINY_TRAIN + ["--batchSize", "2",
                                              "--pool_size", "4"], save=False)
    syn = dsm.SyntheticDataset(opt, length=9, seed=opt.seed)
    batches = [pack_batch(dsm.collate([syn[2 * i], syn[2 * i + 1]]))
               for i in range(4)]

    def state(start=None):
        st = create_train_state(opt, syn.texture_atlas(), syn.background(),
                                device=cuda)
        if start is not None:
            st.renderer.load_state_dict(start["G"])
            st.disc.load_state_dict(start["D"])
            st.g_ema = {k: v.clone() for k, v in start["EMA"].items()}
            st.pool_gen.set_state(start["gen"])
        return st

    def snap(st):
        return {"G": {k: v.clone() for k, v in st.renderer.state_dict().items()},
                "D": {k: v.clone() for k, v in st.disc.state_dict().items()},
                "EMA": {k: v.clone() for k, v in st.g_ema.items()},
                "gen": st.pool_gen.get_state()}

    eager_kw = {"mark": lambda n: None}
    try:
        # one SGD(1) step each route: the gradients
        sgd, start = {}, None
        for name in ("eager", "graphed"):
            st = state(start)
            start = start or snap(st)
            step = make_train_step(
                opt, st.renderer, st.disc, None,
                torch.optim.SGD(st.renderer.parameters(), lr=1.0),
                torch.optim.SGD(st.disc.parameters(), lr=1.0))
            m = step(st, batches[0], **({} if name == "graphed" else eager_kw))
            sgd[name] = ({k: float(v) for k, v in m.items()}, snap(st))
        for k, v in sgd["eager"][0].items():
            assert abs(sgd["graphed"][0][k] - v) <= 1e-5 * max(abs(v), 1e-12)
        for tag in ("G", "D", "EMA"):
            got, want = sgd["graphed"][1][tag], sgd["eager"][1][tag]
            r = delta_ratio({k: (v - start[tag][k]).cpu() for k, v in got.items()},
                            {k: (v - start[tag][k]).cpu() for k, v in want.items()},
                            1e-5, 1e-4)
            assert r["ratio"] <= 1.0, (tag, r)
        # the state's Adam, the EMA and the pool: 4 steps each route
        runs, states = {}, {}
        for name in ("eager", "graphed"):
            st = state(start)
            step = make_train_step(opt, st.renderer, st.disc, None,
                                   st.g_opt, st.d_opt)
            tk.reset_launch_counts()
            fk.reset_launch_counts()
            losses, errs = [], []
            for b in batches:
                if name == "graphed":
                    m, err = graphed_update_err(torch, st, step, b,
                                                opt.ema_decay)
                    errs.append(err)
                else:
                    m = step(st, b, **eager_kw)
                losses.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            runs[name] = (losses, errs, _launches(),
                          fk.flow_warp_fwd.launches)
            states[name] = (st, step)
    finally:
        torch.backends.cudnn.deterministic = det
    (e, _), (g, gstep) = states["eager"], states["graphed"]
    assert gstep.program.captures == 1
    assert "[step] graphed (CUDA graph" in capsys.readouterr().err
    assert runs["graphed"][2:] == runs["eager"][2:] == ((0, 0, 4, 4), 4)
    assert runs["graphed"][1] == [0.0] * 4, runs["graphed"][1]
    first_e, first_g = runs["eager"][0][0], runs["graphed"][0][0]
    assert sorted(first_e) == sorted(first_g)
    for k, v in first_e.items():
        assert abs(first_g[k] - v) <= 1e-5 * max(abs(v), 1e-12), k
    assert int(e.pool_n) == int(g.pool_n) == 4
    assert torch.equal(e.pool_gen.get_state(), g.pool_gen.get_state())
    assert e.step == g.step == int(g.step_t) == 4


def test_graphed_forward_matches_eager_on_the_card(cuda):
    """make_forward_fn's graphed route against its eager forward at a tiny
    config: the frames bit for bit at batch 3, then at batch 1 (its own
    capture) and batch 3 again (a replay); one fused launch a replay."""
    from neural_human_video_rendering_tpu_torch.config import TestOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.models.renderer import (
        init_params, renderer_from_options)
    from neural_human_video_rendering_tpu_torch.train.steps import \
        make_forward_fn
    opt = TestOptions().parse(_TINY_TRAIN, save=False)
    syn = dsm.SyntheticDataset(opt, length=3, seed=1)
    renderer = init_params(renderer_from_options(opt), 0).to(cuda).eval()
    fwd = make_forward_fn(opt, renderer)
    assets = (torch.from_numpy(np.ascontiguousarray(
        syn.texture_atlas().transpose(0, 3, 1, 2))).to(cuda),
        torch.from_numpy(np.ascontiguousarray(
            syn.background().transpose(2, 0, 1))).to(cuda), None)
    j3 = torch.from_numpy(np.stack([syn[i]["joints"] for i in range(3)]))
    for joints in (j3, j3[:1], j3.to(cuda)):
        want = fwd.eager(assets, joints.to(cuda))
        tk.reset_launch_counts()
        got = fwd(assets, joints)
        torch.cuda.synchronize()
        assert _launches() == (0, 0, 1, 0)
        for k in ("fake", "fg", "mask", "uv", "probs"):
            assert torch.equal(got[k], want[k]), k
    assert fwd.program.captures == 2


def _pretrain_case(kind, opt, dev):
    """(net, make_step(net, optimizer), packed batches of 2) of a tiny
    pretrain step of ``kind`` (uv: TransG; tex: TexG with part textures,
    a pose texture, static_tex and tex_mask) on ``dev``."""
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.data.wire import pack_batch
    from neural_human_video_rendering_tpu_torch.models.generators import TexG
    from neural_human_video_rendering_tpu_torch.models.renderer import (
        init_params, renderer_from_options)
    from neural_human_video_rendering_tpu_torch.train.steps import (
        make_pretrain_tex_step, make_pretrain_uv_step)
    syn = dsm.SyntheticDataset(opt, length=6, seed=opt.seed)
    samples = [syn[i] for i in range(6)]
    if kind == "uv":
        net = init_params(renderer_from_options(opt), 1).TransG.to(dev)

        def make(n, o):
            return make_pretrain_uv_step(opt, n, o)
    else:
        rng = np.random.default_rng(4)
        static = np.clip(syn.texture_atlas() * 0.5, -1, 1).astype(np.float32)
        for i, s in enumerate(samples):
            s["part_texture"] = np.clip(static + 0.1 * np.sin(0.3 * i), -1,
                                        1).astype(np.float32)
            s["pose_texture"] = rng.uniform(-1, 1, static.shape).astype(
                np.float32)
        mask = (np.abs(static + 1.0).sum(-1, keepdims=True) > 0.05).astype(
            np.float32)

        def nchw(a):
            return torch.from_numpy(np.ascontiguousarray(
                np.moveaxis(a, -1, -3))).to(dev)

        torch.manual_seed(2)
        net = TexG(opt.pose_nc, opt.n_parts, opt.tex_tile, opt.ngf_global,
                   opt.n_downsample_global, opt.n_blocks_global, stem_s2d=2,
                   head_s2d=2, pad_mode="same").to(dev)
        tex_t, mask_t = nchw(static), nchw(mask)

        def make(n, o):
            return make_pretrain_tex_step(opt, n, o, tex_t, mask_t)
    batches = [pack_batch(dsm.collate(samples[2 * i:2 * i + 2]))
               for i in range(3)]
    return net, make, batches


@pytest.mark.parametrize("kind", ["uv", "tex"])
def test_graphed_pretrain_step_matches_eager_on_the_card(cuda, kind, capsys):
    """make_pretrain_uv_step / make_pretrain_tex_step's graphed route
    against its eager route (a call with a mark) from one tiny start,
    cuDNN deterministic. One SGD(1) step: the losses within 1e-5 relative
    and the parameter changes (the gradients) within the parity tests'
    form. Then 3 steps of the run's ScheduledAdam: step 1's losses within
    1e-5, every graphed update equal to the eager update on the graph's
    own gradients, the counts equal, one capture, no caught
    out-of-memory error, no kernel launched."""
    import copy

    from neural_human_video_rendering_tpu_torch.config import TrainOptions
    from neural_human_video_rendering_tpu_torch.kernel_ab import \
        graphed_update_err
    from neural_human_video_rendering_tpu_torch.parallel.selfcheck import \
        delta_ratio
    from neural_human_video_rendering_tpu_torch.train.state import (
        PretrainState, make_optimizer)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    opt = TrainOptions().parse(_TINY_TRAIN + ["--batchSize", "2", "--niter",
                                              "1", "--niter_decay", "2"],
                               save=False)
    net0, make, batches = _pretrain_case(kind, opt, cuda)
    start = {k: v.detach().clone() for k, v in net0.state_dict().items()}
    eager_kw = {"mark": lambda n: None}
    try:
        sgd = {}
        for name in ("eager", "graphed"):
            net = copy.deepcopy(net0)
            o = torch.optim.SGD(net.parameters(), lr=1.0)
            st = PretrainState(step=0, net=net, optimizer=o, device=cuda)
            step = make(net, o)
            m = step(st, batches[0], **({} if name == "graphed" else eager_kw))
            sgd[name] = ({k: float(v) for k, v in m.items()},
                         {k: (v - start[k]).cpu()
                          for k, v in net.state_dict().items()})
        for k, v in sgd["eager"][0].items():
            assert abs(sgd["graphed"][0][k] - v) <= 1e-5 * max(abs(v), 1e-12)
        r = delta_ratio(sgd["graphed"][1], sgd["eager"][1], 1e-5, 1e-4)
        assert r["ratio"] <= 1.0, r
        runs = {}
        for name in ("eager", "graphed"):
            net = copy.deepcopy(net0)
            o = make_optimizer(opt, net.named_parameters(), len(batches))
            st = PretrainState(step=0, net=net, optimizer=o, device=cuda)
            step = make(net, o)
            tk.reset_launch_counts()
            fk.reset_launch_counts()
            losses, errs = [], []
            for b in batches:
                if name == "graphed":
                    m, err = graphed_update_err(torch, st, step, b)
                    errs.append(err)
                else:
                    m = step(st, b, **eager_kw)
                losses.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            runs[name] = (losses, errs, st, step,
                          _launches() + (fk.flow_warp_fwd.launches,))
    finally:
        torch.backends.cudnn.deterministic = det
    (le, _, se, _, ne), (lg, eg, sg, gstep, ng) = runs["eager"], \
        runs["graphed"]
    name = f"pretrain_{kind}"
    assert gstep.program.captures == 1 and gstep.program.num_ooms == 0
    assert f"[{name}] graphed (CUDA graph" in capsys.readouterr().err
    assert eg == [0.0] * 3, eg
    assert ne == ng == (0, 0, 0, 0, 0)
    for k, v in le[0].items():
        assert abs(lg[0][k] - v) <= 1e-5 * max(abs(v), 1e-12), k
    assert se.step == sg.step == 3
    assert se.optimizer.count == sg.optimizer.count == 3
    assert se.optimizer.freeze_count == sg.optimizer.freeze_count == 3


def test_graphed_served_program_matches_eager_on_the_card(cuda, tmp_path,
                                                          capsys):
    """serve._Model on the card: the exported program graphed at its batch
    (3; the sidecar held by the capture), a request of 1 and one of 3
    replaying the one capture, their frames bit-equal to the module's
    eager call on the same padded joints, one fused launch a request."""
    from neural_human_video_rendering_tpu_torch import export_serving as es
    from neural_human_video_rendering_tpu_torch import serve as srv
    from neural_human_video_rendering_tpu_torch.config import TestOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    opt = TestOptions().parse((
        "--loadSize 64 --tex_tile 16 --ngf 8 --ngf_global 8 "
        "--n_blocks_translate 1 --n_downsample_translate 2 "
        "--n_blocks_global 1 --n_downsample_global 1 --n_blocks_bg 1 "
        "--n_downsample_bg 1 --pose_heatmaps --coord_conv --dtype float32 "
        f"--gpu_ids 0 --checkpoints_dir {tmp_path}").split(), save=False)
    path = str(tmp_path / "m.pt2")
    es.save_artifact(opt, 3, path)
    model = srv._Model(path, cuda)
    assert model.program is not None and model.program.captures == 1
    assert model.program.num_ooms == 0
    ds = dsm.SyntheticDataset(opt, length=3)
    joints = np.stack([ds[i]["joints"] for i in range(3)]).astype(np.float32)
    for n in (1, 3):
        padded = np.concatenate([joints[:n]] + [joints[n - 1:n]] * (3 - n))
        want = model.forward(torch.from_numpy(padded).to(cuda))[:n].cpu()
        tk.reset_launch_counts()
        got = model.render(joints[:n])
        assert _launches() == (0, 0, 1, 0)
        np.testing.assert_array_equal(got, want.numpy())
    assert model.program.captures == 1
    assert "[serve] graphed (CUDA graph, 1 capture)" in capsys.readouterr().err


def test_queued_requests_share_a_graphed_replay_on_the_card(cuda, tmp_path):
    """serve._Model on the card at batch 3: while a one-frame request holds
    the device, two one-frame requests queue from their own threads and
    then ride in one replay of the one capture (serve.device's rid the
    pair's ids), one fused warp launch a replay; each request's frames
    bit-equal to its joints rendered alone."""
    import threading
    import time

    from neural_human_video_rendering_tpu_torch import export_serving as es
    from neural_human_video_rendering_tpu_torch import serve as srv
    from neural_human_video_rendering_tpu_torch.config import TestOptions
    from neural_human_video_rendering_tpu_torch.data import dataset as dsm
    from neural_human_video_rendering_tpu_torch.utils import spans
    opt = TestOptions().parse((
        "--loadSize 64 --tex_tile 16 --ngf 8 --ngf_global 8 "
        "--n_blocks_translate 1 --n_downsample_translate 2 "
        "--n_blocks_global 1 --n_downsample_global 1 --n_blocks_bg 1 "
        "--n_downsample_bg 1 --pose_heatmaps --coord_conv --dtype float32 "
        f"--gpu_ids 0 --checkpoints_dir {tmp_path}").split(), save=False)
    path = str(tmp_path / "m.pt2")
    es.save_artifact(opt, 3, path)
    model = srv._Model(path, cuda)
    ds = dsm.SyntheticDataset(opt, length=3)
    joints = np.stack([ds[i]["joints"] for i in range(3)]).astype(np.float32)
    call = model._call
    holding, go = threading.Event(), threading.Event()

    def gated(padded, n):              # the first request holds the device
        if not go.is_set():
            holding.set()
            assert go.wait(60)
        return call(padded, n)

    model._call = gated
    out = [None] * 3

    def request(i):
        out[i] = model.render(joints[i:i + 1])

    spans.clear()
    tk.reset_launch_counts()
    threads = [threading.Thread(target=request, args=(0,))]
    threads[0].start()
    assert holding.wait(60)
    with spans.recording():
        for i in (1, 2):
            threads.append(threading.Thread(target=request, args=(i,)))
            threads[-1].start()
            deadline = time.monotonic() + 60
            while len(model.pending) < i:
                assert time.monotonic() < deadline
                time.sleep(0.001)
        go.set()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
    assert _launches() == (0, 0, 2, 0)      # the holder's replay, the pair's
    rids = sorted(r.attrs["rid"] for r in spans.records("serve.request"))
    dev, = spans.records("serve.device")
    assert dev.attrs["rid"] == tuple(rids)
    spans.clear()
    for i in range(3):
        alone = model.render(joints[i:i + 1])
        assert out[i].dtype == np.uint8 and out[i].shape == alone.shape
        np.testing.assert_array_equal(out[i], alone)
    assert model.program.captures == 1


def test_a_capture_that_caught_an_out_of_memory_error_is_refused(cuda):
    """A conv's Program (batch 8, 128 channels, 128^2, 5x5, float32) taken
    while a blocking tensor leaves less free memory than cuDNN's first
    plan asks as workspace (9.20 GB on the H100)
    (graph_memory_probe.blocked_capture): graphs.CaughtOutOfMemory,
    naming the conv's line, with a count above 0, and nothing stored; the
    blocker freed, the same closure at a fresh shape captures with no
    caught error and replays bit-equal to its eager call."""
    import re

    from neural_human_video_rendering_tpu_torch.parallel import \
        graph_memory_probe as gmp
    got = gmp.blocked_capture(torch, cuda)
    first = (got["refusal"] or "").splitlines()[0] if got["refusal"] else ""
    caught = re.search(r"refused: (\d+) out-of-memory error", first)
    assert caught is not None and int(caught.group(1)) > 0, got
    assert got["conv_line"] in first, first
    assert "arithmetic would depend on the memory free" in got["refusal"]
    assert got["entries_after_refusal"] == 0
    assert got["clean_num_ooms"] == 0 and got["captures"] == 1
    assert got["bit_equal"]
