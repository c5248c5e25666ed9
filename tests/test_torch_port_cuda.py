"""PyTorch port, CUDA kernels on the card: each kernel against its plain
PyTorch version at small shapes, the launch counters, and the wrappers'
refusals. Marked ``gpu``; every test skips (inside the ``cuda`` fixture)
where torch.cuda.is_available() is False. Run on the card with

    python -m pytest tests/test_torch_port_cuda.py -q

Tolerances: the selection exactly; the forward 2e-5 absolute (float32,
fused multiply-adds on the card).
"""

import pytest
import torch

from neural_human_video_rendering_tpu_torch.ops import texture_warp as ttw
from neural_human_video_rendering_tpu_torch.ops import texture_warp_kernel as tk

pytestmark = pytest.mark.gpu
FWD_TOL = 2e-5


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


def test_dispatcher_launches_each_kernel_once(cuda):
    tex, uv, probs = _inputs(cuda)
    tk.reset_launch_counts()
    out = ttw.texture_warp_planes(tex, uv, probs, k=4, eps=1e-3,
                                  compute_dtype="bfloat16")
    assert (tk.topk_select.launches, tk.texture_warp_fwd.launches) == (1, 1)
    cpu = ttw.texture_warp_planes(tex.cpu(), uv.cpu(), probs.cpu(), k=4,
                                  eps=1e-3, compute_dtype="bfloat16")
    assert float((out.cpu() - cpu).abs().max()) <= FWD_TOL


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
