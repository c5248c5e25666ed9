"""PyTorch port, the kernels as torch operators and the serving export:
``torch.library.opcheck`` on each ``nhvr_torch::`` operator at small
shapes and each equal to its plain function; ``export_serving``'s
programs (weights baked, and weights as an input with the ``.params``
sidecar) reloaded and held against the live forward; the graph's
operator nodes; the program's size against its sidecar; and the port's
export against the JAX tool's ``build_exported`` at the same tiny config
with the JAX weights carried across.

Tolerances: the operators equal their plain functions exactly (the CPU
kernel is the plain function); a reloaded program equals the program it
was saved from and the live forward exactly (float32 and uint8: the same
operations on the same CPU); the sidecar in bfloat16 under --dtype
bfloat16 gives the same frames exactly (every conv casts its weight to
the bfloat16 activations). Against JAX, uint8 frames within 1 level
(float32 convolutions summed in another order move a rounding boundary),
with every part blended (--warp_topk 24 --warp_eps 0: a top-k among
near-equal random-init probabilities flips on rounding).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu_torch import export_serving as es
from neural_human_video_rendering_tpu_torch.config import TestOptions
from neural_human_video_rendering_tpu_torch.data import dataset as dsm
from neural_human_video_rendering_tpu_torch.infer import test_driver as td
from neural_human_video_rendering_tpu_torch.ops import flow_warp_kernel as fk
from neural_human_video_rendering_tpu_torch.ops import \
    texture_warp_kernel as tk
from neural_human_video_rendering_tpu_torch.train.steps import make_forward_fn

TINY = ("--loadSize 32 --tex_tile 16 --ngf 4 --ngf_global 4 "
        "--n_blocks_translate 1 --n_downsample_translate 2 "
        "--n_blocks_global 1 --n_downsample_global 1 --n_blocks_bg 1 "
        "--n_downsample_bg 1 --stem_s2d 2 --head_s2d 2 --bg_s2d 4 "
        "--pad_mode same --pose_heatmaps --coord_conv --dtype float32 "
        "--gpu_ids -1").split()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's CPU thread pool slows many-fold when they share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt(tmp_path, *extra):
    return TestOptions().parse(TINY + ["--checkpoints_dir", str(tmp_path),
                                       "--name", "run", *extra], save=False)


def _warp_inputs(B=2, P=5, H=4, W=8, T=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    probs = torch.softmax(torch.randn((B, P + 1, H, W), generator=g) * 2, 1)
    uv = torch.rand((B, P, 2, H, W), generator=g)
    tex = torch.rand((B, P, 3, T, T), generator=g) * 2 - 1
    fg = probs[:, 1:].flatten(2)                # parts N apart, strided
    u, v = uv[:, :, 0].flatten(2), uv[:, :, 1].flatten(2)
    return tex, fg, u, v


def _op_cases():
    tex, fg, u, v = _warp_inputs()
    w = tk.topk_select_plain(fg, 2, 0, 0.05)
    g = torch.randn((2, 3, 32), generator=torch.Generator().manual_seed(1))
    img = torch.randn((2, 5, 6, 7), generator=torch.Generator().manual_seed(2))
    flow = 3 * torch.randn((2, 2, 6, 7),
                           generator=torch.Generator().manual_seed(3))
    fg_cap = _warp_inputs(B=1, P=5, H=32, W=64, seed=4)[1]   # 2 blocks
    ops = torch.ops.nhvr_torch
    return {
        "topk_select": (ops.topk_select.default, (fg, 2, 0, 0.05),
                        lambda: tk.topk_select_plain(fg, 2, 0, 0.05)),
        "topk_select block_parts": (
            ops.topk_select.default, (fg_cap, 3, 2, 0.0),
            lambda: tk.topk_select_plain(fg_cap, 3, 2, 0.0)),
        "topk_select all parts": (ops.topk_select.default,
                                  (w, 5, 0, 0.0), lambda: w),
        "texture_warp_fwd": (ops.texture_warp_fwd.default, (tex, u, v, w),
                             lambda: tk.texture_warp_fwd_plain(tex, u, v, w)),
        "texture_warp_topk_fwd": (
            ops.texture_warp_topk_fwd.default, (tex, fg, u, v, 2, 0.05, False),
            lambda: (tk.texture_warp_fwd_plain(tex, u, v, w),
                     torch.empty(0))),
        "texture_warp_topk_fwd keep w": (
            ops.texture_warp_topk_fwd.default, (tex, fg, u, v, 2, 0.05, True),
            lambda: (tk.texture_warp_fwd_plain(tex, u, v, w), w)),
        "texture_warp_bwd": (
            ops.texture_warp_bwd.default, (tex[:1], u, v, w, g),
            lambda: tk.texture_warp_bwd_plain(tex[:1], u, v, w, g)),
        "flow_warp_fwd": (ops.flow_warp_fwd.default, (img, flow),
                          lambda: fk.flow_warp_fwd_plain(img, flow)),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_operator_opcheck_and_plain(case):
    op, args, plain = _op_cases()[case]
    torch.library.opcheck(op, args)
    got, want = op(*args), plain()
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
        # fresh outputs: an operator may not return a view of an input
        for t in args:
            if isinstance(t, torch.Tensor) and a.numel():
                assert a.untyped_storage().data_ptr() != \
                    t.untyped_storage().data_ptr()


def test_wrappers_go_through_the_operators():
    """The wrappers call the operators (one node each when traced), keep
    their signatures, and count no launch on the CPU."""
    tex, fg, u, v = _warp_inputs()
    tk.reset_launch_counts()
    fk.reset_launch_counts()

    def f(tex, fg, u, v):
        out, w = tk.texture_warp_topk_fwd(tex, fg, u, v, 2, 0.05,
                                          return_w=True)
        return out + tk.texture_warp_fwd(tex, u, v, tk.topk_select(fg, 2)), w

    gm = torch.fx.experimental.proxy_tensor.make_fx(f)(tex, fg, u, v)
    targets = [str(n.target) for n in gm.graph.nodes
               if "nhvr_torch" in str(n.target)]
    assert sorted(targets) == ["nhvr_torch.texture_warp_fwd.default",
                               "nhvr_torch.texture_warp_topk_fwd.default",
                               "nhvr_torch.topk_select.default"]
    assert all(getattr(tk, n).launches == 0 for n in (
        "topk_select", "texture_warp_fwd", "texture_warp_topk_fwd",
        "texture_warp_bwd")) and fk.flow_warp_fwd.launches == 0
    with pytest.raises(ValueError):
        tk.topk_select(fg.to("meta"), 2)


def _warp_nodes(exported):
    return sorted(str(n.target) for n in exported.graph.nodes
                  if "nhvr_torch" in str(n.target))


def _live(opt, joints):
    renderer = es.load_weights(opt, es.init_params(
        es.renderer_from_options(opt), opt.seed)).eval()
    ds = dsm.SyntheticDataset(opt, length=joints.shape[0])
    fwd = make_forward_fn(opt, renderer)
    return fwd(td.assets_to_device(opt, ds.texture_atlas(), ds.background(),
                                   torch.device("cpu")), joints)["fake"]


@pytest.mark.parametrize("bake,uint8", [(True, False), (False, True)])
def test_artifact_reloads_and_matches_the_live_forward(tmp_path, bake, uint8):
    opt = _opt(tmp_path)
    out = str(tmp_path / "m.pt2")
    es.save_artifact(opt, 2, out, bake_weights=bake, out_uint8=uint8)
    assert os.path.isfile(out + es.SIDECAR) != bake
    exported, joints, params = es.build_exported(opt, 2, bake, uint8)
    loaded = torch.export.load(out)
    assert _warp_nodes(loaded) == ["nhvr_torch.texture_warp_topk_fwd.default"]
    with torch.no_grad():
        if bake:
            got = loaded.module()(joints)
            ref = exported.module()(joints)
        else:
            side = torch.load(out + es.SIDECAR, weights_only=True)
            assert side.keys() == params.keys()
            got = loaded.module()(side, joints)
            ref = exported.module()(params, joints)
    live = _live(opt, joints)
    want = (es.quantize(live) if uint8 else live).permute(0, 2, 3, 1)
    assert got.shape == (2, 32, 32, 3)
    assert got.dtype == (torch.uint8 if uint8 else torch.float32)
    assert torch.equal(got, ref)
    assert torch.equal(got, want)


def test_bf16_sidecar_gives_the_same_frames(tmp_path):
    opt = _opt(tmp_path, "--dtype", "bfloat16")
    exported, joints, params = es.build_exported(opt, 2, bake_weights=False,
                                                 out_uint8=True)
    assert all(v.dtype == torch.bfloat16 for v in params.values())
    with torch.no_grad():
        got = exported.module()(params, joints)
    want = es.quantize(_live(opt, joints)).permute(0, 2, 3, 1)
    assert torch.equal(got, want)


def test_block_parts_route_and_sizes(tmp_path):
    """--warp_block_parts exports top-k with the cap and the forward with
    w given; at ngf 16 the program file is smaller than its sidecar (the
    graph's description is ~1.3 MB whatever the width; the flagship's
    sidecar is ~0.4 GB)."""
    opt = TestOptions().parse(
        TINY + ["--loadSize", "64", "--ngf", "16", "--ngf_global", "16",
                "--warp_block_parts", "8",
                             "--checkpoints_dir", str(tmp_path)], save=False)
    out = str(tmp_path / "m.pt2")
    es.save_artifact(opt, 1, out)
    assert _warp_nodes(torch.export.load(out)) == [
        "nhvr_torch.texture_warp_fwd.default",
        "nhvr_torch.topk_select.default"]
    assert os.path.getsize(out) < os.path.getsize(out + es.SIDECAR)


def test_cli_writes_the_artifact(tmp_path, capsys):
    out = str(tmp_path / "cli.pt2")
    assert es.main(TINY + ["--checkpoints_dir", str(tmp_path), "--out", out,
                           "--batch", "1", "--raw_float"]) == 0
    assert "random-init" in capsys.readouterr().err
    loaded = torch.export.load(out)
    side = torch.load(out + es.SIDECAR, weights_only=True)
    joints = torch.zeros((1, 18, 3))
    with torch.no_grad():
        frames = loaded.module()(side, joints)
    assert frames.dtype == torch.float32 and frames.shape == (1, 32, 32, 3)


def test_matches_the_jax_export(tmp_path, tiny_opt, capsys):
    """The JAX tool's build_exported (baked, uint8) at the tiny config; its
    weights saved as a JAX G checkpoint at epoch 1, which the port's
    export loads: uint8 frames within 1 level."""
    jax = pytest.importorskip("jax")
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import export_serving as jes

    from neural_human_video_rendering_tpu.utils import checkpoint as jckpt
    jopt = dataclasses.replace(tiny_opt, checkpoints_dir=str(tmp_path),
                               name="jrun", warp_topk=24, warp_eps=0.0)
    exported, joints, g_params = jes.build_exported(
        jopt, batch=2, bake_weights=True, out_uint8=True)
    ref = np.asarray(exported.call(joints))
    jckpt.save_net(str(tmp_path / "jrun"), "G", 1,
                   jax.tree.map(np.asarray, g_params))
    opt = TestOptions().parse([
        "--loadSize", "32", "--tex_tile", "16", "--ngf", "4",
        "--ngf_global", "4", "--n_blocks_translate", "1",
        "--n_downsample_translate", "2", "--n_blocks_global", "1",
        "--n_downsample_global", "1", "--n_blocks_bg", "1",
        "--n_downsample_bg", "1", "--ndf", "4", "--dtype", "float32",
        "--warp_topk", "24", "--warp_eps", "0", "--gpu_ids", "-1",
        "--checkpoints_dir", str(tmp_path), "--name", "jrun",
        "--which_epoch", "1"], save=False)
    ours, tjoints, _ = es.build_exported(opt, 2, bake_weights=True,
                                         out_uint8=True)
    assert "G epoch 1" in capsys.readouterr().err
    np.testing.assert_array_equal(tjoints.numpy(), np.asarray(joints))
    with torch.no_grad():
        got = ours.module()(tjoints).numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1, diff.max()
