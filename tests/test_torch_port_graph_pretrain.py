"""PyTorch port, the captured pretrain steps and served program
(``train/graphs.py``): the counterparts of the JAX package's
``jax.jit(step, donate_argnums=(0, 1))`` of its two pretrain steps and of
the JAX server's compiled ``Exported.call``, on the CPU.

The CPU has no CUDA graphs, so these tests drive the graph route with
``graphs.StandIn`` (the ``stand_in`` fixture of
tests/test_torch_port_graph_step.py):
  * make_pretrain_uv_step and make_pretrain_tex_step through the
    stand-in route give the eager step's bits over 4 steps with the
    decaying schedule and a partial last batch (parameters, Adam moments
    and counts, metrics), capturing once per batch shape, and print
    their route;
  * serve._Model with a stand-in program answers the eager module's
    frames for a request of 1 and of the compiled batch, from one
    capture, with the weights sidecar and with the weights baked in; on
    the CPU it runs eagerly and says so;
  * a capture's line carries its allocator record on the card and none
    for a stand-in.
The graphed routes against the eager ones on the card are in
tests/test_torch_port_cuda.py (``gpu``) and chip_smoke.py phase 16. The
JAX parity of both pretrain steps is in tests/test_torch_port_pretrain.py
and tests/test_torch_port_options_pretrain.py.
"""

import copy
import re

import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu_torch import export_serving as es
from neural_human_video_rendering_tpu_torch import serve as srv
from neural_human_video_rendering_tpu_torch.config import TestOptions
from neural_human_video_rendering_tpu_torch.config import Options as TOptions
from neural_human_video_rendering_tpu_torch.data import dataset as tds
from neural_human_video_rendering_tpu_torch.data.wire import pack_batch
from neural_human_video_rendering_tpu_torch.models.generators import TexG
from neural_human_video_rendering_tpu_torch.models.renderer import (
    init_params, renderer_from_options)
from neural_human_video_rendering_tpu_torch.parallel.mesh import \
    optimizer_tensors
from neural_human_video_rendering_tpu_torch.train import graphs
from neural_human_video_rendering_tpu_torch.train import steps as tsteps
from neural_human_video_rendering_tpu_torch.train.state import (
    PretrainState, make_optimizer)
from test_torch_port_graph_step import stand_in  # noqa: F401 (fixture)

FLAGS = dict(loadSize=32, tex_tile=16, batchSize=2, n_blocks_translate=1,
             n_downsample_translate=2, n_blocks_global=1,
             n_downsample_global=1, ngf=4, ngf_global=4, dtype="float32",
             no_flip=True, pose_heatmaps=True, coord_conv=True, stem_s2d=2,
             head_s2d=2, pad_mode="same", lr=1e-3, niter=2, niter_decay=2,
             gpu_ids="-1")
SERVE_TINY = ("--loadSize 32 --tex_tile 16 --ngf 4 --ngf_global 4 "
              "--n_blocks_translate 1 --n_downsample_translate 2 "
              "--n_blocks_global 1 --n_downsample_global 1 --n_blocks_bg 1 "
              "--n_downsample_bg 1 --dtype float32 --pose_heatmaps "
              "--coord_conv --gpu_ids -1").split()
FLAG_OPT = TOptions(**FLAGS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's CPU thread pool slows many-fold when they share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(opt, extra=None):
    """4 packed batches: 2, 2, 1 (a partial batch), 2 samples."""
    ds = tds.SyntheticDataset(opt, length=7, seed=3)
    samples = [ds[i] for i in range(7)]
    if extra is not None:
        for i, s in enumerate(samples):
            extra(i, s)
    groups = [(0, 1), (2, 3), (4,), (5, 6)]
    return ([pack_batch(tds.collate([samples[i] for i in g]))
             for g in groups], ds)


def _bits(st):
    out = {f"net.{k}": v for k, v in st.net.state_dict().items()}
    for i, t in enumerate(optimizer_tensors(st.optimizer)):
        out[f"opt.{i}"] = t
    return out


def _run_both(stand_in, make_net, make_step, batches, name, capsys):
    """4 steps eagerly and through the stand-in route from one start:
    the same bits everywhere."""
    net0 = make_net()
    runs = {}
    for route in ("eager", "graph"):
        net = copy.deepcopy(net0)
        st = PretrainState(step=0, net=net, device=torch.device("cpu"),
                           optimizer=make_optimizer(
                               FLAG_OPT, net.named_parameters(), 1))
        assert st.optimizer.scheduled
        with stand_in.cpu(route == "eager"):
            step = make_step(st)
        assert (step.program is None) == (route == "eager")
        metrics = [{k: v.clone() for k, v in step(st, b).items()}
                   for b in batches]
        runs[route] = (st, step, metrics)
    (e, _, me), (g, gstep, mg) = runs["eager"], runs["graph"]
    # the schedule decayed over the run: the last update's rate is lower
    assert g.optimizer.lr_now < FLAG_OPT.lr
    assert e.step == g.step == 4
    assert e.optimizer.count == g.optimizer.count == 4
    assert e.optimizer.freeze_count == g.optimizer.freeze_count == 4
    for a, b in zip(me, mg):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    want, got = _bits(e), _bits(g)
    assert sorted(want) == sorted(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    # one capture a batch shape: 2 and 1
    assert gstep.program.captures == 2 and len(gstep.program.entries) == 2
    assert gstep.program.memory == [{}, {}]
    assert gstep.program.num_ooms == 0
    printed = capsys.readouterr().err
    assert printed.count(f"[{name}] eager (cpu)") == 1
    assert printed.count(f"[{name}] graphed (stand-in, capture ") == 2
    assert f"[{name}] graphed (stand-in, 1 capture)" in printed
    return me


def test_pretrain_uv_graph_route_gives_the_eager_bits(stand_in, capsys):
    opt = FLAG_OPT
    batches, _ = _batches(opt)
    metrics = _run_both(
        stand_in, lambda: init_params(renderer_from_options(opt), 1).TransG,
        lambda st: tsteps.make_pretrain_uv_step(opt, st.net, st.optimizer),
        batches, "pretrain_uv", capsys)
    assert sorted(metrics[0]) == ["Prob", "UV", "total"]


def test_pretrain_tex_graph_route_gives_the_eager_bits(stand_in, capsys):
    opt = FLAG_OPT
    rng = np.random.default_rng(4)
    atlas = tds.SyntheticDataset(opt, length=1, seed=3).texture_atlas()
    static = np.clip(atlas * 0.5, -1, 1).astype(np.float32)

    def part_texture(i, s):
        s["part_texture"] = np.clip(static + 0.1 * np.sin(0.3 * i), -1,
                                    1).astype(np.float32)
        s["pose_texture"] = rng.uniform(-1, 1, static.shape).astype(
            np.float32)

    batches, _ = _batches(opt, part_texture)
    mask = (np.abs(static + 1.0).sum(-1, keepdims=True) > 0.05).astype(
        np.float32)

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))

    static_t, mask_t = nchw(static), nchw(mask)

    def make_net():
        torch.manual_seed(2)
        return TexG(opt.pose_nc, opt.n_parts, opt.tex_tile, opt.ngf_global,
                    opt.n_downsample_global, opt.n_blocks_global,
                    stem_s2d=2, head_s2d=2, pad_mode="same")

    metrics = _run_both(
        stand_in, make_net,
        lambda st: tsteps.make_pretrain_tex_step(opt, st.net, st.optimizer,
                                                 static_t, mask_t),
        batches, "pretrain_tex", capsys)
    assert sorted(metrics[0]) == ["Tex_L1"]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A tiny program at batch 3 with its weights sidecar, and one with
    its weights baked in."""
    root = tmp_path_factory.mktemp("serve_graph")
    opt = TestOptions().parse(SERVE_TINY + ["--checkpoints_dir", str(root)],
                              save=False)
    out = {}
    for bake in (False, True):
        path = str(root / f"m_bake{int(bake)}.pt2")
        es.save_artifact(opt, 3, path, bake_weights=bake)
        out[bake] = path
    ds = tds.SyntheticDataset(opt, length=3)
    joints = np.stack([ds[i]["joints"] for i in range(3)]).astype(np.float32)
    return out, joints


@pytest.mark.parametrize("bake", [False, True], ids=["sidecar", "baked"])
def test_served_program_graph_route_matches_eager(stand_in, artifacts, bake,
                                                  capsys):
    paths, joints = artifacts
    model = srv._Model(paths[bake], torch.device("cpu"))
    assert model.program is not None and (model.params is None) == bake
    assert model.program.captures == 1          # the warm-up call's
    for n in (1, 3, 1):
        got = model.render(joints[:n])
        padded = np.concatenate([joints[:n]] + [joints[n - 1:n]] * (3 - n))
        want = model.forward(torch.from_numpy(padded))[:n].numpy()
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert set(model.timing) == {"forward_s", "transfer_s"}
    assert model.program.captures == 1 and len(model.program.entries) == 1
    printed = capsys.readouterr().err
    assert printed.count("[serve] graphed (stand-in, capture 1: batch 3, "
                         "1 segment, ") == 1
    assert printed.count("[serve] graphed (stand-in, 1 capture)") == 1
    # the CPU's own route
    with stand_in.cpu():
        eager = srv._Model(paths[bake], torch.device("cpu"))
    assert eager.program is None
    np.testing.assert_array_equal(eager.render(joints), model.render(joints))
    assert "[serve] eager (cpu)" in capsys.readouterr().err


def test_capture_line_carries_the_allocator_record():
    card = graphs.capture_line("pretrain_uv", False, 2, 6, 1, 1.234,
                               {"num_ooms": 0, "peak_reserved": 30_507_270_144,
                                "pool_bytes": 18_947_768_320})
    assert card == ("[pretrain_uv] graphed (CUDA graph, capture 2: batch 6, "
                    "1 segment, 1.23 s, num_ooms 0, peak reserved 30.51 GB)")
    shown = graphs.capture_line("step", False, 1, 1, 6, 7.45,
                                {"num_ooms": 2, "peak_reserved": 50.27e9})
    assert re.search(r", 6 segments, 7\.45 s, num_ooms 2, peak reserved "
                     r"50\.27 GB\)$", shown)
    stand = graphs.capture_line("serve", True, 1, 8, 1, 0.5, {})
    assert stand == ("[serve] graphed (stand-in, capture 1: batch 8, "
                     "1 segment, 0.50 s)")
    assert "num_ooms" not in stand
    assert graphs.capture_line("toy", True, 3, None, 2, 0.0, {}) == \
        "[toy] graphed (stand-in, capture 3: 2 segments, 0.00 s)"


def test_exported_program_holds_no_host_constant(tmp_path):
    """The served program makes no tensor from host data: two exports in
    one process (the skeleton's limbs and colours traced each time) give
    programs without lifted constants or copies to a device, which a
    capture on the card could not hold (a host-to-device copy inside a
    CUDA graph)."""
    opt = TestOptions().parse(SERVE_TINY + [
        "--checkpoints_dir", str(tmp_path), "--warp_topk", "4",
        "--warp_eps", "1e-3"], save=False)
    for bake in (False, True):
        exported, _, _ = es.build_exported(opt, 2, bake_weights=bake,
                                           out_uint8=True)
        assert not exported.constants, list(exported.constants)
        targets = {str(n.target) for n in exported.graph.nodes}
        assert not [t for t in targets if "lift_fresh" in t
                    or "to.device" in t or "_to_copy" in t], sorted(targets)
