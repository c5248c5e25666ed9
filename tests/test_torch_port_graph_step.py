"""PyTorch port, the captured step and forward (``train/graphs.py``): the
counterpart of the JAX package's ``jax.jit`` of its train step and
forward, on the CPU.

The CPU has no CUDA graphs, so these tests hold what a capture is built
from:
  * the EMA's decay read from the device step counter is bit-equal to the
    numpy float32 rule of ``ema_decay`` (and of the JAX package's
    ``ema_blend``);
  * the restructured step (the device counter, the learning rate set
    before the update, the pool's draws taken before the device work)
    still matches the JAX step one step after a step count of 7, eagerly
    and through the graph route with a stand-in capture;
  * a ``Program``'s bookkeeping, with ``graphs.StandIn`` for the graph:
    one capture per signature, static inputs copied in, outputs cloned,
    the warm-up leaving no trace, host points splitting the capture, and
    the kernel counters advanced by the captured launches on each replay;
  * the stand-in graph route of ``make_train_step`` gives the eager
    step's bits over a freeze boundary, a pool and a partial last batch,
    capturing once per (batch shape, freeze state);
  * on the CPU ``make_train_step`` and ``make_forward_fn`` run eagerly
    and say so.
The graphed step against the eager one on the card is in
tests/test_torch_port_cuda.py (``gpu``), and at the flagship in
chip_smoke.py phase 15.
"""

import contextlib

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
from neural_human_video_rendering_tpu_torch.data import dataset as tds
from neural_human_video_rendering_tpu_torch.data.wire import pack_batch
from neural_human_video_rendering_tpu_torch.models.bridge import params_from_jax
from neural_human_video_rendering_tpu_torch.models.renderer import (
    init_params, renderer_from_options)
from neural_human_video_rendering_tpu_torch.ops import texture_warp_kernel as tk
from neural_human_video_rendering_tpu_torch.parallel.mesh import \
    optimizer_tensors
from neural_human_video_rendering_tpu_torch.train import graphs
from neural_human_video_rendering_tpu_torch.train import state as tstate
from neural_human_video_rendering_tpu_torch.train import steps as tsteps
from neural_human_video_rendering_tpu_torch.train.drivers import kernel_launches

STEP_FLAGS = dict(
    loadSize=32, tex_tile=16, batchSize=2, n_blocks_translate=1,
    n_downsample_translate=2, n_blocks_global=1, n_downsample_global=1,
    n_blocks_bg=1, n_downsample_bg=1, ngf=4, ngf_global=4, ndf=4, num_D=2,
    n_layers_D=2, dtype="float32", no_flip=True, pose_heatmaps=True,
    coord_conv=True, stem_s2d=2, head_s2d=2, bg_s2d=4, pad_mode="same",
    warp_topk=24, warp_eps=0.0, lambda_L2=500, lambda_UV=1000,
    lambda_Prob=10, lambda_Temp=500, use_densepose_loss=True,
    no_vgg_loss=True, ema_decay=0.999, temporal_prev="real")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's CPU thread pool slows many-fold when they share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StandIns(list):
    """The stand-in programs made, in order. Inside ``cpu()`` (``cpu(on)``
    with ``on`` true) a closure gets the CPU's own route (no program)."""

    def __init__(self):
        super().__init__()
        self.off = False

    @contextlib.contextmanager
    def cpu(self, on: bool = True):
        self.off = on
        try:
            yield
        finally:
            self.off = False


@pytest.fixture
def stand_in(monkeypatch):
    """Every captured closure (the forward, the steps, the server) takes
    the graph route on the CPU, with the stand-in capture: the one seam,
    ``graphs.program_for``, patched; yields the programs made
    (``StandIns``)."""
    made = StandIns()
    cpu = graphs.program_for

    def program_for(name, device):
        if made.off:
            return cpu(name, device)
        p = graphs.Program(name, device, stand_in=True)
        made.append(p)
        return p

    monkeypatch.setattr(graphs, "program_for", program_for)
    yield made


def _linear_atlas(P=24, T=16, seed=5):
    yy, xx = np.mgrid[0:T, 0:T].astype(np.float32) / (T - 1)
    coef = np.random.default_rng(seed).uniform(-0.4, 0.4, (P, 3, 2))
    return (coef[:, None, None, :, 0] * xx[None, :, :, None]
            + coef[:, None, None, :, 1] * yy[None, :, :, None]
            ).astype(np.float32)


def _assets(ds):
    """(static_tex (P, 3, T, T), bg (3, S, S), None) of the forward."""
    return (torch.from_numpy(np.moveaxis(_linear_atlas(), -1, 1)).contiguous(),
            torch.from_numpy(np.moveaxis(ds.background(), -1, 0)).contiguous(),
            None)


# ---------------------------------------------------------------- the EMA

@pytest.mark.parametrize("decay", [0.999, 0.9999, 0.5])
def test_device_ema_decay_is_bit_equal_to_the_float32_rule(decay):
    rng = np.random.default_rng(0)
    steps = np.unique(np.concatenate([
        np.arange(0, 200), rng.integers(0, 10 ** 5 + 1, 2000),
        [10 ** 5 - 1, 10 ** 5]]))
    want = np.array([tsteps.ema_decay(int(s), decay) for s in steps],
                    np.float32)
    # the JAX package's rule gives the same numbers
    t = jnp.asarray(steps + 1, jnp.float32)
    jax_d = np.asarray(jnp.minimum(jnp.float32(decay),
                                   (1.0 + t) / (10.0 + t)))
    got = np.array([tsteps.ema_decay(torch.tensor(int(s)), decay).item()
                    for s in steps], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(jax_d.view(np.int32), want.view(np.int32))
    batched = tsteps.ema_decay(torch.from_numpy(steps), decay).numpy()
    np.testing.assert_array_equal(batched.view(np.int32),
                                  want.view(np.int32))


def test_ema_blend_with_the_device_counter_matches_the_python_step():
    torch.manual_seed(0)
    lin = torch.nn.Linear(5, 3)
    base = {k: v.detach().clone() + 0.25 for k, v in lin.named_parameters()}
    for step in (0, 7, 5000):
        a = {k: v.clone() for k, v in base.items()}
        b = {k: v.clone() for k, v in base.items()}
        tstate.blend_ema([(p, a[k]) for k, p in lin.named_parameters()],
                         tsteps.ema_decay(step, 0.999))
        tstate.blend_ema([(p, b[k]) for k, p in lin.named_parameters()],
                         tsteps.ema_decay(torch.tensor(step), 0.999))
        for k in a:
            assert torch.equal(b[k], a[k]), k


# ------------------------------------------------- the step against JAX

@pytest.fixture(scope="module")
def jax_step_at_7(tmp_path_factory):
    """One JAX step (SGD 1, the EMA) from a state at step 7: the inputs
    and the results the port must reproduce."""
    flags = dict(STEP_FLAGS,
                 checkpoints_dir=str(tmp_path_factory.mktemp("ck")))
    jopt = JOptions(**flags, use_pallas_warp=False)
    ds = jds.SyntheticDataset(jopt, length=4)
    batch = jds.collate([ds[i] for i in (1, 2)])
    atlas, bg = _linear_atlas(), ds.background()
    bundle = jstate.create_train_state(jopt, jax.random.PRNGKey(0), atlas, bg)
    g0 = jax.tree.map(np.array, bundle["state"].g_params)
    gen = g0["TexG"]["GlobalGenerator_0"]
    head = max((k for k in gen if k.startswith("ConvNormRelu_")),
               key=lambda k: int(k.rsplit("_", 1)[1]))
    gen[head]["Conv_0"]["kernel"][...] = 0.0
    d0 = jax.tree.map(np.array, bundle["state"].d_params)
    # the EMA starts away from G, so its move shows the decay
    e0 = jax.tree.map(lambda a: (a + 0.01).astype(a.dtype), g0)
    sgd = optax.sgd(1.0)
    jst0 = bundle["state"].replace(
        step=jnp.asarray(7, bundle["state"].step.dtype),
        g_params=jax.tree.map(jnp.asarray, g0),
        d_params=jax.tree.map(jnp.asarray, d0),
        g_ema=jax.tree.map(jnp.asarray, e0),
        g_opt=sgd.init(g0), d_opt=sgd.init(d0))
    jstep = jsteps.make_train_step(jopt, bundle["renderer"], bundle["disc"],
                                   None, sgd, sgd)
    jst1, jm = jstep(jst0, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(flags=flags, batch=batch, atlas=atlas, bg=bg, g0=g0, d0=d0,
                e0=e0, g1=jax.tree.map(np.array, jst1.g_params),
                e1=jax.tree.map(np.array, jst1.g_ema),
                metrics={k: float(v) for k, v in jm.items()},
                step=int(jst1.step))


@pytest.mark.parametrize("route", ["eager", "stand-in"])
def test_step_at_step_7_matches_jax(route, jax_step_at_7, request):
    j = jax_step_at_7
    made = request.getfixturevalue("stand_in") if route == "stand-in" else []
    topt = TOptions(**j["flags"], gpu_ids="-1")
    st = tstate.create_train_state(topt, j["atlas"], j["bg"],
                                   device=torch.device("cpu"))
    st.renderer.load_state_dict(params_from_jax(j["g0"]))
    st.disc.load_state_dict(params_from_jax(j["d0"]))
    st.g_ema = params_from_jax(j["e0"])
    st.g_ema = {k: st.g_ema[k].clone() for k, _ in
                st.renderer.named_parameters()}
    st.step = 7
    g_before = {k: v.clone() for k, v in st.renderer.state_dict().items()}
    step = tsteps.make_train_step(
        topt, st.renderer, st.disc, None,
        torch.optim.SGD(st.renderer.parameters(), lr=1.0),
        torch.optim.SGD(st.disc.parameters(), lr=1.0))
    tm = step(st, j["batch"])
    assert (step.program is not None) == (route == "stand-in")
    assert [p.captures for p in made] == ([1] if made else [])
    assert st.step == j["step"] == 8 and int(st.step_t) == 8
    assert sorted(tm) == sorted(j["metrics"])
    for k, v in j["metrics"].items():
        np.testing.assert_allclose(float(tm[k]), v, rtol=1e-5, err_msg=k)
    ref_g = params_from_jax(j["g1"])
    ref_e = params_from_jax(j["e1"])
    e_before = params_from_jax(j["e0"])
    for name, got, ref, before in (
            ("G", st.renderer.state_dict(), ref_g, g_before),
            ("EMA", st.g_ema, ref_e, e_before)):
        scale = max(float((ref[k] - before[k]).abs().max()) for k in ref)
        assert scale > 0
        for k in ref:
            d = ref[k] - before[k]
            err = float(((got[k] - before[k]) - d).abs().max())
            tol = 1e-5 * scale + 1e-4 * float(d.abs().max())
            assert err <= tol, f"{name} {k}: {err:.3e} > {tol:.3e}"


# ----------------------------------------------- a Program's bookkeeping

def test_program_bookkeeping_with_a_stand_in_capture(capsys):
    """Signatures, static inputs, cloned outputs, the warm-up, host points
    and the launch counters, on a closure that updates a state tensor in
    place and 'launches' texture_warp_topk_fwd twice, once keeping w."""
    prog = graphs.Program("toy", torch.device("cpu"), stand_in=True)
    acc = torch.zeros(3)
    host_calls = []
    closures = []

    def make(static):
        closures.append(static)

        def closure():
            tk.texture_warp_topk_fwd.launches += 2
            tk.texture_warp_topk_fwd.launches_keep_w += 1
            y = static["x"] * 2.0 + acc.sum()
            graphs.host_point(lambda: host_calls.append(1))
            acc.add_(static["x"].sum())
            return {"y": y, "n": acc.clone()}

        return closure

    tk.reset_launch_counts()
    x1 = torch.arange(3, dtype=torch.float32)
    out = prog("k", {"x": x1}, make, state=lambda: [acc])
    # the warm-up and the capture left nothing: the replay is the first
    assert torch.equal(out["y"], x1 * 2.0)
    assert torch.equal(acc, torch.full((3,), 3.0))
    assert prog.captures == 1 and len(closures) == 1
    assert kernel_launches()["texture_warp_topk_fwd"] == 2
    assert tk.texture_warp_topk_fwd.launches_keep_w == 1
    # the warm-up's launches are kept apart from the steps'
    assert prog.warmup_launches == {
        "texture_warp_topk_fwd": 2 * graphs.WARMUP,
        "texture_warp_topk_fwd.keep_w": graphs.WARMUP}
    # the same signature replays: the new input is copied in
    x2 = torch.ones(3)
    out2 = prog("k", {"x": x2}, make, state=lambda: [acc])
    assert prog.captures == 1
    assert torch.equal(out2["y"], torch.full((3,), 2.0 + 9.0))
    assert torch.equal(acc, torch.full((3,), 6.0))
    assert kernel_launches()["texture_warp_topk_fwd"] == 4
    # outputs are clones: the caller's copy does not move with the next
    entry = next(iter(prog.entries.values()))
    assert out2["y"].data_ptr() != entry.outputs["y"].data_ptr()
    kept = out2["y"].clone()
    prog("k", {"x": x1}, make, state=lambda: [acc])
    assert torch.equal(out2["y"], kept)
    # the host point split the capture and runs on every replay
    assert entry.capture.segments == 2
    assert len(host_calls) == graphs.WARMUP + 1 + 3
    # a new shape, or a new key, captures anew
    prog("k", {"x": torch.ones(5)}, make, state=lambda: [acc])
    prog("k2", {"x": torch.ones(5)}, make, state=lambda: [acc])
    assert prog.captures == 3 and len(prog.entries) == 3
    assert kernel_launches()["texture_warp_topk_fwd"] == 10
    assert tk.texture_warp_topk_fwd.launches_keep_w == 5
    assert prog.warmup_launches["texture_warp_topk_fwd"] == 6 * graphs.WARMUP
    printed = capsys.readouterr().err
    assert printed.count("[toy] graphed (stand-in, capture ") == 3
    assert "2 segments" in printed
    tk.reset_launch_counts()


def test_a_failed_capture_names_the_call():
    prog = graphs.Program("toy", torch.device("cpu"), stand_in=True)
    calls = []

    def make(static):
        def closure():
            calls.append(1)
            if len(calls) > graphs.WARMUP:
                raise ValueError("not capturable")
            return static["x"]
        return closure

    with pytest.raises(RuntimeError, match=r"\[toy\] CUDA graph capture "
                       r"failed at test_torch_port_graph_step.py.*"
                       r"not capturable"):
        prog("k", {"x": torch.ones(2)}, make)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        graphs.Program("toy", torch.device("cpu"))


# ------------------------------------- the step's graph route on the CPU

ROUTE_FLAGS = dict(STEP_FLAGS, warp_topk=4, warp_eps=1e-3, netG="local",
                   n_blocks_local=1, niter_fix_global=1, niter=2,
                   niter_decay=2, pool_size=3, lr=1e-3)


def _state_bits(st):
    out = {f"G.{k}": v for k, v in st.renderer.state_dict().items()}
    out.update({f"D.{k}": v for k, v in st.disc.state_dict().items()})
    out.update({f"E.{k}": v for k, v in st.g_ema.items()})
    for tag, o in (("g_opt", st.g_opt), ("d_opt", st.d_opt)):
        for i, t in enumerate(optimizer_tensors(o)):
            out[f"{tag}.{i}"] = t
    out["pool_buf"], out["pool_n"] = st.pool_buf, st.pool_n
    return out


def test_graph_route_gives_the_eager_bits(stand_in, tmp_path, capsys):
    """--netG local with the trunk frozen for the first epoch (2 steps),
    Adam with the decaying schedule, the pool and the EMA: 5 steps, the
    third a partial batch of 1, through the eager step and through the
    stand-in graph route from the same state: the same bits everywhere,
    captures for (batch 2, frozen), (batch 1, thawed), (batch 2, thawed)."""
    opt = TOptions(**ROUTE_FLAGS, checkpoints_dir=str(tmp_path),
                   gpu_ids="-1")
    ds = tds.SyntheticDataset(opt, length=6, seed=3)
    full = [pack_batch(tds.collate([ds[i], ds[i + 1]])) for i in (0, 2, 4)]
    part = pack_batch(tds.collate([ds[5]]))
    batches = [full[0], full[1], part, full[2], full[0]]
    states, metrics = {}, {}
    for route in ("eager", "graph"):
        st = tstate.create_train_state(opt, _linear_atlas(), ds.background(),
                                       steps_per_epoch=2,
                                       device=torch.device("cpu"))
        assert st.g_opt.frozen_steps == 2 and st.g_opt.frozen
        with stand_in.cpu(route == "eager"):
            step = tsteps.make_train_step(opt, st.renderer, st.disc, None,
                                          st.g_opt, st.d_opt)
        metrics[route] = [{k: v.clone() for k, v in step(st, b).items()}
                          for b in batches]
        states[route] = st
    prog = stand_in[-1]
    assert prog.captures == 3 and len(prog.entries) == 3
    eager, graph = states["eager"], states["graph"]
    assert eager.step == graph.step == 5 == int(graph.step_t)
    assert eager.g_opt.count == graph.g_opt.count == 5
    for m_e, m_g in zip(metrics["eager"], metrics["graph"]):
        assert sorted(m_e) == sorted(m_g)
        for k in m_e:
            assert torch.equal(m_e[k], m_g[k]), k
    want, got = _state_bits(eager), _state_bits(graph)
    assert sorted(want) == sorted(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    assert int(graph.pool_n) == 3
    # the generator drew the same numbers in the same order
    assert torch.equal(eager.pool_gen.get_state(), graph.pool_gen.get_state())
    printed = capsys.readouterr().err
    assert "[step] eager (cpu)" in printed
    assert printed.count("[step] graphed (stand-in, capture ") == 3


def test_the_cpu_routes_are_eager_and_say_so(tmp_path, capsys):
    opt = TOptions(**dict(STEP_FLAGS, checkpoints_dir=str(tmp_path)),
                   gpu_ids="-1")
    ds = tds.SyntheticDataset(opt, length=2, seed=1)
    st = tstate.create_train_state(opt, _linear_atlas(), ds.background(),
                                   device=torch.device("cpu"))
    step = tsteps.make_train_step(opt, st.renderer, st.disc, None, st.g_opt,
                                  st.d_opt)
    assert step.program is None
    step(st, tds.collate([ds[0], ds[1]]))
    step(st, tds.collate([ds[0], ds[1]]))
    renderer = init_params(renderer_from_options(opt), 0).eval()
    fwd = tsteps.make_forward_fn(opt, renderer)
    assert fwd.program is None
    assets = _assets(ds)
    joints = torch.from_numpy(np.stack([ds[0]["joints"], ds[1]["joints"]]))
    out = fwd(assets, joints)
    assert out["fake"].shape == (2, 3, opt.train_size, opt.train_size)
    printed = capsys.readouterr().err
    assert printed.count("[step] eager (cpu)") == 1
    assert printed.count("[forward] eager (cpu)") == 1


def test_the_forward_graph_route_matches_eager(stand_in, tmp_path):
    """The forward through the stand-in route: the eager frames, one
    capture per batch shape, the assets held (other assets capture
    anew)."""
    opt = TOptions(**dict(STEP_FLAGS, checkpoints_dir=str(tmp_path)),
                   gpu_ids="-1")
    ds = tds.SyntheticDataset(opt, length=3, seed=2)
    renderer = init_params(renderer_from_options(opt), 0).eval()
    assets = _assets(ds)
    j2 = torch.from_numpy(np.stack([ds[0]["joints"], ds[1]["joints"]]))
    j1 = torch.from_numpy(ds[2]["joints"][None])
    with stand_in.cpu():
        eager = tsteps.make_forward_fn(opt, renderer)
    fwd = tsteps.make_forward_fn(opt, renderer)
    assert eager.program is None and fwd.program is not None
    for j in (j2, j1, j2):
        got, want = fwd(assets, j), eager(assets, j)
        for k in ("fake", "uv", "probs"):
            assert torch.equal(got[k], want[k]), k
    assert fwd.program.captures == 2
    other = (assets[0].clone(), assets[1].clone(), None)
    assert torch.equal(fwd(other, j2)["fake"], eager(other, j2)["fake"])
    assert fwd.program.captures == 3 and len(fwd.program.entries) == 1
