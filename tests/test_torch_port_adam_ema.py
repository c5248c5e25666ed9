"""PyTorch port, the optimizers' one-pass update (``ops/adam_ema_kernel.py``,
``train/state.py``'s ``ScheduledAdam``) on the CPU.

On the card ``ScheduledAdam.update`` runs one kernel pass a parameter
group, the EMA folded into G's; the CPU keeps torch's Adam and the EMA's
CPU form. The kernel cannot run here, so these tests drive the card's
route with CPU tensors, where the wrapper runs its plain version (the
kernel's arithmetic in PyTorch), by giving an optimizer a learning rate
tensor as the card's has (``one_pass``):
  * the route against torch's Adam and ``ema_blend`` over several updates,
    with a channels_last conv weight, a bias of odd size and a frozen
    parameter;
  * the stage-2 step handing G's optimizer the EMA, on that route and
    through a stand-in capture, against the CPU's step;
  * an optimizer state saved by torch's Adam loads, updates and saves
    again with the same keys and layout;
  * the capture line's ``adam a/c`` and the programs' launch counter.
The kernel itself is held to torch's Adam on the card in
tests/test_torch_port_cuda.py (``gpu``) and in chip_smoke.py phase 18.

Tolerance: the plain route computes the bias corrections in float32 on
tensors (torch's capturable form) where torch's CPU Adam takes them in
Python floats, and the EMA's card form rounds the product before the sum
where the CPU form may not: a few float32 ulp an element a step.
"""

import io

import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu_torch.config import Options as TOptions
from neural_human_video_rendering_tpu_torch.data import dataset as tds
from neural_human_video_rendering_tpu_torch.data.wire import pack_batch
from neural_human_video_rendering_tpu_torch.ops import adam_ema_kernel as ak
from neural_human_video_rendering_tpu_torch.train import graphs
from neural_human_video_rendering_tpu_torch.train import state as tstate
from neural_human_video_rendering_tpu_torch.train import steps as tsteps

RTOL, ATOL = 1e-6, 1e-6
SHAPES = [(16, 8, 3, 3), (7,), (33, 65), (12, 5)]
LR, BETAS = 1e-3, (0.5, 0.999)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's CPU thread pool slows many-fold when they share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def one_pass(optimizer: tstate.ScheduledAdam) -> tstate.ScheduledAdam:
    """The card's route for a CPU optimizer: a learning rate tensor, which
    ``update`` takes as the card's device learning rate."""
    optimizer.lr_t = torch.full((), optimizer.lr_now, dtype=torch.float32)
    for group in optimizer.param_groups:
        group["lr"] = optimizer.lr_t
    return optimizer


def close(got, want, what=""):
    torch.testing.assert_close(
        got, want, rtol=RTOL,
        atol=ATOL * max(float(want.abs().max()), 1e-30), msg=what)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for s in SHAPES:
        x = torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        if len(s) == 4:
            x = x.contiguous(memory_format=torch.channels_last)
        out.append(torch.nn.Parameter(x))
    return out


def _grads(params, k):
    rng = np.random.default_rng(100 + k)
    return [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
            .contiguous(memory_format=torch.channels_last) if p.dim() == 4
            else torch.from_numpy(rng.standard_normal(p.shape)
                                  .astype(np.float32)) for p in params]


@pytest.mark.parametrize("ema", [True, False])
def test_plain_one_pass_matches_scheduled_adam_and_ema_blend(ema):
    """5 updates, the last parameter frozen for the first 3: the one-pass
    route (the plain version) against ScheduledAdam's CPU route (torch's
    Adam) and the EMA's CPU form; the moments bit-equal (the same lerp,
    mul and addcmul), p and the EMA within RTOL / ATOL, the frozen
    parameter unmoved while frozen; torch Adam's state in the parameters'
    layout; one ``tensors`` count a parameter an update and no kernel."""
    runs = {}
    for route in ("torch", "one pass"):
        ps = _params()
        opt = tstate.ScheduledAdam(ps, LR, BETAS, lambda t: 1.0,
                                   frozen=[ps[-1]], frozen_steps=3)
        if route == "one pass":
            one_pass(opt)
        es = [p.detach().clone() for p in ps]
        before = tstate.adam_counts()
        for k in range(5):
            for p, g in zip(ps, _grads(ps, k)):
                p.grad = g
            opt.prepare()
            opt.update((list(zip(ps, es)),
                        tsteps.ema_decay(torch.tensor(k), 0.999))
                       if ema else None)
            opt.advance()
            if k == 2:
                assert torch.equal(ps[-1].detach(), _params()[-1].detach())
        after = tstate.adam_counts()
        assert (after[0] - before[0], after[1] - before[1]) \
            == (0, 5 * len(SHAPES))
        runs[route] = (ps, opt, es)
    (tp, topt, te), (op, oopt, oe) = runs["torch"], runs["one pass"]
    for i in range(len(SHAPES)):
        close(op[i].detach(), tp[i].detach(), f"p{i}")
        st, want = oopt.state[op[i]], topt.state[tp[i]]
        assert sorted(st) == sorted(want) == ["exp_avg", "exp_avg_sq", "step"]
        assert torch.equal(st["step"], want["step"]) and float(st["step"]) == 5
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[key], want[key]), (i, key)
            assert st[key].stride() == op[i].stride()
        if ema:
            close(oe[i], te[i], f"e{i}")
        else:
            assert torch.equal(oe[i], _params()[i].detach())


def test_the_ema_of_a_parameter_without_a_gradient_still_blends():
    """A parameter with no gradient is left out of Adam (torch's rule) but
    its EMA still blends toward it, as ``ema_blend`` blends every one."""
    ps = _params()
    opt = one_pass(tstate.ScheduledAdam(ps, LR, BETAS, lambda t: 1.0))
    es = [torch.zeros_like(p) for p in ps]
    for p, g in zip(ps[:-1], _grads(ps, 0)):
        p.grad = g
    opt.prepare()
    opt.update((list(zip(ps, es)), torch.tensor(0.5)))
    assert ps[-1] not in opt.state
    assert float(opt.state[ps[0]]["step"]) == 1
    torch.testing.assert_close(es[-1], ps[-1].detach() * 0.5)


def leaves_of_nets(st):
    """G's and D's parameters, and the EMA's start (G's), by leaf name."""
    out = {}
    for n, p in st.renderer.named_parameters():
        out[f"G.{n}"] = out[f"E.{n}"] = p.detach().clone()
    out.update({f"D.{n}": p.detach().clone()
                for n, p in st.disc.named_parameters()})
    return out


def test_train_step_hands_the_ema_to_g_s_update(monkeypatch, tmp_path,
                                                capsys):
    """The stage-2 step with both optimizers on the one-pass route, taken
    through a stand-in capture, against the CPU's step from the same
    state. After the first step (the same gradients on both routes) G, D,
    the EMA and Adam's moments agree within 2e-5 of each tensor's largest
    change plus 3e-7 of each value (two float32 ulp of the sum p + step):
    the float32 bias corrections of the one-pass route against the CPU
    Adam's Python floats (1 - beta2 in float32 is 1.3e-5 off 0.001, so
    sqrt(1 - beta2^t) 6.4e-6 off) move every first update by that share.
    Later steps' gradients depend on
    those bits (Adam's sign-like first steps, the warp's texel edges), so
    two more steps are only run, through the capture's replays. The
    capture offered every parameter tensor of G and D to an update
    (``adam 0/c``: CPU tensors run the plain version, not the kernel)."""
    opt = TOptions(loadSize=32, tex_tile=16, batchSize=2,
                   n_blocks_translate=1, n_downsample_translate=2,
                   n_blocks_global=1, n_downsample_global=1, n_blocks_bg=1,
                   n_downsample_bg=1, ngf=4, ngf_global=4, ndf=4, num_D=2,
                   n_layers_D=2, dtype="float32", no_flip=True,
                   stem_s2d=2, head_s2d=2, bg_s2d=4, pad_mode="same",
                   warp_topk=24, warp_eps=0.0, lambda_L2=500, lambda_UV=1000,
                   lambda_Prob=10, use_densepose_loss=True, no_vgg_loss=True,
                   ema_decay=0.999, checkpoints_dir=str(tmp_path),
                   gpu_ids="-1")
    ds = tds.SyntheticDataset(opt, length=6, seed=2)
    batches = [pack_batch(tds.collate([ds[i], ds[i + 1]])) for i in (0, 2, 4)]
    made = []
    cpu = graphs.program_for

    def program_for(name, device):
        made.append(graphs.Program(name, device, stand_in=True))
        return made[-1]

    def leaves(st):
        """G, D, the EMA (from G's start) and Adam's moments (from 0)."""
        out = {f"G.{n}": p for n, p in st.renderer.named_parameters()}
        out.update({f"D.{n}": p for n, p in st.disc.named_parameters()})
        out.update({f"E.{n}": e for n, e in st.g_ema.items()})
        for tag, o in (("G", st.g_opt), ("D", st.d_opt)):
            for i, p in enumerate(o.param_groups[0]["params"]):
                out[f"{tag}.m{i}"] = o.state[p]["exp_avg"]
                out[f"{tag}.v{i}"] = o.state[p]["exp_avg_sq"]
        return {k: v.detach().clone() for k, v in out.items()}

    runs = {}
    for route in ("cpu", "one pass"):
        st = tstate.create_train_state(opt, ds.texture_atlas(),
                                       ds.background(),
                                       device=torch.device("cpu"))
        if route == "one pass":
            one_pass(st.g_opt)
            one_pass(st.d_opt)
            monkeypatch.setattr(graphs, "program_for", program_for)
        step = tsteps.make_train_step(opt, st.renderer, st.disc, None,
                                      st.g_opt, st.d_opt)
        monkeypatch.setattr(graphs, "program_for", cpu)
        start = {k: v for k, v in leaves_of_nets(st).items()}
        first = {k: float(v) for k, v in step(st, batches[0]).items()}
        after = leaves(st)
        later = [{k: float(v) for k, v in step(st, b).items()}
                 for b in batches[1:]]
        runs[route] = (st, first, after, later, start)
    (c, cfirst, cafter, _, start), (o, ofirst, oafter, olater, _) = \
        runs["cpu"], runs["one pass"]
    assert ofirst == cfirst
    assert sorted(oafter) == sorted(cafter)
    for k, want in cafter.items():
        change = want - start.get(k, 0.0)
        torch.testing.assert_close(
            oafter[k], want, rtol=3e-7,
            atol=2e-5 * max(float(change.abs().max()), 1e-30), msg=k)
    assert all(np.isfinite(v) for m in olater for v in m.values())
    assert o.step == 3 and int(o.step_t) == 3
    assert all(float(s["step"]) == 3 for opt_ in (o.g_opt, o.d_opt)
               for s in opt_.state.values())
    n = len(list(o.renderer.parameters())) + len(list(o.disc.parameters()))
    assert len(made) == 1 and made[0].adam == [(0, n)]
    assert f", adam 0/{n})" in capsys.readouterr().err


def test_adam_state_saved_by_torch_round_trips_through_the_one_pass_route():
    """An optimizer state as torch's Adam writes it (the layout of every
    file saved before the one-pass update: ``step``, ``exp_avg``,
    ``exp_avg_sq`` per parameter), read from bytes by a ScheduledAdam on
    the one-pass route: one update later its state_dict has the same keys,
    shapes, dtypes and layouts, each step count one further, and the
    parameters agree with torch's Adam continued from the same file."""
    src = _params(1)
    adam = torch.optim.Adam(src, lr=LR, betas=BETAS, eps=1e-8)
    for k in range(2):
        for p, g in zip(src, _grads(src, k)):
            p.grad = g
        adam.step()
    buf = io.BytesIO()
    torch.save(adam.state_dict(), buf)
    saved = torch.load(io.BytesIO(buf.getvalue()))
    runs = {}
    for route in ("torch", "one pass"):
        ps = _params(1)
        with torch.no_grad():
            for p, s in zip(ps, src):
                p.copy_(s)
        opt = tstate.ScheduledAdam(ps, LR, BETAS, lambda t: 1.0)
        opt.load_state_dict(torch.load(io.BytesIO(buf.getvalue())))
        if route == "one pass":
            one_pass(opt)
        for p, g in zip(ps, _grads(ps, 2)):
            p.grad = g
        opt.step()
        runs[route] = (ps, opt.state_dict())
    (tp, tsd), (op, osd) = runs["torch"], runs["one pass"]
    assert sorted(osd) == sorted(tsd) == ["count", "freeze_count",
                                          "param_groups", "state"]
    assert sorted(osd["param_groups"][0]) == sorted(tsd["param_groups"][0])
    assert osd["param_groups"][0]["lr"] == LR and osd["count"] == 1
    assert sorted(osd["state"]) == sorted(saved["state"])
    for i, st in osd["state"].items():
        old = saved["state"][i]
        assert sorted(st) == sorted(old) == ["exp_avg", "exp_avg_sq", "step"]
        assert float(st["step"]) == float(old["step"]) + 1 == 3
        for key in ("exp_avg", "exp_avg_sq"):
            assert (st[key].shape, st[key].dtype, st[key].stride()) == (
                old[key].shape, old[key].dtype, old[key].stride())
            close(st[key], tsd["state"][i][key])
    for a, b in zip(op, tp):
        close(a.detach(), b.detach())


def test_capture_line_prints_the_adam_engagement():
    line = graphs.capture_line(
        "step", False, 1, 2, 3, 4.5, {"num_ooms": 0, "peak_reserved": 9.9e9},
        (126, 126), (140, 140))
    assert line == ("[step] graphed (CUDA graph, capture 1: batch 2, 3 "
                    "segments, 4.50 s, nhwc 126/126, adam 140/140, num_ooms "
                    "0, peak reserved 9.90 GB)")
    assert graphs.capture_line("uv", True, 1, 6, 1, 0.5, {}, (0, 0),
                               (52, 60)) == (
        "[uv] graphed (stand-in, capture 1: batch 6, 1 segment, 0.50 s, "
        "adam 52/60)")
    # a program that updates no optimizer prints no adam
    assert "adam" not in graphs.capture_line("serve", True, 1, 8, 1, 0.5, {},
                                             (60, 60))


def test_a_replay_counts_its_captured_adam_launches():
    """The Adam kernel's launch counter is one of the programs' counters: a
    replay adds the launches its capture recorded, the warm-up's are kept
    apart."""
    assert (ak.adam_ema, "launches") in graphs.kernel_counters()
    prog = graphs.Program("toy", torch.device("cpu"), stand_in=True)

    def make(static):
        def closure():
            ak.adam_ema.launches += 2      # as a G and a D update launch
            return {"y": static["x"] + 1}
        return closure

    ak.reset_launch_counts()
    prog("k", {"x": torch.zeros(2)}, make)
    prog("k", {"x": torch.ones(2)}, make)
    assert ak.adam_ema.launches == 4
    assert prog.warmup_launches == {"adam_ema": 2 * graphs.WARMUP}
    ak.reset_launch_counts()


def test_adam_ema_wrapper_checks_its_lists():
    p = [torch.zeros(3)]
    z = [torch.zeros(3)]
    s = [torch.zeros(())]
    with pytest.raises(ValueError, match="per parameter"):
        ak.adam_ema(p, z, z, z, s + s, 1e-3, 0.5, 0.999, 1e-8)
    with pytest.raises(ValueError, match="go together"):
        ak.adam_ema(p, z, z, z, s, 1e-3, 0.5, 0.999, 1e-8, ema=[torch.ones(3)])
    ak.adam_ema([], [], [], [], [], 1e-3, 0.5, 0.999, 1e-8)
    x = torch.zeros((2, 3, 4, 5))
    assert ak._dense(x) and ak._dense(x.contiguous(
        memory_format=torch.channels_last))
    assert ak._dense(torch.zeros((1, 7))[:, :]) and ak._dense(x[:1])
    assert not ak._dense(torch.zeros(10)[::2])
    assert not ak._dense(x[:, :2])
