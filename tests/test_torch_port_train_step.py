"""PyTorch port, the stage-2 train step: one step of the port's
make_train_step against the JAX package's on the same batch with the same
weights, Adam with the pix2pixHD schedule against optax, the EMA, the
trainer on the CPU, one step of each training option the port once
refused, and the checkpoint and real-data options.

The step comparison runs a tiny float32 config with every part blended
(--warp_topk 24 --warp_eps 0: JAX on the CPU takes the XLA all-parts warp)
and plain SGD with lr 1 on both sides, so each parameter's change is its
gradient. The weights, the atlas and the batch move across; nothing is
re-seeded on either side. Two things keep the comparison at float32
precision:
  * the static atlas is linear in the texel coordinates and TexG's last
    conv starts at zero. Bilinear sampling's gradient in uv jumps where a
    sample crosses a texel edge; the frameworks' convolutions differ by
    ~1e-6, which at random init moves a few of the ~10^5 samples across an
    edge, and TransG's head gradient then differs far beyond float32
    rounding. On a linear texture every cell
    has the same slope, so the gradient is continuous there;
  * --no_vgg_loss: the VGG runs in bf16 in both packages (rounding at
    other places); test_torch_port_train_models pins the VGG loss.
Tolerances: losses 1e-5 relative; parameter deltas (and the EMA's move)
per tensor 1e-5 * max|delta| over the module + 1e-4 * max|delta| of the
tensor (float32 sums in another order; the biases ahead of instance norms
have gradients that are rounding noise around 0).

The two JAX step compiles (one per temporal mode) take about 15 s each on
one CPU core.
"""

import dataclasses

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
from neural_human_video_rendering_tpu_torch.config import TrainOptions
from neural_human_video_rendering_tpu_torch.models.bridge import params_from_jax
from neural_human_video_rendering_tpu_torch.train import state as tstate
from neural_human_video_rendering_tpu_torch.train.drivers import run_train
from neural_human_video_rendering_tpu_torch.train.steps import (
    ema_decay, make_train_step)

LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's CPU thread pool slows many-fold when they share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

STEP_FLAGS = dict(
    loadSize=32, tex_tile=16, batchSize=2, n_blocks_translate=1,
    n_downsample_translate=2, n_blocks_global=1, n_downsample_global=1,
    n_blocks_bg=1, n_downsample_bg=1, ngf=4, ngf_global=4, ndf=4, num_D=2,
    n_layers_D=2, dtype="float32", no_flip=True, pose_heatmaps=True,
    coord_conv=True, stem_s2d=2, head_s2d=2, bg_s2d=4, pad_mode="same",
    warp_topk=24, warp_eps=0.0, lambda_L2=500, lambda_UV=1000,
    lambda_Prob=10, lambda_Temp=500, use_densepose_loss=True,
    no_vgg_loss=True, ema_decay=0.999)


def _linear_atlas(P=24, T=16, seed=5):
    yy, xx = np.mgrid[0:T, 0:T].astype(np.float32) / (T - 1)
    coef = np.random.default_rng(seed).uniform(-0.4, 0.4, (P, 3, 2))
    return (coef[:, None, None, :, 0] * xx[None, :, :, None]
            + coef[:, None, None, :, 1] * yy[None, :, :, None]
            ).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.array, tree)      # writable copies


def _assert_deltas(name, got, ref, before):
    """Per tensor: |got - ref| of the changes from `before`."""
    dj = {k: ref[k] - before[k] for k in ref}
    scale = max(float(d.abs().max()) for d in dj.values())
    assert scale > 0
    for k, d in dj.items():
        err = float(((got[k] - before[k]) - d).abs().max())
        tol = 1e-5 * scale + 1e-4 * float(d.abs().max())
        assert err <= tol, f"{name} {k}: {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("temporal_prev", ["real", "fake"])
def test_train_step_matches_jax(temporal_prev, tmp_path):
    flags = dict(STEP_FLAGS, temporal_prev=temporal_prev,
                 checkpoints_dir=str(tmp_path))
    jopt = JOptions(**flags, use_pallas_warp=False)
    topt = TOptions(**flags, gpu_ids="-1")
    ds = jds.SyntheticDataset(jopt, length=4)
    batch = jds.collate([ds[i] for i in (1, 2)])
    atlas, bg = _linear_atlas(), ds.background()

    # JAX: the package's own state and step, SGD(1) as g_tx / d_tx
    bundle = jstate.create_train_state(jopt, jax.random.PRNGKey(0), atlas, bg)
    g0 = _np_tree(bundle["state"].g_params)
    head = max(k for k in g0["TexG"]["GlobalGenerator_0"]
               if k.startswith("ConvNormRelu_"))
    g0["TexG"]["GlobalGenerator_0"][head]["Conv_0"]["kernel"][...] = 0.0
    d0 = _np_tree(bundle["state"].d_params)
    sgd = optax.sgd(1.0)
    jst0 = bundle["state"].replace(
        g_params=jax.tree.map(jnp.asarray, g0),
        d_params=jax.tree.map(jnp.asarray, d0),
        g_ema=jax.tree.map(jnp.asarray, g0),
        g_opt=sgd.init(g0), d_opt=sgd.init(d0))
    jstep = jsteps.make_train_step(jopt, bundle["renderer"], bundle["disc"],
                                   None, sgd, sgd)
    jst1, jm = jstep(jst0, {k: jnp.asarray(v) for k, v in batch.items()})

    # port: the same weights carried across, SGD(lr=1)
    st = tstate.create_train_state(topt, atlas, bg,
                                   device=torch.device("cpu"))
    st.renderer.load_state_dict(params_from_jax(g0))
    st.disc.load_state_dict(params_from_jax(d0))
    st.g_ema = {k: v.detach().clone()
                for k, v in st.renderer.named_parameters()}
    g_before = {k: v.clone() for k, v in st.renderer.state_dict().items()}
    d_before = {k: v.clone() for k, v in st.disc.state_dict().items()}
    step = make_train_step(topt, st.renderer, st.disc, None,
                           torch.optim.SGD(st.renderer.parameters(), lr=1.0),
                           torch.optim.SGD(st.disc.parameters(), lr=1.0))
    tm = step(st, batch)

    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert st.step == int(jst1.step) == 1
    _assert_deltas("G", st.renderer.state_dict(),
                   params_from_jax(_np_tree(jst1.g_params)), g_before)
    _assert_deltas("D", st.disc.state_dict(),
                   params_from_jax(_np_tree(jst1.d_params)), d_before)
    _assert_deltas("EMA", st.g_ema, params_from_jax(_np_tree(jst1.g_ema)),
                   g_before)


def test_ema_blend_matches_jax():
    rng = np.random.default_rng(0)
    lin = torch.nn.Linear(3, 4)
    ema = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
           for k, v in lin.named_parameters()}
    ref_in = {k: v.numpy().copy() for k, v in ema.items()}
    params = {k: v.detach().numpy() for k, v in lin.named_parameters()}
    for step in (0, 7, 5000):
        ref = jsteps.ema_blend(ref_in, params, jnp.int32(step), 0.999)
        got = {k: v.clone() for k, v in ema.items()}
        tstate.blend_ema([(p, got[k]) for k, p in lin.named_parameters()],
                         ema_decay(step, 0.999))
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-6, atol=1e-7)


def test_adam_and_schedule_match_optax():
    """make_optimizer: Adam (b1 0.5, b2 0.999, eps 1e-8) with a flat then
    linearly decaying lr, against the JAX package's make_optimizer over 6
    updates that cross the boundary (steps_per_epoch 1, niter 2,
    niter_decay 3)."""
    opt = TOptions(lr=1e-2, beta1=0.5, beta2=0.999, niter=2, niter_decay=3)
    jopt = JOptions(lr=1e-2, beta1=0.5, beta2=0.999, niter=2, niter_decay=3)
    assert [tstate.lr_schedule(opt, 1)(t) for t in range(7)] == \
        pytest.approx([1, 1, 1, 2 / 3, 1 / 3, 0, 0])
    rng = np.random.default_rng(1)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(6)]
    tx = jstate.make_optimizer(jopt, steps_per_epoch=1)
    jp = jax.tree.map(jnp.asarray, p0)
    js = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    topt_ = tstate.make_optimizer(opt, list(tp.values()), steps_per_epoch=1)
    for g in grads:
        ups, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ups)
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k])
        topt_.step()
        for k in p0:
            # parameters of size ~1 moved ~1e-2 a step: float32 Adam
            # arithmetic in another order differs by a few ulps
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
    assert topt_.count == 6


TINY = ("--loadSize 32 --tex_tile 16 --ngf 4 --ngf_global 4 --ndf 4 "
        "--n_layers_D 2 --n_blocks_translate 1 --n_downsample_translate 2 "
        "--n_blocks_global 1 --n_downsample_global 1 --n_blocks_bg 1 "
        "--n_downsample_bg 1 --stem_s2d 2 --head_s2d 2 --bg_s2d 4 "
        "--pad_mode same --dtype float32 --pose_heatmaps --coord_conv "
        "--batchSize 2 --no_flip --gpu_ids -1 --lambda_L2 500 "
        "--lambda_UV 1000 --lambda_Prob 10 --lambda_Temp 500 "
        "--use_densepose_loss --ema_decay 0.999 --print_freq 1").split()


@pytest.mark.parametrize("temporal_prev", ["real", "fake"])
def test_run_train_on_the_cpu(temporal_prev, tmp_path, capsys):
    """The trainer through its normal entry, VGG loss included (bf16 on
    the CPU), 2 steps: finite losses every step, G and D changed."""
    opt = TrainOptions().parse(TINY + [
        "--temporal_prev", temporal_prev, "--checkpoints_dir",
        str(tmp_path), "--name", "t"])
    st = run_train(opt, max_steps=2)
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("(epoch")]
    assert len(lines) == 2
    for ln in lines:
        fields = ln.split(") ", 1)[1].split()
        names, numbers = fields[0::2], [float(x) for x in fields[1::2]]
        assert {"G_GAN:", "G_VGG:", "G_Temp:", "D_total:"} <= set(names)
        assert all(np.isfinite(numbers)), ln
    assert st.step == 2 and len(st.step_seconds) == 2
    assert (tmp_path / "t" / "opt.txt").is_file()
    fresh = tstate.create_train_state(opt, np.zeros((24, 16, 16, 3),
                                                    np.float32),
                                      np.zeros((32, 32, 3), np.float32))
    for a, b in ((st.renderer, fresh.renderer), (st.disc, fresh.disc)):
        assert any(not torch.equal(x, y) for x, y in
                   zip(a.state_dict().values(), b.state_dict().values()))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A real-format corpus (FrameDataset: flip and crop act on it)."""
    from test_torch_port_pretrain import write_port_corpus
    root = tmp_path_factory.mktemp("corpus")
    d = write_port_corpus(str(root), TrainOptions().parse(TINY, save=False),
                          n=6)
    return ["--pose_path", d["kp"], "--img_path", d["frames"], "--mask_path",
            d["mask"], "--densepose_path", d["dp"], "--flow_path", d["flow"],
            "--flow_inv_path", d["flow_inv"], "--bg_path",
            str(root / "bg.png"), "--texture_path", str(root / "texture.png")]


@pytest.mark.parametrize("flags", [
    ["--no_temporal_detach_prev"], ["--pool_size", "4"], ["--no_flip"],
    ["--resize_or_crop", "resize_and_crop"], ["--lambda_UVgrad", "1"],
    ["--netG", "local"], ["--uv_refine", "1"], ["--ms_uv", "1"]])
def test_unported_training_options_raise(flags, tmp_path, corpus,
                                         monkeypatch):
    """The options the port once refused now train: one run_train step on
    the CPU on a real-format corpus for each (["--no_flip"] stands for
    flip on: it is the one case without --no_flip; the crop case crops
    the 32 px frames to --fineSize 24): finite losses, and each option's
    mark on the batch, the losses or the state."""
    from neural_human_video_rendering_tpu_torch.train import drivers
    base = [f for f in TINY if f != "--no_flip"]
    if flags != ["--no_flip"]:
        base.append("--no_flip")
        base += flags
    if "resize_and_crop" in flags:
        base += ["--fineSize", "24"]
    seen = set()
    make = drivers.make_train_step

    def spy(*args):
        step = make(*args)

        def wrapped(st, batch, mark=None):
            seen.update(batch)
            return step(st, batch, mark)
        return wrapped

    monkeypatch.setattr(drivers, "make_train_step", spy)
    opt = TrainOptions().parse(base + corpus + [
        "--checkpoints_dir", str(tmp_path), "--no_vgg_loss",
        "--print_freq", "100"], save=False)
    st = run_train(opt, max_steps=1)
    assert st.step == 1
    assert all(np.isfinite(float(v)) for v in st.metrics.values())
    if flags == ["--no_flip"]:
        assert "bg_flip" in seen
    elif "resize_and_crop" in flags:
        assert "bg" in seen and tuple(st.bg.shape) == (3, 24, 24)
    elif "--pool_size" in flags:
        assert int(st.pool_n) == 2 and st.pool_buf.shape[0] == 5
    elif "--lambda_UVgrad" in flags:
        assert "G_UVgrad" in st.metrics
    elif "--ms_uv" in flags:
        assert "G_MSUV" in st.metrics
    elif "--netG" in flags:
        assert hasattr(st.renderer.TransG, "LocalEnhancer_0")
    elif "--uv_refine" in flags:
        assert hasattr(st.renderer.TransG, "refine_stem")
    else:
        assert not opt.temporal_detach_prev and "G_Temp" in st.metrics


@pytest.mark.parametrize("flag", ["--img_path", "--continue_train",
                                  "--load_pretrain", "--load_pretrain_TransG"])
def test_checkpoint_and_data_options_run(flag, tmp_path, capsys):
    """The options this slice ported, through run_train: real frames
    (FrameDataset), a resume, a warm start of G and D, and the stage-1
    TransG handoff (the weights checked before any step)."""
    from neural_human_video_rendering_tpu_torch.data.dataset import \
        SyntheticDataset
    from neural_human_video_rendering_tpu_torch.train.drivers import \
        save_checkpoint
    from neural_human_video_rendering_tpu_torch.utils import checkpoint as ckpt
    from neural_human_video_rendering_tpu_torch.utils.image import save_image
    base = TINY + ["--no_vgg_loss", "--checkpoints_dir", str(tmp_path),
                   "--name", "t", "--print_freq", "100"]
    src = str(tmp_path / "src")
    donor = tstate.create_train_state(
        dataclasses.replace(TrainOptions().parse(base, save=False), seed=5),
        np.zeros((24, 16, 16, 3), np.float32), np.zeros((32, 32, 3),
                                                        np.float32))
    if flag == "--img_path":
        syn = SyntheticDataset(TrainOptions().parse(base, save=False), length=4)
        for i in range(4):
            save_image(str(tmp_path / "frames" / f"frame{i:05d}.png"),
                       syn[i]["image"])
        st = run_train(TrainOptions().parse(
            base + [flag, str(tmp_path / "frames")]), max_steps=1)
        assert st.step == 1 and len(st.metrics) >= 3
    elif flag == "--continue_train":
        run_train(TrainOptions().parse(base), epochs=1)       # 8 steps
        st = run_train(TrainOptions().parse(base + [flag]), epochs=2,
                       max_steps=1)
        assert "resumed at epoch 2 (step 8" in capsys.readouterr().out
        assert st.start_epoch == 2 and st.step == 9
    elif flag == "--load_pretrain":
        save_checkpoint(src, donor, 4)
        st = run_train(TrainOptions().parse(
            base + [flag, src, "--which_epoch", "4"]), max_steps=0)
        for a, b in ((st.renderer, donor.renderer), (st.disc, donor.disc)):
            for (k, x), y in zip(a.state_dict().items(),
                                 b.state_dict().values()):
                assert torch.equal(x, y), k
    else:
        ckpt.save_net(src, "TransG", 2, donor.renderer.TransG.state_dict())
        st = run_train(TrainOptions().parse(
            base + [flag, src, "--which_epoch_TransG", "2"]), max_steps=0)
        for k, v in st.renderer.TransG.state_dict().items():
            assert torch.equal(v, donor.renderer.TransG.state_dict()[k]), k
        assert any(not torch.equal(v, donor.renderer.TexG.state_dict()[k])
                   for k, v in st.renderer.TexG.state_dict().items())
