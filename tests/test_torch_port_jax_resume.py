"""PyTorch port, --continue_train on a run dir the JAX package wrote: its
weights, both optax Adam states (moments and counts), the step, the LR
schedule's count and the --niter_fix_global freeze's count, through
``utils/checkpoint.load_train_state`` and ``train/drivers.resume_train``.

  * The optimizer state: JAX takes K optax updates on seeded random
    gradients and saves (save_net, save_train_state); the port resumes the
    dir. The moments are bit-equal to the bridged mu / nu (the bridge's
    layout change is a permutation), each parameter's Adam step is optax's
    count, the schedule and freeze positions are those of the JAX
    package's own resume (its tolerant restore and its fast-forward of a
    count still at 0: a --no_decay run resumed with decay), and the next
    updates on the same gradients equal optax's from the JAX package's
    resumed state within 1e-6 (test_adam_and_schedule_match_optax's
    tolerance). Across the freeze's end for --netG local.
  * The resumed train step: JAX takes 2 tiny train steps with its Adam and
    saves; JAX and the port each resume the dir and take one more step on
    the same batch. Losses within LOSS_RTOL 1e-5 and the parameter and
    EMA changes within the tolerances of test_torch_port_train_step.py
    (1e-5 * max|delta| over the module + 1e-4 * max|delta| of the tensor,
    plus one float32 spacing of the tensor's values: Adam's steps of
    ~1e-4 round there when stored), as there with every part blended, a
    linear atlas and TexG's last conv at zero (set in the saved G: a
    texel edge crossed on rounding would change the uv gradient). The
    biases ahead of instance norms (norm_cancelled_biases) have a gradient
    of rounding noise that Adam scales to steps of the learning rate's
    size, so for them the check is the update's arithmetic: optax's
    update from the JAX package's resumed state on the port's own
    gradients equals the port's step, for every parameter, within 1e-6.
  * The fixture of chip_smoke.py's phase 11(b)
    (neural_human_video_rendering_tpu_torch/testdata/jax_resume_tiny/):
    ``write_resume_fixture`` writes it with the JAX package, and a test
    writes it again and compares the bytes, so the committed copy is what
    the JAX package writes.
"""

import json
import os
import shutil

import flax.serialization as fser
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
from neural_human_video_rendering_tpu.utils import checkpoint as jckpt
from neural_human_video_rendering_tpu_torch.config import TrainOptions
from neural_human_video_rendering_tpu_torch.models.bridge import params_from_jax
from neural_human_video_rendering_tpu_torch.models.discriminator import \
    NLayerDiscriminator
from neural_human_video_rendering_tpu_torch.models.layers import (
    ConvNormRelu, Upsample)
from neural_human_video_rendering_tpu_torch.train import drivers
from neural_human_video_rendering_tpu_torch.train import state as tstate
from neural_human_video_rendering_tpu_torch.train.steps import make_train_step
from neural_human_video_rendering_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "neural_human_video_rendering_tpu_torch",
                       "testdata", "jax_resume_tiny")
ADAM_ATOL = 1e-6
LOSS_RTOL = 1e-5

# the fixture's model: every width at its least, so the run dir (G, D and
# both Adam states) stays under 1 MB
FIXTURE_FLAGS = dict(
    loadSize=32, tex_tile=8, batchSize=2, n_blocks_translate=1,
    n_downsample_translate=2, n_blocks_global=1, n_downsample_global=1,
    n_blocks_bg=0, n_downsample_bg=0, ngf=2, ngf_global=2, ndf=2, num_D=2,
    n_layers_D=2, dtype="float32", no_flip=True, pose_heatmaps=True,
    coord_conv=True, stem_s2d=1, head_s2d=1, bg_s2d=1, pad_mode="same",
    warp_topk=24, warp_eps=0.0, lambda_L2=500, lambda_UV=1000,
    lambda_Prob=10, lambda_Temp=500, use_densepose_loss=True,
    temporal_prev="real", no_vgg_loss=True, niter=1, niter_decay=3,
    lr=2e-3)
FIXTURE_SPE = 1          # steps an epoch: the schedule decays from step 1
FIXTURE_UPDATES = 3
FIXTURE_EPOCH = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(flags):
    out = []
    for k, v in flags.items():
        if v is True:
            out.append(f"--{k}")
        elif v is not False:
            out += [f"--{k}", str(v)]
    return out


def linear_atlas(P=24, T=8, seed=5):
    """(P, T, T, 3) atlas linear in the texel coordinates (chip_smoke's
    linear_atlas)."""
    yy, xx = np.mgrid[0:T, 0:T].astype(np.float32) / (T - 1)
    coef = np.random.default_rng(seed).uniform(-0.4, 0.4, (P, 3, 2))
    return (coef[:, None, None, :, 0] * xx[None, :, :, None]
            + coef[:, None, None, :, 1] * yy[None, :, :, None]
            ).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _grads(params, rng):
    return jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32) * 1e-2, _np(params))


def _optax_steps(tx, params, opt_state, grads):
    params = jax.tree.map(jnp.asarray, params)
    for g in grads:
        ups, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state,
                                   params)
        params = optax.apply_updates(params, ups)
    return _np(params), opt_state


def _zero_texg_head(g):
    """TexG's last conv at zero: the texture stays the linear atlas (a
    GlobalGenerator TexG; a LocalEnhancer one is left as it is)."""
    gg = g["TexG"].get("GlobalGenerator_0")
    if gg is None:
        return g
    head = max((k for k in gg if k.startswith("ConvNormRelu_")),
               key=lambda k: int(k.split("_")[1]))
    gg[head]["Conv_0"]["kernel"][...] = 0.0
    return g


def _jax_run(jopt, spe, n_updates, seed, run_dir, epoch):
    """A JAX run dir: the package's init, n_updates optax updates of G and
    D on seeded random gradients, saved as the JAX trainer saves
    (latest_net_G / latest_net_D and latest_state)."""
    syn = jds.SyntheticDataset(jopt, length=4)
    bundle = jstate.create_train_state(
        jopt, jax.random.PRNGKey(0), linear_atlas(jopt.n_parts, jopt.tex_tile),
        syn.background(), steps_per_epoch=spe)
    st = bundle["state"]
    rng = np.random.default_rng(seed)
    g, g_opt = _optax_steps(bundle["g_tx"], st.g_params, st.g_opt,
                            [_grads(st.g_params, rng)
                             for _ in range(n_updates)])
    d, d_opt = _optax_steps(bundle["d_tx"], st.d_params, st.d_opt,
                            [_grads(st.d_params, rng)
                             for _ in range(n_updates)])
    g = _zero_texg_head(g)
    st = st.replace(g_params=g, d_params=d, g_opt=g_opt, d_opt=d_opt,
                    step=jnp.int32(n_updates), g_ema=None)
    jckpt.save_net(run_dir, "G", "latest", g)
    jckpt.save_net(run_dir, "D", "latest", d)
    jckpt.save_train_state(run_dir, st, epoch)
    return st


def write_resume_fixture(dst):
    """Write chip_smoke's phase-11(b) fixture into `dst`: a tiny JAX run
    dir (latest_net_G, latest_net_D, latest_state .msgpack; FIXTURE_UPDATES
    updates into the LR decay, epoch FIXTURE_EPOCH completed) and
    flags.json, the port's flags and epoch length that resume it."""
    os.makedirs(dst, exist_ok=True)
    jopt = JOptions(**FIXTURE_FLAGS, use_pallas_warp=False)
    _jax_run(jopt, FIXTURE_SPE, FIXTURE_UPDATES, 11, dst, FIXTURE_EPOCH)
    with open(os.path.join(dst, "flags.json"), "w") as f:
        json.dump({"argv": _argv(FIXTURE_FLAGS),
                   "steps_per_epoch": FIXTURE_SPE,
                   "step": FIXTURE_UPDATES, "epoch": FIXTURE_EPOCH}, f,
                  indent=1)
        f.write("\n")


def test_resume_fixture_is_what_jax_writes(tmp_path):
    write_resume_fixture(str(tmp_path))
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(os.listdir(FIXTURE)) == [
        "flags.json", "latest_net_D.msgpack", "latest_net_G.msgpack",
        "latest_state.msgpack"]
    total = 0
    for name in names:
        with open(os.path.join(FIXTURE, name), "rb") as f:
            committed = f.read()
        assert (tmp_path / name).read_bytes() == committed, name
        total += len(committed)
    assert total < 1 << 20


def _jax_counts(opt_state):
    """(adam count, schedule count or None, freeze count or None) of an
    optax state of the JAX package's make_optimizer."""
    sd = fser.to_state_dict(opt_state)
    freeze = None
    if "mu" not in sd["0"]:
        freeze, sd = int(sd["0"]["count"]), sd["1"]
    sched = sd["1"].get("count")
    return (int(sd["0"]["count"]),
            None if sched is None else int(sched), freeze)


def _jax_resume(jopt, spe, run_dir):
    """The JAX package's --continue_train of run_dir (its run_train's
    ladder): the bundle, its state."""
    syn = jds.SyntheticDataset(jopt, length=4)
    bundle = jstate.create_train_state(
        jopt, jax.random.PRNGKey(1), linear_atlas(jopt.n_parts, jopt.tex_tile),
        syn.background(), steps_per_epoch=spe)
    st = bundle["state"]
    st = st.replace(
        g_params=jckpt.load_net(run_dir, "G", "latest", st.g_params),
        d_params=jckpt.load_net(run_dir, "D", "latest", st.d_params))
    if st.g_ema is not None:
        st = st.replace(g_ema=(jckpt.load_net(run_dir, "G_ema", "latest",
                                              st.g_ema)
                               if jckpt.has_latest(run_dir, "G_ema")
                               else jax.tree.map(jnp.copy, st.g_params)))
    st, epoch = jckpt.load_train_state(run_dir, st)
    return bundle, st, epoch


def _port_resume(flags, spe, root, name, bg=None):
    topt = TrainOptions().parse(_argv(flags) + [
        "--gpu_ids", "-1", "--checkpoints_dir", str(root), "--name", name,
        "--continue_train"], save=False)
    if bg is None:
        bg = np.zeros((topt.train_size, topt.train_size, 3), np.float32)
    st = tstate.create_train_state(
        topt, linear_atlas(topt.n_parts, topt.tex_tile), bg,
        steps_per_epoch=spe, device=torch.device("cpu"))
    start = drivers.resume_train(topt, st, spe)
    return topt, st, start


def _adam_state_by_name(optimizer, module):
    names = [n for n, _ in module.named_parameters()]
    return {names[i]: s for i, s in optimizer.state_dict()["state"].items()}


CASES = {
    # saved flags -> resumed flags, epoch length, updates before / after
    "decay": ({}, {}, 1, 3, 2),
    "no_decay_then_decay": ({"no_decay": True}, {}, 1, 3, 2),
    "local_freeze": ({"netG": "local", "niter_fix_global": 1, "loadSize": 64},
                     {"netG": "local", "niter_fix_global": 1, "loadSize": 64},
                     2, 1, 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_resume_maps_the_optimizer_state(case, tmp_path, capsys):
    saved_over, resumed_over, spe, k_before, k_after = CASES[case]
    saved = {**FIXTURE_FLAGS, **saved_over}
    resumed = {**FIXTURE_FLAGS, **resumed_over}
    run = str(tmp_path / "run")
    jst0 = _jax_run(JOptions(**saved, use_pallas_warp=False), spe, k_before,
                    3, run, 1)
    jopt = JOptions(**resumed, use_pallas_warp=False)
    bundle, jst, jepoch = _jax_resume(jopt, spe, run)
    topt, st, start = _port_resume(resumed, spe, tmp_path, "run")
    out = capsys.readouterr().out
    assert start == jepoch + 1 == 2 and st.step == int(jst.step) == k_before
    assert "optimizer state restored" in out
    assert ("optimizer structure changed" in out) == (case != "decay" and
                                                      case != "local_freeze")

    saved_counts = _jax_counts(jst0.g_opt)
    for mod, opt_, params, jopt_state, saved_opt in (
            (st.renderer, st.g_opt, jst.g_params, jst.g_opt, jst0.g_opt),
            (st.disc, st.d_opt, jst.d_params, jst.d_opt, jst0.d_opt)):
        want = params_from_jax(_np(params))
        for k, v in mod.state_dict().items():
            assert torch.equal(v, want[k]), k
        # moments bit-equal to the bridged mu / nu of the file
        sd = fser.to_state_dict(saved_opt)
        adam = sd["0"] if "mu" in sd["0"] else sd["1"]["0"]
        mu, nu = params_from_jax(_np(adam["mu"])), params_from_jax(
            _np(adam["nu"]))
        by_name = _adam_state_by_name(opt_, mod)
        assert by_name.keys() == want.keys()
        for k, s in by_name.items():
            assert torch.equal(s["exp_avg"], mu[k]), k
            assert torch.equal(s["exp_avg_sq"], nu[k]), k
            assert float(s["step"]) == saved_counts[0]
        adam_n, sched, freeze = _jax_counts(jopt_state)
        assert opt_.count == (sched if sched is not None else k_before)
        assert opt_.freeze_count == (freeze if freeze is not None
                                     else opt_.count)
    if case == "no_decay_then_decay":
        assert saved_counts[1] is None and _jax_counts(jst.g_opt)[1] == 3
    if case == "local_freeze":
        assert st.g_opt.frozen_steps == 2 and st.g_opt.freeze_count == 1

    # the next updates on the same gradients: optax from the JAX package's
    # resumed state against the port's resumed ScheduledAdam
    rng = np.random.default_rng(4)
    for tag, mod, opt_, tx, params, jopt_state in (
            ("G", st.renderer, st.g_opt, bundle["g_tx"], jst.g_params,
             jst.g_opt),
            ("D", st.disc, st.d_opt, bundle["d_tx"], jst.d_params, jst.d_opt)):
        grads = [_grads(params, rng) for _ in range(k_after)]
        ref, _ = _optax_steps(tx, params, jopt_state, grads)
        named = dict(mod.named_parameters())
        for g in grads:
            for k, t in params_from_jax(g).items():
                named[k].grad = t
            opt_.step()
        want = params_from_jax(ref)
        for k, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                       rtol=0, atol=ADAM_ATOL,
                                       err_msg=f"{case} {tag} {k}")


def norm_cancelled_biases(module):
    """Names of the biases whose gradient is zero in exact arithmetic: a
    conv's bias ahead of an instance norm, which subtracts it again.
    Rounding leaves noise there, and Adam's normalisation turns noise into
    steps the size of the learning rate with either sign, so the step's
    comparison holds these apart (it compares their updates on the same
    gradients instead)."""
    out = set()
    for name, m in module.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, ConvNormRelu) and m.norm is not None:
            out.add(f"{pre}Conv_0.bias")
        elif isinstance(m, Upsample):
            out.add(pre + ("Conv_0.bias" if m.mode == "resize"
                           else "ConvTranspose_0.bias"))
        elif isinstance(m, NLayerDiscriminator):
            out.update(f"{pre}Conv_{i}.bias"
                       for i in range(1, m.n_layers + 1))
    return out


STEP_FLAGS = dict(
    loadSize=32, tex_tile=16, batchSize=2, n_blocks_translate=1,
    n_downsample_translate=2, n_blocks_global=1, n_downsample_global=1,
    n_blocks_bg=1, n_downsample_bg=1, ngf=4, ngf_global=4, ndf=4, num_D=2,
    n_layers_D=2, dtype="float32", no_flip=True, pose_heatmaps=True,
    coord_conv=True, stem_s2d=2, head_s2d=2, bg_s2d=4, pad_mode="same",
    warp_topk=24, warp_eps=0.0, lambda_L2=500, lambda_UV=1000,
    lambda_Prob=10, lambda_Temp=500, use_densepose_loss=True,
    no_vgg_loss=True, ema_decay=0.999, temporal_prev="real", niter=1,
    niter_decay=3)


def _assert_deltas(name, got, ref, before, skip=()):
    """test_torch_port_train_step's check: per tensor, |got - ref| of the
    changes from `before`, plus one float32 spacing of the tensor's
    largest value: Adam's steps of ~1e-4 are stored in float32 parameters
    (SGD(1)'s steps there are large against it)."""
    dj = {k: ref[k] - before[k] for k in ref if k not in skip}
    scale = max(float(d.abs().max()) for d in dj.values())
    assert scale > 0
    for k, d in dj.items():
        err = float(((got[k] - before[k]) - d).abs().max())
        tol = (1e-5 * scale + 1e-4 * float(d.abs().max())
               + float(np.spacing(np.float32(ref[k].abs().max()))))
        assert err <= tol, f"{name} {k}: {err:.3e} > {tol:.3e}"


def _to_flax(grads, like):
    """Port gradients by state_dict name -> a flax tree shaped like `like`
    (the inverse of the bridge's permutation)."""
    flat = {}
    for path, arr in jax.tree_util.tree_flatten_with_path(like)[0]:
        keys = [p.key for p in path]
        name = ".".join(keys[:-1]) + (".weight" if keys[-1] == "kernel"
                                      else ".bias")
        t = grads[name].numpy()
        if keys[-1] == "kernel" and keys[-2].startswith("ConvTranspose_"):
            t = np.flip(t.transpose(2, 3, 0, 1), (0, 1))
        elif keys[-1] == "kernel":
            t = t.transpose(2, 3, 1, 0)
        flat[tuple(keys)] = np.ascontiguousarray(t)

    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (k,)) for k, v in tree.items()}
        return flat[prefix]

    return build(_np(like), ())


def test_resumed_step_matches_jax(tmp_path):
    spe = 1
    jopt = JOptions(**STEP_FLAGS, use_pallas_warp=False)
    syn = jds.SyntheticDataset(jopt, length=6)
    atlas, bg = linear_atlas(T=16), syn.background()
    bundle = jstate.create_train_state(jopt, jax.random.PRNGKey(0), atlas,
                                       bg, steps_per_epoch=spe)
    jstep = jsteps.make_train_step(jopt, bundle["renderer"], bundle["disc"],
                                   None, bundle["g_tx"], bundle["d_tx"])

    def batch(i, j):
        return jds.collate([syn[i], syn[j]])

    jst = bundle["state"]
    for ij in ((0, 1), (2, 3)):
        jst, _ = jstep(jst, {k: jnp.asarray(v) for k, v in batch(*ij).items()})
    run = str(tmp_path / "run")
    jst = jst.replace(g_params=_zero_texg_head(_np(jst.g_params)))
    for label, tree in (("G", jst.g_params), ("D", jst.d_params),
                        ("G_ema", jst.g_ema)):
        jckpt.save_net(run, label, 2, _np(tree))
    jckpt.save_train_state(run, jst, 2)

    # JAX resumes and steps
    _, jres, _ = _jax_resume(jopt, spe, run)
    b = batch(1, 2)          # unclipped joints (ROADMAP hazard 7)
    # copies: the jitted step donates its state's buffers
    jres_g_opt, jres_g = _np(jres.g_opt), _np(jres.g_params)
    jres_d_opt, jres_d = _np(jres.d_opt), _np(jres.d_params)
    jnext, jm = jstep(jres, {k: jnp.asarray(v) for k, v in b.items()})

    # the port resumes and steps
    topt, st, start = _port_resume(STEP_FLAGS, spe, tmp_path, "run", bg)
    assert start == 3 and st.step == 2
    for mod, ref in ((st.renderer, jres_g), (st.disc, jres_d)):
        for k, v in params_from_jax(ref).items():
            assert torch.equal(mod.state_dict()[k], v), k
    before = {"G": {k: v.clone() for k, v in st.renderer.state_dict().items()},
              "D": {k: v.clone() for k, v in st.disc.state_dict().items()},
              "EMA": {k: v.clone() for k, v in st.g_ema.items()}}
    step = make_train_step(topt, st.renderer, st.disc, None, st.g_opt,
                           st.d_opt)
    tm = step(st, b)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert st.step == int(jnext.step) == 3
    assert st.g_opt.count == st.d_opt.count == 3
    for tag, mod, ref in (("G", st.renderer, jnext.g_params),
                          ("D", st.disc, jnext.d_params)):
        _assert_deltas(tag, mod.state_dict(), params_from_jax(_np(ref)),
                       before[tag], skip=norm_cancelled_biases(mod))
    _assert_deltas("EMA", st.g_ema, params_from_jax(_np(jnext.g_ema)),
                   before["EMA"], skip=norm_cancelled_biases(
                       st.renderer))

    # every parameter: optax's update from the JAX resumed state on the
    # port's own gradients is the port's step
    for tag, mod, tx, params, opt_state in (
            ("G", st.renderer, bundle["g_tx"], jres_g, jres_g_opt),
            ("D", st.disc, bundle["d_tx"], jres_d, jres_d_opt)):
        grads = {k: p.grad for k, p in mod.named_parameters()}
        ref, _ = _optax_steps(tx, params, opt_state,
                              [_to_flax(grads, params)])
        want = params_from_jax(ref)
        for k, v in mod.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                       atol=ADAM_ATOL, err_msg=f"{tag} {k}")


def test_pretrain_resumes_jax_weights_and_anchor(tmp_path, capsys):
    """Stage 1 of a JAX run: latest_net_TransG.msgpack and the epoch
    anchor (the JAX pretrain saves no optimizer state): the port resumes
    the weights with a fresh Adam after the anchored epoch."""
    jopt = JOptions(**FIXTURE_FLAGS, use_pallas_warp=False)
    syn = jds.SyntheticDataset(jopt, length=4)
    bundle = jstate.create_train_state(
        jopt, jax.random.PRNGKey(0), linear_atlas(), syn.background())
    transg = _np(bundle["state"].g_params["TransG"])
    run = tmp_path / "uv"
    jckpt.save_net(str(run), "TransG", "latest", transg)
    jckpt.save_epoch_anchor(str(run), 3)
    topt = TrainOptions().parse(_argv(FIXTURE_FLAGS) + [
        "--gpu_ids", "-1", "--checkpoints_dir", str(tmp_path), "--name", "uv",
        "--continue_train", "--niter", "5"], save=False)
    st = drivers.run_pretrain_uv(topt, max_steps=0)
    assert "resumed at epoch 4" in capsys.readouterr().out
    want = params_from_jax(transg)
    for k, v in st.net.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert st.optimizer.count == 0 and not st.optimizer.state
    shutil.rmtree(run)
