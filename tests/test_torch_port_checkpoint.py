"""PyTorch port, checkpoints: the JAX package's .msgpack files read by the
port (G, G_ema, D and TransG of random-init tiny models; the forward of
each loaded module against the JAX forward), the msgpack reader on what
flax writes (bf16 leaves, numpy scalars, chunked arrays refused), the
port's .pth files (round trip, latest-only saves with the epoch anchor,
the partial TransG restore), and resume: N + M steps straight equal N
steps, a save, a fresh process state, a load and M steps, exactly.

Tolerances: the forwards 1e-4 absolute (the tolerance of
test_torch_port_models.py for whole networks: float32 convolutions summed
in another order); everything read back from a file, and the resumed
run, exactly (CPU float32, the same operations in the same order).
"""

import json
import os

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu.config import Options as JOptions
from neural_human_video_rendering_tpu.models import generators as jg
from neural_human_video_rendering_tpu.train import state as jstate
from neural_human_video_rendering_tpu.train import steps as jsteps
from neural_human_video_rendering_tpu.utils import checkpoint as jckpt
from neural_human_video_rendering_tpu_torch.config import TestOptions
from neural_human_video_rendering_tpu_torch.config import TrainOptions
from neural_human_video_rendering_tpu_torch.data.dataset import SyntheticDataset
from neural_human_video_rendering_tpu_torch.infer import test_driver as td
from neural_human_video_rendering_tpu_torch.models.bridge import params_from_jax
from neural_human_video_rendering_tpu_torch.models.discriminator import \
    discriminator_from_options
from neural_human_video_rendering_tpu_torch.models.renderer import (
    init_params, renderer_from_options)
from neural_human_video_rendering_tpu_torch.train import drivers
from neural_human_video_rendering_tpu_torch.train.steps import make_forward_fn
from neural_human_video_rendering_tpu_torch.utils import checkpoint as ckpt
from neural_human_video_rendering_tpu_torch.utils import flax_msgpack

NET_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's CPU thread pool slows many-fold when they share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

FLAGS = dict(loadSize=32, tex_tile=16, batchSize=2, n_blocks_translate=1,
             n_downsample_translate=2, n_blocks_global=1,
             n_downsample_global=1, n_blocks_bg=1, n_downsample_bg=1, ngf=4,
             ngf_global=4, ndf=4, num_D=2, n_layers_D=2, dtype="float32",
             no_flip=True, pose_heatmaps=True, coord_conv=True, stem_s2d=2,
             head_s2d=2, bg_s2d=4, pad_mode="same", warp_topk=24,
             warp_eps=0.0, ema_decay=0.999)
TINY = [f"--{k}" if v is True else f"--{k} {v}" for k, v in FLAGS.items()]
TINY = " ".join(TINY).split() + ["--gpu_ids", "-1"]


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape)
        .astype(np.float32), tree)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX run dir at epoch 3: G, G_ema (other weights), D, TransG, as
    the JAX package's trainer writes them."""
    root = tmp_path_factory.mktemp("jaxrun")
    jopt = JOptions(**FLAGS, use_pallas_warp=False, no_vgg_loss=True,
                    checkpoints_dir=str(root), name="run")
    syn = SyntheticDataset(TrainOptions().parse(TINY, save=False), length=4)
    tex, bg = syn.texture_atlas(), syn.background()
    bundle = jstate.create_train_state(jopt, jax.random.PRNGKey(0), tex, bg)
    g = _perturbed(bundle["state"].g_params, 1)
    g_ema = _perturbed(g, 2)
    d = _perturbed(bundle["state"].d_params, 3)
    run = os.path.join(str(root), "run")
    for label, tree in (("G", g), ("G_ema", g_ema), ("D", d),
                        ("TransG", g["TransG"])):
        jckpt.save_net(run, label, 3, tree)
    joints = syn.joints[:2]
    fwd = jsteps.make_forward_fn(jopt, bundle["renderer"])
    fake = {name: np.asarray(fwd(params, (jnp.asarray(tex), jnp.asarray(bg),
                                          None), jnp.asarray(joints))["fake"])
            for name, params in (("G", g), ("G_ema", g_ema))}
    return dict(jopt=jopt, root=str(root), run=run, g=g, d=d, tex=tex, bg=bg,
                bundle=bundle, joints=joints, fake=fake)


@pytest.mark.parametrize("no_ema", [False, True])
def test_build_renderer_loads_jax_checkpoint(jax_run, no_ema, capsys):
    """build_renderer on a JAX run dir: G_ema unless --no_ema, then G;
    its forward equals the JAX forward of the same weights."""
    opt = TestOptions().parse(TINY + [
        "--checkpoints_dir", jax_run["root"], "--name", "run",
        "--which_epoch", "3"] + (["--no_ema"] if no_ema else []), save=False)
    renderer = td.build_renderer(opt, torch.device("cpu"))
    label = "G" if no_ema else "G_ema"
    assert f"loaded {label} epoch 3" in capsys.readouterr().out
    fwd = make_forward_fn(opt, renderer)
    got = fwd(td.assets_to_device(opt, jax_run["tex"], jax_run["bg"],
                                  torch.device("cpu")),
              torch.from_numpy(jax_run["joints"]))["fake"]
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               jax_run["fake"][label], atol=NET_ATOL)


def test_jax_discriminator_and_transg_files(jax_run):
    """D into the discriminator and TransG into renderer.TransG (the
    --load_pretrain_TransG partial restore) from JAX files."""
    opt = TrainOptions().parse(TINY, save=False)
    disc = init_params(discriminator_from_options(opt), 9)
    ckpt.load_net_into(disc, jax_run["run"], "D", 3)
    x = np.random.default_rng(4).standard_normal(
        (2, 32, 32, opt.pose_nc + 3)).astype(np.float32)
    ref = jax_run["bundle"]["disc"].apply({"params": jax_run["d"]},
                                          jnp.asarray(x))
    with torch.no_grad():
        got = disc(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    for gs, rs in zip(got, ref):
        for a, b in zip(gs, rs):
            np.testing.assert_allclose(a.numpy().transpose(0, 2, 3, 1),
                                       np.asarray(b), atol=NET_ATOL)
    renderer = init_params(renderer_from_options(opt), 9)
    before = {k: v.clone() for k, v in renderer.TexG.state_dict().items()}
    ckpt.load_transg_into(renderer, jax_run["run"], 3)
    pose = jnp.asarray(np.random.default_rng(5).standard_normal(
        (2, 32, 32, opt.pose_nc)).astype(np.float32))
    jo = jax_run["jopt"]
    j_transg = jg.TransG(jo.n_parts, jo.ngf, jo.n_downsample_translate,
                         jo.n_blocks_translate, stem_s2d=jo.stem_s2d,
                         head_s2d=jo.head_s2d, pad_mode=jo.pad_mode,
                         dtype=jnp.float32)
    j_logits, j_uv = j_transg.apply({"params": jax_run["g"]["TransG"]},
                                    pose)[:2]
    with torch.no_grad():
        logits, uv = renderer.TransG(torch.from_numpy(
            np.asarray(pose).transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(logits.numpy().transpose(0, 2, 3, 1),
                               np.asarray(j_logits), atol=NET_ATOL)
    np.testing.assert_allclose(uv.numpy().transpose(0, 3, 4, 1, 2),
                               np.asarray(j_uv), atol=NET_ATOL)
    for k, v in renderer.TexG.state_dict().items():      # untouched
        assert torch.equal(v, before[k])


def test_strict_load_refuses_a_mismatched_file(jax_run):
    opt = TrainOptions().parse(TINY, save=False)
    renderer = init_params(renderer_from_options(opt), 0)
    with pytest.raises(RuntimeError):           # D's keys into G
        ckpt.load_net_into(renderer, jax_run["run"], "D", 3)


def test_msgpack_reader_matches_flax(tmp_path):
    tree = {"a": {"kernel": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
                  "bias": np.zeros(4, np.float32)},
            "bf16": np.asarray(jnp.linspace(-2, 3, 7, dtype=jnp.bfloat16)),
            "scalar": np.float32(2.5), "count": np.int32(-7), "n": 300,
            "neg": -40000, "f": 0.125, "flag": True, "none": None,
            "name": "x" * 40, "i64": np.arange(3, dtype=np.int64),
            "wide": {str(i): np.uint8(i) for i in range(20)}}
    blob = fser.msgpack_serialize(tree)
    got = flax_msgpack.restore_bytes(blob)
    ref = fser.msgpack_restore(blob)
    assert got.keys() == ref.keys()
    np.testing.assert_array_equal(got["a"]["kernel"], ref["a"]["kernel"])
    assert got["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bf16"].float().numpy(),
                                  np.asarray(ref["bf16"], np.float32))
    assert got["scalar"] == np.float32(2.5) and got["scalar"].dtype == np.float32
    assert got["count"] == -7 and got["count"].dtype == np.int32
    for k in ("n", "neg", "f", "flag", "none", "name"):
        assert got[k] == ref[k]
    np.testing.assert_array_equal(got["i64"], ref["i64"])
    assert got["wide"]["19"] == 19
    (tmp_path / "x.msgpack").write_bytes(blob)
    assert flax_msgpack.restore(str(tmp_path / "x.msgpack"))["n"] == 300
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.restore_bytes(blob[:-3])


def test_msgpack_reader_refuses_chunked_arrays(monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 16)
    blob = fser.msgpack_serialize({"w": np.zeros(64, np.float32)})
    with pytest.raises(ValueError, match="chunk"):
        flax_msgpack.restore_bytes(blob)


def test_pth_round_trip_and_formats(tmp_path, jax_run):
    opt = TrainOptions().parse(TINY, save=False)
    renderer = init_params(renderer_from_options(opt), 1)
    run = str(tmp_path / "run")
    path = ckpt.save_net(run, "G", 7, renderer.state_dict())
    assert sorted(os.listdir(run)) == ["7_net_G.pth", "latest_net_G.pth"]
    assert ckpt.latest_epoch(run, "G") == "7" and ckpt.has_latest(run, "G")
    for tag in (7, "latest"):
        sd = ckpt.load_net(run, "G", tag)
        assert sd.keys() == renderer.state_dict().keys()
        for k, v in renderer.state_dict().items():
            assert torch.equal(sd[k], v)
    raw = torch.load(path, weights_only=True)
    assert all(isinstance(v, torch.Tensor) for v in raw.values())
    # .pth first where both formats hold the epoch
    jckpt.save_net(run, "G", 7, jax_run["g"])
    assert ckpt.find_net(run, "G", 7).endswith(".pth")
    os.remove(path)
    assert ckpt.find_net(run, "G", 7).endswith(".msgpack")
    assert ckpt.latest_epoch(str(tmp_path / "none"), "G") is None
    with pytest.raises(FileNotFoundError):
        ckpt.load_net(run, "TexG")


def test_scheduled_adam_state_dict_carries_count():
    opt = TrainOptions().parse(TINY + ["--niter", "1", "--niter_decay", "2"],
                               save=False)
    from neural_human_video_rendering_tpu_torch.train.state import make_optimizer
    p = [torch.nn.Parameter(torch.ones(3))]
    a = make_optimizer(opt, p, steps_per_epoch=2)
    for _ in range(3):
        p[0].grad = torch.ones(3)
        a.step()
    sd = a.state_dict()
    assert sd["count"] == 3
    q = [torch.nn.Parameter(torch.ones(3))]
    b = make_optimizer(opt, q, steps_per_epoch=2)
    b.load_state_dict(sd)
    assert b.count == 3
    # a state without moments for these parameters: kept fresh, the count
    # fast-forwarded to the step so the schedule resumes in place
    c = make_optimizer(opt, [torch.nn.Parameter(torch.ones(3)),
                             torch.nn.Parameter(torch.ones(2))], 2)
    ckpt._tolerant_load(c, sd, "g_opt", 5)
    assert c.count == 5 and not c.state


def test_latest_only_save_resumes_at_its_anchor(tmp_path, capsys):
    """Stage 1 saved only by --save_latest_freq (no epoch file): the epoch
    anchor says where, and --continue_train resumes after it."""
    base = TINY + ["--checkpoints_dir", str(tmp_path), "--name", "uv",
                   "--niter", "3", "--save_epoch_freq", "100",
                   "--save_latest_freq", "10", "--print_freq", "100"]
    st = drivers.run_pretrain_uv(TrainOptions().parse(base), max_steps=12)
    run = str(tmp_path / "uv")
    assert st.step == 12
    assert sorted(f for f in os.listdir(run) if "net" in f) == [
        "latest_net_TransG.pth"]
    assert ckpt.load_epoch_anchor(run) == 1     # saved at step 10, epoch 2
    saved = ckpt.load_net(run, "TransG")
    st2 = drivers.run_pretrain_uv(TrainOptions().parse(
        base + ["--continue_train"]), max_steps=0)
    assert "resumed at epoch 2" in capsys.readouterr().out
    for k, v in st2.net.state_dict().items():
        assert torch.equal(v, saved[k])


def test_continue_train_refuses_a_jax_run(jax_run):
    """--continue_train on the JAX run dir with other model flags (ngf 8,
    the run's is 4): the strict load refuses its G, before anything is
    written (a JAX run of this model resumes: the next test)."""
    opt = TrainOptions().parse(TINY + [
        "--checkpoints_dir", jax_run["root"], "--name", "run",
        "--continue_train", "--no_vgg_loss", "--ngf", "8"], save=False)
    before = sorted(os.listdir(jax_run["run"]))
    with pytest.raises(RuntimeError, match="size mismatch"):
        drivers.run_train(opt, max_steps=0)
    assert sorted(os.listdir(jax_run["run"])) == before


def test_continue_train_resumes_a_jax_run(jax_run, tmp_path, capsys):
    """--continue_train on the JAX run dir (a copy: weights at epoch 3, no
    latest_state blob): G, D and G_ema from its .msgpack files, fresh
    optimizers and step 0, epoch 4 next, as the JAX package resumes such a
    dir (its load_train_state returns None)."""
    import shutil
    shutil.copytree(jax_run["run"], str(tmp_path / "run"))
    opt = TrainOptions().parse(TINY + [
        "--checkpoints_dir", str(tmp_path), "--name", "run",
        "--continue_train", "--no_vgg_loss"], save=False)
    st = drivers.run_train(opt, max_steps=0)
    assert "resumed at epoch 4 (step 0, optimizer state fresh)" in \
        capsys.readouterr().out
    assert st.start_epoch == 4 and st.step == 0
    for o in (st.g_opt, st.d_opt):
        assert o.count == 0 and o.freeze_count == 0 and not o.state
    for got, want in ((st.renderer.state_dict(), params_from_jax(jax_run["g"])),
                      (st.disc.state_dict(), params_from_jax(jax_run["d"])),
                      (st.g_ema, ckpt.load_net(jax_run["run"], "G_ema"))):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert not any(f.endswith(ckpt.EXT) for f in os.listdir(tmp_path / "run"))


def _state_tensors(st):
    out = {f"G.{k}": v for k, v in st.renderer.state_dict().items()}
    out.update({f"D.{k}": v for k, v in st.disc.state_dict().items()})
    out.update({f"EMA.{k}": v for k, v in st.g_ema.items()})
    for name, o in (("g_opt", st.g_opt), ("d_opt", st.d_opt)):
        for i, s in o.state_dict()["state"].items():
            for k, v in s.items():
                out[f"{name}.{i}.{k}"] = v
    return out


def test_resume_is_exact(tmp_path):
    """2 epochs straight == 1 epoch, the epoch save, --continue_train into
    a fresh state, 1 epoch: weights, both Adam states and counts, the EMA,
    the step and the loader's order (through the losses of each step)."""
    base = TINY + ["--checkpoints_dir", str(tmp_path), "--no_vgg_loss",
                   "--lambda_L2", "500", "--lambda_UV", "1000",
                   "--lambda_Prob", "10", "--lambda_Temp", "500",
                   "--temporal_prev", "real", "--use_densepose_loss",
                   "--batchSize", "8", "--niter", "2", "--niter_decay", "1",
                   "--print_freq", "100", "--save_latest_freq", "0"]
    straight = drivers.run_train(TrainOptions().parse(base + ["--name", "a"]),
                                 epochs=2)
    drivers.run_train(TrainOptions().parse(base + ["--name", "b"]), epochs=1)
    assert ckpt.latest_epoch(str(tmp_path / "b"), "G") == "1"
    resumed = drivers.run_train(TrainOptions().parse(
        base + ["--name", "b", "--continue_train"]), epochs=2)
    assert resumed.start_epoch == 2
    assert resumed.step == straight.step == 8        # 32 samples, batch 8
    assert resumed.g_opt.count == straight.g_opt.count == 8
    assert resumed.d_opt.count == 8
    a, b = _state_tensors(straight), _state_tensors(resumed)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k in straight.metrics:
        assert torch.equal(straight.metrics[k], resumed.metrics[k]), k


def test_prune_metrics_after_matches_jax(tmp_path):
    """The resume path's metrics.jsonl pruning, on a copy of one file
    each: the same records kept (epochs <= the last kept, and lines that
    are not records), the same count dropped."""
    from neural_human_video_rendering_tpu.utils.visualizer import \
        prune_metrics_after as j_prune
    from neural_human_video_rendering_tpu_torch.utils.visualizer import \
        prune_metrics_after as t_prune
    lines = ['{"epoch": 1, "G_L2": 1.5}\n', "not json\n",
             '{"epoch": 2, "it": -1, "val_PSNR": 20.0}\n', '{"G_L2": 3}\n',
             '{"epoch": 3, "G_L2": 0.5}\n']
    got = {}
    for name, fn in (("jax", j_prune), ("port", t_prune)):
        run = tmp_path / name
        run.mkdir()
        (run / "metrics.jsonl").write_text("".join(lines))
        got[name] = (fn(str(run), 1), (run / "metrics.jsonl").read_text())
    assert got["port"] == got["jax"]
    assert got["port"][0] == 2


def test_tf_log_is_refused_without_tensorboard(tmp_path, monkeypatch):
    """--tf_log where torch.utils.tensorboard does not import: the port
    falls back to logs/scalars.jsonl as the JAX Visualizer does, and
    writes the same line for the same log_losses call (JAX's own check:
    tests/test_visualizer.py::test_tf_log_scalars)."""
    import builtins
    import dataclasses

    from neural_human_video_rendering_tpu.utils.visualizer import \
        Visualizer as JVisualizer
    from neural_human_video_rendering_tpu_torch.utils.visualizer import \
        Visualizer
    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kw):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    opt = TrainOptions().parse(TINY + ["--checkpoints_dir",
                                       str(tmp_path / "port"), "--tf_log"],
                               save=False)
    jopt = dataclasses.replace(JOptions(**FLAGS), name=opt.name, tf_log=True,
                               checkpoints_dir=str(tmp_path / "jax"))
    lines = {}
    for name, vis in (("port", Visualizer(opt)), ("jax", JVisualizer(jopt))):
        assert vis.tb is None
        vis.log_losses(epoch=2, it=5, losses={"G_total": 3.0, "D_real": 0.25},
                       step=105)
        vis.log_losses(epoch=2, it=6, losses={"G_total": np.float32(2.5)},
                       step=106)
        vis.close()
        assert vis.jsonl.closed
        lines[name] = (tmp_path / name / opt.name / "logs" /
                       "scalars.jsonl").read_text()
    assert lines["port"] == lines["jax"]
    assert json.loads(lines["port"].splitlines()[0]) == {
        "step": 105, "G_total": 3.0, "D_real": 0.25}


def test_forked_metrics_jsonl_leaves_the_parent_alone(tmp_path):
    """A run dir forked with `cp -al` shares metrics.jsonl's inode with its
    parent: the fork's Visualizer rewrites a private copy before appending,
    so the parent's bytes stay (the metrics counterpart of
    tests/test_checkpoint.py::test_save_breaks_hardlinks)."""
    from neural_human_video_rendering_tpu_torch.utils.visualizer import \
        Visualizer
    parent, fork = tmp_path / "parent", tmp_path / "ckpt" / "fork"
    parent.mkdir()
    fork.mkdir(parents=True)
    before = b'{"epoch": 1, "it": 0, "step": 1, "G_total": 1.0}\n'
    (parent / "metrics.jsonl").write_bytes(before)
    os.link(parent / "metrics.jsonl", fork / "metrics.jsonl")
    opt = TrainOptions().parse(TINY + ["--checkpoints_dir",
                                       str(tmp_path / "ckpt"), "--name",
                                       "fork", "--no_html"], save=False)
    vis = Visualizer(opt)
    vis.log_losses(epoch=2, it=0, losses={"G_total": 0.5}, step=2)
    vis.close()
    assert (parent / "metrics.jsonl").read_bytes() == before
    assert os.stat(parent / "metrics.jsonl").st_nlink == 1
    forked = (fork / "metrics.jsonl").read_bytes()
    assert forked.startswith(before) and forked.count(b"\n") == 2


def _dedup_case(name):
    """The four files tests/test_metrics_dedup.py builds for dedup_metrics."""
    def loss(e, s):
        return {"epoch": e, "it": 0, "step": s, "G_total": 1.0}

    def val(e, s):
        return {"epoch": e, "it": -1, "step": s, "val_PSNR": 20.0 + e}

    if name == "full_restart":
        a = [r for e in range(1, 6) for r in (loss(e, e * 3), val(e, e * 3))]
        b = [r for e in range(1, 8) for r in (loss(e, e * 3), val(e, e * 3))]
        return a + b
    if name == "resume":
        return ([val(e, e * 3) for e in range(1, 11)]
                + [val(e, e * 3) for e in range(6, 13)])
    if name == "clean":
        return [r for e in range(1, 5) for r in
                (loss(e, e * 3 - 1), loss(e, e * 3), val(e, e * 3))]
    assert name == "step_reset"
    return [loss(1, 1), loss(1, 2), loss(2, 3), loss(2, 1), loss(3, 2)]


@pytest.mark.parametrize("case", ["full_restart", "resume", "clean",
                                  "step_reset"])
def test_dedup_metrics_matches_jax(tmp_path, case):
    """dedup_metrics against the JAX function on a copy of the same file:
    the same count dropped and the same bytes afterwards."""
    from neural_human_video_rendering_tpu.utils.visualizer import \
        dedup_metrics as j_dedup
    from neural_human_video_rendering_tpu_torch.utils.visualizer import \
        dedup_metrics as t_dedup
    text = "".join(json.dumps(r) + "\n" for r in _dedup_case(case))
    got = {}
    for name, fn in (("jax", j_dedup), ("port", t_dedup)):
        run = tmp_path / name
        run.mkdir()
        (run / "metrics.jsonl").write_text(text)
        got[name] = (fn(str(run)), (run / "metrics.jsonl").read_text())
    assert got["port"] == got["jax"]
    assert got["port"][0] == {"full_restart": 10, "resume": 5, "clean": 0,
                              "step_reset": 1}[case]


def _nchw_copy(obj):
    """A saved object with every tensor made NCHW-contiguous: the files of
    the port before its conv weights were held channels_last."""
    if isinstance(obj, dict):
        return {k: _nchw_copy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_nchw_copy(v) for v in obj]
    return obj.contiguous() if isinstance(obj, torch.Tensor) else obj


def _is_cl(t):
    return t.is_contiguous(memory_format=torch.channels_last)


def test_nchw_saved_run_resumes_into_channels_last_models(tmp_path):
    """A run dir whose every file holds NCHW tensors (G, G_ema, D and both
    Adam states) resumes with --continue_train into the channels_last
    models exactly as 2 epochs straight: weights, moments, EMA and losses
    equal; the resumed weights and moments channels_last. Then a
    channels_last save loads into an NCHW model, values equal and the
    model's layout kept."""
    base = TINY + ["--checkpoints_dir", str(tmp_path), "--no_vgg_loss",
                   "--lambda_L2", "500", "--lambda_UV", "1000",
                   "--lambda_Prob", "10", "--lambda_Temp", "500",
                   "--temporal_prev", "real", "--use_densepose_loss",
                   "--batchSize", "8", "--niter", "2", "--niter_decay", "1",
                   "--print_freq", "100", "--save_latest_freq", "0"]
    straight = drivers.run_train(TrainOptions().parse(base + ["--name", "a"]),
                                 epochs=2)
    drivers.run_train(TrainOptions().parse(base + ["--name", "b"]), epochs=1)
    run = str(tmp_path / "b")
    saved = sorted(f for f in os.listdir(run) if f.endswith(".pth"))
    assert "latest_state.pth" in saved and "1_net_G.pth" in saved
    cl = 0
    for f in saved:
        path = os.path.join(run, f)
        blob = torch.load(path, map_location="cpu", weights_only=True)
        cl += sum(1 for v in (blob.values() if f != "latest_state.pth"
                              else blob["g_opt"]["state"][0].values())
                  if isinstance(v, torch.Tensor) and v.dim() == 4
                  and not v.is_contiguous() and _is_cl(v))
        torch.save(_nchw_copy(blob), path)
    assert cl > 0                           # the port saves channels_last
    resumed = drivers.run_train(TrainOptions().parse(
        base + ["--name", "b", "--continue_train"]), epochs=2)
    a, b = _state_tensors(straight), _state_tensors(resumed)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k in straight.metrics:
        assert torch.equal(straight.metrics[k], resumed.metrics[k]), k
    convs = [p for m in (resumed.renderer, resumed.disc)
             for p in m.parameters() if p.dim() == 4]
    assert convs and all(_is_cl(p) for p in convs)
    for o in (resumed.g_opt, resumed.d_opt):
        for p, s in o.state.items():
            assert s["exp_avg"].stride() == s["exp_avg_sq"].stride() \
                == p.stride()
    assert all(_is_cl(t) for t in resumed.g_ema.values() if t.dim() == 4)
    # a channels_last save into an NCHW model
    opt = TrainOptions().parse(TINY, save=False)
    nchw = init_params(renderer_from_options(opt), 5)
    for p in nchw.parameters():
        p.data = p.data.contiguous()
    ckpt.load_net_into(nchw, os.path.join(str(tmp_path), "a"), "G", 2)
    for k, v in nchw.state_dict().items():
        assert v.is_contiguous(), k
        assert torch.equal(v, straight.renderer.state_dict()[k]), k


def test_jax_and_torch_imports_give_channels_last_weights(jax_run, tmp_path):
    """params_from_jax lays every conv kernel out channels_last (values
    the flax kernel's permutation), and a pix2pixHD .pth imported by
    import_torch_checkpoint lands in channels_last weights."""
    from neural_human_video_rendering_tpu_torch import \
        import_torch_checkpoint as itc
    from neural_human_video_rendering_tpu_torch.utils import \
        torch_import as ti
    sd = params_from_jax(jax.tree.map(np.asarray, jax_run["g"]))
    kernels = {k: v for k, v in sd.items() if v.dim() == 4}
    assert kernels and all(_is_cl(v) and not v.is_contiguous()
                           for v in kernels.values())
    k = "TransG.GlobalGenerator_0.ConvNormRelu_0.Conv_0.weight"
    flax = np.asarray(jax_run["g"]["TransG"]["GlobalGenerator_0"][
        "ConvNormRelu_0"]["Conv_0"]["kernel"])
    np.testing.assert_array_equal(kernels[k].numpy(),
                                  flax.transpose(3, 2, 0, 1))
    opt = TrainOptions().parse(TINY, save=False)
    gg = itc.parity_options(opt)
    net = getattr(init_params(renderer_from_options(gg), 0), "BGNet")
    g = net.GlobalGenerator_0
    ref = ti.pix2pixhd_global_generator(
        3, 3, g.ConvNormRelu_0.Conv_0.weight.shape[0],
        sum(n.startswith("Upsample_") for n in g.order),
        sum(n.startswith("ResnetBlock_") for n in g.order))
    path = str(tmp_path / "bg.pth")
    torch.save(ref.state_dict(), path)
    imported = itc.import_checkpoint(path, "BGNet", opt)
    weights = [p for p in imported.parameters() if p.dim() == 4]
    assert weights and all(_is_cl(p) and not p.is_contiguous()
                           for p in weights)
    assert torch.equal(imported.GlobalGenerator_0.ConvNormRelu_0.Conv_0.weight,
                       ref.state_dict()["1.weight"])
