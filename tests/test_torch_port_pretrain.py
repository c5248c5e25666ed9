"""PyTorch port, the pretrain stages and held-out metrics: one stage-1 UV
step and one texture pretrain step against the JAX package's jitted steps
(same weights, same batch), PSNR / SSIM against ``utils/metrics.py``, and
the whole pipeline through the drivers on the CPU: stage 1 -> texture
pretrain -> stage 2 with --load_pretrain_TransG, a held-out split and a
mid-epoch 'latest' save -> --continue_train -> rendering from the run dir.

The steps run float32 with plain SGD (lr 1) on both sides, so each
parameter's change is its gradient. The batch is the synthetic frames 0
and 1: at 32 px later frames clip joints to the border, where coincident
joints make equidistant limbs and the skeleton render's nearest-limb tie
flips on float rounding between XLA and torch. Tolerances: losses 1e-5
relative; parameter changes per tensor 1e-5 * max|change| over the net +
1e-4 * max|change| of the tensor (float32 sums in another order); PSNR
1e-5 dB and SSIM 1e-6 absolute. The pipeline's checks are exact (the same CPU
operations on both sides of each comparison).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neural_human_video_rendering_tpu.config import Options as JOptions
from neural_human_video_rendering_tpu.data import dataset as jds
from neural_human_video_rendering_tpu.models import generators as jg
from neural_human_video_rendering_tpu.train import steps as jsteps
from neural_human_video_rendering_tpu.utils import metrics as jmetrics
from neural_human_video_rendering_tpu_torch import pre_train, pre_train_tex
from neural_human_video_rendering_tpu_torch.config import Options as TOptions
from neural_human_video_rendering_tpu_torch.config import (TestOptions,
                                                           TrainOptions)
from neural_human_video_rendering_tpu_torch.data.dataset import SyntheticDataset
from neural_human_video_rendering_tpu_torch.data.densepose import encode_iuv
from neural_human_video_rendering_tpu_torch.data.keypoints import (
    BODY25_TO_COCO18, write_keypoint_json)
from neural_human_video_rendering_tpu_torch.infer import test_driver as td
from neural_human_video_rendering_tpu_torch.models import generators as tg
from neural_human_video_rendering_tpu_torch.models.bridge import params_from_jax
from neural_human_video_rendering_tpu_torch.train import __main__ as train_main
from neural_human_video_rendering_tpu_torch.train import drivers
from neural_human_video_rendering_tpu_torch.train.state import PretrainState
from neural_human_video_rendering_tpu_torch.train.steps import (
    make_forward_fn, make_pretrain_tex_step, make_pretrain_uv_step)
from neural_human_video_rendering_tpu_torch.utils import checkpoint as ckpt
from neural_human_video_rendering_tpu_torch.utils import metrics as tmetrics
from neural_human_video_rendering_tpu_torch.utils.image import (encode_png,
                                                                read_png,
                                                                save_image,
                                                                to_uint8)

LOSS_RTOL = 1e-5


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
             n_downsample_global=1, ngf=4, ngf_global=4, dtype="float32",
             no_flip=True, pose_heatmaps=True, coord_conv=True, stem_s2d=2,
             head_s2d=2, pad_mode="same")


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _assert_deltas(got, ref, before):
    dj = {k: ref[k] - before[k] for k in ref}
    scale = max(float(d.abs().max()) for d in dj.values())
    assert scale > 0
    for k, d in dj.items():
        err = float(((got[k] - before[k]) - d).abs().max())
        tol = 1e-5 * scale + 1e-4 * float(d.abs().max())
        assert err <= tol, f"{k}: {err:.3e} > {tol:.3e}"


def _run_step(jmod, tmod, jstep_fn, tstep_fn, batch, pose_nc, S):
    """Init the flax module, carry its weights into tmod, one step each
    side with SGD(1); compare losses and parameter changes."""
    params = _np_tree(jmod.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, S, S, pose_nc)))["params"])
    tmod.load_state_dict(params_from_jax(params))
    before = {k: v.clone() for k, v in tmod.state_dict().items()}
    sgd = optax.sgd(1.0)
    jparams = jax.tree.map(jnp.asarray, params)
    j_new, _, jm = jstep_fn(sgd)(jparams, sgd.init(jparams),
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    state = PretrainState(step=0, net=tmod, device=torch.device("cpu"),
                          optimizer=torch.optim.SGD(tmod.parameters(), lr=1.0))
    tm = tstep_fn(state)(state, batch)
    assert state.step == 1
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    _assert_deltas(tmod.state_dict(), params_from_jax(_np_tree(j_new)), before)
    return tm


def test_pretrain_uv_step_matches_jax():
    jopt, topt = JOptions(**FLAGS), TOptions(**FLAGS)
    ds = jds.SyntheticDataset(jopt, length=4)
    batch = jds.collate([ds[i] for i in (0, 1)])
    jt = jg.TransG(jopt.n_parts, jopt.ngf, jopt.n_downsample_translate,
                   jopt.n_blocks_translate, stem_s2d=2, head_s2d=2,
                   pad_mode="same", dtype=jnp.float32)
    with torch.device("meta"):
        tt = tg.TransG(topt.pose_nc, topt.n_parts, topt.ngf,
                       topt.n_downsample_translate, topt.n_blocks_translate,
                       stem_s2d=2, head_s2d=2, pad_mode="same")
    tt.to_empty(device="cpu")
    tm = _run_step(jt, tt, lambda tx: jsteps.make_pretrain_uv_step(jopt, jt, tx),
                   lambda st: make_pretrain_uv_step(topt, st.net, st.optimizer),
                   batch, topt.pose_nc, 32)
    assert sorted(tm) == ["Prob", "UV", "total"]


def test_pretrain_tex_step_matches_jax():
    flags = dict(FLAGS, use_mask_texture=True)
    jopt, topt = JOptions(**flags), TOptions(**flags)
    ds = jds.SyntheticDataset(jopt, length=4)
    samples = [ds[i] for i in (0, 1)]
    rng = np.random.default_rng(3)
    static = np.clip(ds.texture_atlas() * 0.5, -1, 1)
    static[5] = -1.0                            # a tile the unfold left empty
    mask = (np.abs(static + 1.0).sum(-1, keepdims=True) > 0.05).astype(np.float32)
    for i, s in enumerate(samples):
        s["part_texture"] = np.clip(static + 0.1 * np.sin(0.3 * i), -1, 1)
        s["pose_texture"] = rng.uniform(-1, 1, static.shape).astype(np.float32)
    batch = jds.collate(samples)
    jt = jg.TexG(jopt.n_parts, jopt.tex_tile, jopt.ngf_global,
                 jopt.n_downsample_global, jopt.n_blocks_global, stem_s2d=2,
                 head_s2d=2, pad_mode="same", dtype=jnp.float32)
    with torch.device("meta"):
        tt = tg.TexG(topt.pose_nc, topt.n_parts, topt.tex_tile,
                     topt.ngf_global, topt.n_downsample_global,
                     topt.n_blocks_global, stem_s2d=2, head_s2d=2,
                     pad_mode="same")
    tt.to_empty(device="cpu")

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))

    tm = _run_step(
        jt, tt,
        lambda tx: jsteps.make_pretrain_tex_step(jopt, jt, tx, static,
                                                 jnp.asarray(mask)),
        lambda st: make_pretrain_tex_step(topt, st.net, st.optimizer,
                                          nchw(static), nchw(mask)),
        batch, topt.pose_nc, 32)
    assert sorted(tm) == ["Tex_L1"]


def test_psnr_ssim_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (3, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), -1, 1).astype(np.float32)
    b[2] = a[2]                                  # identical: psnr at its cap
    ta, tb = (torch.from_numpy(x.transpose(0, 3, 1, 2)) for x in (a, b))
    np.testing.assert_allclose(
        tmetrics.psnr(ta, tb).numpy(),
        np.asarray(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b),
                                 per_sample=True)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        tmetrics.ssim(ta, tb).numpy(),
        np.asarray(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b),
                                 per_sample=True)), rtol=0, atol=1e-6)


TINY = ("--loadSize 32 --tex_tile 16 --ngf 4 --ngf_global 4 --ndf 4 "
        "--n_layers_D 2 --n_blocks_translate 1 --n_downsample_translate 2 "
        "--n_blocks_global 1 --n_downsample_global 1 --n_blocks_bg 1 "
        "--n_downsample_bg 1 --stem_s2d 2 --head_s2d 2 --bg_s2d 4 "
        "--pad_mode same --dtype float32 --pose_heatmaps --coord_conv "
        "--no_flip --gpu_ids -1 --print_freq 1 --no_vgg_loss").split()
N = 10


def _atlas_png(path, atlas):
    T = atlas.shape[1]
    grid = atlas.reshape(4, 6, T, T, 3).transpose(0, 2, 1, 3, 4)
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(grid.reshape(4 * T, 6 * T, 3))))


def write_port_corpus(root, opt, n=N):
    """A real-format corpus from the port's SyntheticDataset with the
    port's own writers (keypoint JSONs; frames, masks, IUV, bg, atlas and
    per-frame part textures as PNG; .npy flows)."""
    syn = SyntheticDataset(opt, length=n, seed=0)
    d = {k: os.path.join(root, k) for k in
         ("kp", "frames", "mask", "dp", "flow", "flow_inv", "part_texture")}
    for p in d.values():
        os.makedirs(p)
    for i in range(n):
        s = syn[i]
        body = np.zeros((25, 3), np.float32)
        body[BODY25_TO_COCO18] = s["joints"]
        write_keypoint_json(os.path.join(d["kp"], f"frame{i:05d}_keypoints.json"),
                            body)
        save_image(os.path.join(d["frames"], f"frame{i:05d}.png"), s["image"])
        with open(os.path.join(d["mask"], f"frame{i:05d}.png"), "wb") as f:
            f.write(encode_png(to_uint8(s["mask"], assume_01=True)))
        with open(os.path.join(d["dp"], f"frame{i:05d}.png"), "wb") as f:
            f.write(encode_png(encode_iuv(s["dp_parts"], s["dp_uv"])))
        if i + 1 < n:
            nxt = syn[i + 1]
            np.save(os.path.join(d["flow"], f"{i:05d}.npy"), nxt["flow"])
            np.save(os.path.join(d["flow_inv"], f"{i:05d}.npy"), nxt["flow_inv"])
        _atlas_png(os.path.join(d["part_texture"], f"frame{i:05d}.png"),
                   np.clip(syn.texture_atlas() + 0.05 * i, -1, 1))
    save_image(os.path.join(root, "bg.png"), syn.background())
    _atlas_png(os.path.join(root, "texture.png"), syn.texture_atlas())
    return d


def test_pipeline_on_the_cpu(tmp_path, capsys):
    """stage 1 -> texture pretrain -> stage 2 (--load_pretrain_TransG,
    --data_ratio, a mid-epoch latest save) -> --continue_train ->
    run_inference from the run dir, through the entry points."""
    c = str(tmp_path / "corpus")
    d = write_port_corpus(c, TrainOptions().parse(TINY, save=False))
    ck = str(tmp_path / "ckpt")
    data = ["--pose_path", d["kp"], "--mask_path", d["mask"],
            "--densepose_path", d["dp"], "--checkpoints_dir", ck]
    assets = ["--bg_path", f"{c}/bg.png", "--texture_path", f"{c}/texture.png"]
    assert pre_train.main(TINY + data + ["--name", "uv", "--batchSize", "3",
                                         "--niter", "1"]) == 0
    assert sorted(f for f in os.listdir(f"{ck}/uv") if "net" in f) == [
        "1_net_TransG.pth", "latest_net_TransG.pth"]
    assert pre_train_tex.main(TINY + data + assets + [
        "--name", "tex", "--batchSize", "2", "--niter", "1",
        "--part_texture_path", d["part_texture"]]) == 0
    assert os.path.isfile(f"{ck}/tex/1_net_TexG.pth")

    stage2 = TINY + data + assets + [
        "--img_path", d["frames"], "--flow_path", d["flow"],
        "--flow_inv_path", d["flow_inv"], "--name", "e2e", "--batchSize", "2",
        "--load_pretrain_TransG", f"{ck}/uv", "--data_ratio", "0.8",
        "--ema_decay", "0.999", "--save_latest_freq", "3", "--lambda_L2",
        "500", "--lambda_UV", "1000", "--lambda_Prob", "10", "--lambda_Temp",
        "500", "--use_densepose_loss", "--temporal_prev", "real",
        "--no_decay", "--display_freq", "2"]
    st0 = drivers.run_train(TrainOptions().parse(stage2 + ["--niter", "1"]),
                            max_steps=0)                 # the handoff
    uv = ckpt.load_net(f"{ck}/uv", "TransG")
    for k, v in st0.renderer.TransG.state_dict().items():
        assert torch.equal(v, uv[k]), k
    capsys.readouterr()
    assert train_main.main(stage2 + ["--niter", "1"]) == 0
    out = capsys.readouterr().out
    assert "[ckpt] saved epoch latest" in out and "val_PSNR" in out
    st = drivers.run_train(TrainOptions().parse(
        stage2 + ["--niter", "2", "--continue_train"]))
    assert "resumed at epoch 2 (step 4" in capsys.readouterr().out
    assert st.start_epoch == 2 and st.step == 8      # 8 frames, batch 2
    assert st.g_opt.count == st.d_opt.count == 8
    run = f"{ck}/e2e"
    assert {"2_net_G.pth", "2_net_G_ema.pth", "2_net_D.pth",
            "2_net_TransG.pth", "latest_state.pth"} <= set(os.listdir(run))
    with open(f"{run}/metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    vals = [r for r in recs if "val_PSNR" in r]
    assert [r["epoch"] for r in vals] == [1, 2]
    assert all(np.isfinite([r["val_PSNR"], r["val_SSIM"]]).all() for r in vals)
    assert os.path.isfile(f"{run}/web/index.html")

    topt = TestOptions().parse(TINY + assets + [
        "--pose_path", d["kp"], "--results_dir", str(tmp_path / "res"),
        "--checkpoints_dir", ck, "--name", "e2e", "--which_epoch", "2"],
        save=False)
    assert td.run_inference(topt, batch_size=4) == N
    assert "loaded G_ema epoch 2" in capsys.readouterr().out
    renderer = td.build_renderer(topt, torch.device("cpu"))
    for k, v in renderer.state_dict().items():
        assert torch.equal(v, st.g_ema[k]), k
    names, joints = td.load_driving_joints(topt)
    fake = make_forward_fn(topt, renderer)(
        td.assets_to_device(topt, *td.load_assets(topt), torch.device("cpu")),
        torch.from_numpy(joints[:4]))["fake"]
    for i in range(4):
        png = read_png(str(tmp_path / "res" / "images"
                           / f"frame{i:05d}_synthesized.png"))
        np.testing.assert_array_equal(
            png, to_uint8(fake[i].permute(1, 2, 0).numpy()))


def test_pretrain_refuses_what_it_does_not_carry(tmp_path):
    """The options the pretrain stages once refused run: stage 1 with
    --ms_uv, --uv_refine and --lambda_UVgrad, the texture pretrain with
    --netG local and flip on, one step each."""
    opt = TrainOptions().parse(TINY + ["--checkpoints_dir", str(tmp_path),
                                       "--ms_uv", "1", "--uv_refine", "1",
                                       "--lambda_UVgrad", "10"], save=False)
    st = drivers.run_pretrain_uv(opt, max_steps=1)
    assert st.step == 1 and {"MSUV", "UVgrad"} <= set(st.metrics)
    assert all(np.isfinite(float(v)) for v in st.metrics.values())
    opt = dataclasses.replace(opt, ms_uv=0, uv_refine=0, lambda_UVgrad=0.0,
                              no_flip=False, netG="local")
    st = drivers.run_pretrain_tex(opt, max_steps=1)
    assert st.step == 1 and hasattr(st.net, "LocalEnhancer_0")
    assert np.isfinite(float(st.metrics["Tex_L1"]))
