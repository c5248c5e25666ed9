"""PyTorch port, the pretrain steps with the model and training options,
one step each against the JAX package's with the same weights (SGD(1),
so each parameter's change is its gradient):
  * make_pretrain_uv_step with --ms_uv (the aux heads against the
    subsampled pseudo-GT, inside the mask), --lambda_UVgrad and
    --uv_refine;
  * make_pretrain_tex_step with --netG local on a flipped batch of the
    real-format corpus, through the texture pretrain's dataset
    (``train/drivers._TexDataset`` over FrameDataset with flip on).
Tolerances as test_torch_port_pretrain: losses 1e-5 relative, parameter
deltas per tensor 1e-5 * max|delta| + 1e-4 * max|delta| of the tensor.
Two JAX step compiles.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu.config import Options as JOptions
from neural_human_video_rendering_tpu.data import dataset as jds
from neural_human_video_rendering_tpu.models import generators as jg
from neural_human_video_rendering_tpu.train import steps as jsteps
from neural_human_video_rendering_tpu_torch.config import Options as TOptions
from neural_human_video_rendering_tpu_torch.config import TrainOptions
from neural_human_video_rendering_tpu_torch.data import dataset as tds
from neural_human_video_rendering_tpu_torch.models import generators as tg
from neural_human_video_rendering_tpu_torch.train import drivers
from neural_human_video_rendering_tpu_torch.train.steps import (
    make_pretrain_tex_step, make_pretrain_uv_step)
from test_torch_port_pretrain import (FLAGS, TINY, _run_step,
                                      write_port_corpus)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_pretrain_uv_step_with_options_matches_jax():
    flags = dict(FLAGS, n_downsample_translate=3, ms_uv=2, uv_refine=1,
                 uv_refine_ngf=8, lambda_UVgrad=50.0, lambda_MS=0.3)
    jopt, topt = JOptions(**flags), TOptions(**flags)
    ds = jds.SyntheticDataset(jopt, length=4)
    batch = jds.collate([ds[i] for i in (0, 1)])
    assert "mask" in batch
    kw = dict(stem_s2d=2, head_s2d=2, uv_refine=1, uv_refine_ngf=8, ms_uv=2,
              pad_mode="same")
    jt = jg.TransG(jopt.n_parts, jopt.ngf, 3, jopt.n_blocks_translate,
                   dtype=jnp.float32, **kw)
    with torch.device("meta"):
        tt = tg.TransG(topt.pose_nc, topt.n_parts, topt.ngf, 3,
                       topt.n_blocks_translate, **kw)
    tt.to_empty(device="cpu")
    tm = _run_step(jt, tt, lambda tx: jsteps.make_pretrain_uv_step(jopt, jt, tx),
                   lambda st: make_pretrain_uv_step(topt, st.net, st.optimizer),
                   batch, topt.pose_nc, 32)
    assert sorted(tm) == ["MSUV", "Prob", "UV", "UVgrad", "total"]


def test_pretrain_tex_step_local_flip_matches_jax(tmp_path):
    opt = TrainOptions().parse(TINY, save=False)
    d = write_port_corpus(str(tmp_path / "c"), opt, n=4)
    flags = dict(FLAGS, netG="local", n_blocks_local=1, no_flip=False)
    topt = dataclasses.replace(
        TOptions(**flags), pose_path=d["kp"], mask_path=d["mask"],
        densepose_path=d["dp"], part_texture_path=d["part_texture"])
    base = tds.FrameDataset(topt, "train")
    ds = drivers._TexDataset(topt, base)
    samples = [ds[i] for i in range(4)]
    flipped = [s for s in samples if s.get("bg_flip", 0.0) == 1.0]
    kept = [s for s in samples if s.get("bg_flip", 0.0) == 0.0]
    assert flipped and kept
    batch = tds.collate([flipped[0], kept[0]])
    static = drivers._assets(topt, base)[0]
    jopt = JOptions(**flags)
    jt = jg.TexG(jopt.n_parts, jopt.tex_tile, jopt.ngf_global,
                 jopt.n_downsample_global, jopt.n_blocks_global, netG="local",
                 n_blocks_local=1, stem_s2d=2, head_s2d=2, pad_mode="same",
                 dtype=jnp.float32)
    with torch.device("meta"):
        tt = tg.TexG(topt.pose_nc, topt.n_parts, topt.tex_tile,
                     topt.ngf_global, topt.n_downsample_global,
                     topt.n_blocks_global, netG="local", n_blocks_local=1,
                     stem_s2d=2, head_s2d=2, pad_mode="same")
    tt.to_empty(device="cpu")
    assert "LocalEnhancer_0.global_trunk.ConvNormRelu_0.Conv_0.weight" in \
        tt.state_dict()
    tm = _run_step(
        jt, tt,
        lambda tx: jsteps.make_pretrain_tex_step(jopt, jt, tx, static),
        lambda st: make_pretrain_tex_step(
            topt, st.net, st.optimizer,
            torch.from_numpy(np.ascontiguousarray(static.transpose(0, 3, 1,
                                                                   2)))),
        batch, topt.pose_nc, 32)
    assert sorted(tm) == ["Tex_L1"]
