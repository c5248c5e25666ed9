"""PyTorch port, pix2pixHD weight import (``utils/torch_import``,
``import_torch_checkpoint``): a pix2pixHD GlobalGenerator (the torch
network of tests/test_torch_import.py, and the port's own copy of its
layout) mapped onto the port's GlobalGenerator by execution order; its
output against the torch original and against the JAX package's
``convert_global_generator`` result; the written ``.pth`` (from a .pth
and from a .npz) loaded through --load_pretrain_TransG; a non-parity
topology refused with the first layer that differs named.

Tolerances: 1e-5 absolute on outputs in [-1, 1] (float32 convolutions
summed in another order; tests/test_torch_import.py holds the JAX import
at 2e-5).
"""

import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu_torch import import_torch_checkpoint as itc
from neural_human_video_rendering_tpu_torch.config import TrainOptions
from neural_human_video_rendering_tpu_torch.models.bridge import params_from_jax
from neural_human_video_rendering_tpu_torch.models.generators import \
    GlobalGenerator
from neural_human_video_rendering_tpu_torch.models.renderer import (
    init_params, renderer_from_options)
from neural_human_video_rendering_tpu_torch.train import drivers
from neural_human_video_rendering_tpu_torch.utils import checkpoint as ckpt
from neural_human_video_rendering_tpu_torch.utils import torch_import as ti

from test_torch_import import (IN_NC, N_BLOCKS, N_DOWN, NGF, OUT_NC,
                               _torch_global_generator)

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_generator(**kw):
    with torch.device("meta"):
        gen = GlobalGenerator(IN_NC, OUT_NC, NGF, N_DOWN, N_BLOCKS,
                              final_tanh=True, **{"pad_mode": "reflect",
                                                  "upsample_mode": "deconv",
                                                  **kw})
    return init_params(gen, 7)


def _x(seed=0):
    return np.random.RandomState(seed).randn(2, 16, 16, IN_NC).astype(
        np.float32)


def test_import_matches_torch_and_jax():
    torch.manual_seed(0)
    tg = _torch_global_generator().eval()
    x = _x()
    with torch.no_grad():
        ty = tg(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    gen = _port_generator()
    gen.load_state_dict(ti.global_generator_state_dict(tg.state_dict(), gen),
                        strict=True)
    with torch.no_grad():
        py = gen(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(py.numpy(), ty.numpy(), rtol=0, atol=ATOL)

    # the JAX package's conversion of the same state_dict, bridged
    import jax
    import jax.numpy as jnp

    from neural_human_video_rendering_tpu.models.generators import \
        GlobalGenerator as JGlobalGenerator
    from neural_human_video_rendering_tpu.utils.torch_import import \
        convert_global_generator
    fg = JGlobalGenerator(OUT_NC, NGF, N_DOWN, N_BLOCKS, final_tanh=True,
                          pad_mode="reflect", upsample_mode="deconv")
    init = fg.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    conv = convert_global_generator(
        {k: v.numpy() for k, v in tg.state_dict().items()}, init)
    jy = np.asarray(fg.apply({"params": conv}, jnp.asarray(x)))
    np.testing.assert_allclose(py.numpy().transpose(0, 2, 3, 1), jy, rtol=0,
                               atol=ATOL)
    bridged = params_from_jax(jax.tree.map(np.asarray, conv))
    for k, v in gen.state_dict().items():
        assert torch.equal(v, bridged[k]), k


def test_reference_layout_is_pix2pixhd():
    """The port's pix2pixhd_global_generator (chip_smoke's original) is the
    network of tests/test_torch_import.py: the same keys and shapes."""
    a = ti.pix2pixhd_global_generator(IN_NC, OUT_NC, NGF, N_DOWN, N_BLOCKS)
    b = _torch_global_generator()
    assert [(k, v.shape) for k, v in a.state_dict().items()] == \
        [(k.replace("body", "conv_block"), v.shape)
         for k, v in b.state_dict().items()]
    assert len(ti.ordered_torch_convs(a.state_dict())) == \
        (1 + N_DOWN) + 2 * N_BLOCKS + N_DOWN + 1


@pytest.mark.parametrize("kw,layer", [
    (dict(pad_mode="same"), "ConvNormRelu_0.Conv_0"),
    (dict(stem_s2d=2), "ConvNormRelu_0"),
    (dict(upsample_mode="resize"), "Upsample_0"),
])
def test_non_parity_topology_is_refused(kw, layer):
    tg = _torch_global_generator()
    with pytest.raises(ValueError, match=layer):
        ti.global_generator_state_dict(tg.state_dict(), _port_generator(**kw))


def test_count_and_shape_guards():
    sd = _torch_global_generator().state_dict()
    first = next(k for k in sd if k.endswith(".weight"))[:-len("weight")]
    with pytest.raises(ValueError, match="conv count mismatch"):
        ti.global_generator_state_dict(
            {k: v for k, v in sd.items() if not k.startswith(first)},
            _port_generator())
    wide = ti.pix2pixhd_global_generator(IN_NC, OUT_NC, NGF * 2, N_DOWN,
                                         N_BLOCKS)
    with pytest.raises(ValueError, match="shape mismatch at ConvNormRelu_0"):
        ti.global_generator_state_dict(wide.state_dict(), _port_generator())


TRANSG = ("--loadSize 32 --tex_tile 16 --ngf 4 --n_blocks_translate 2 "
          "--n_downsample_translate 2 --ngf_global 4 --n_blocks_global 1 "
          "--n_downsample_global 1 --n_blocks_bg 1 --n_downsample_bg 1 "
          "--pose_heatmaps --coord_conv --dtype float32 --gpu_ids -1").split()


@pytest.mark.parametrize("fmt", ["pth", "npz"])
def test_cli_writes_a_transg_that_stage2_loads(fmt, tmp_path, capsys):
    """A pix2pixHD TransG (pose_nc -> P+1 + 2P channels, no tanh: TransG
    maps its raw output itself) through the CLI: the written .pth is
    loaded by stage 2's --load_pretrain_TransG, and the renderer's TransG
    then computes the original's output."""
    opt = TrainOptions().parse(TRANSG, save=False)
    torch.manual_seed(1)
    ref = ti.pix2pixhd_global_generator(
        opt.pose_nc, opt.transg_out_nc, 4, 2, 2, final_tanh=False).eval()
    src = str(tmp_path / f"30_net_TransG.{fmt}")
    if fmt == "pth":
        torch.save({f"module.{k}": v for k, v in ref.state_dict().items()},
                   src)
    else:
        np.savez(src, **{k: v.numpy() for k, v in ref.state_dict().items()})
    out = tmp_path / "uv"
    assert itc.main([src, "--label", "TransG", "--epoch", "30", "--out_dir",
                     str(out)] + TRANSG) == 0
    assert sorted(p.name for p in out.iterdir()) == ["30_net_TransG.pth",
                                                     "latest_net_TransG.pth"]
    assert "wrote" in capsys.readouterr().out

    st = drivers.run_train(TrainOptions().parse(TRANSG + [
        "--checkpoints_dir", str(tmp_path), "--name", "e2e",
        "--pad_mode", "reflect", "--upsample_mode", "deconv",
        "--stem_s2d", "1", "--head_s2d", "1", "--no_vgg_loss",
        "--load_pretrain_TransG", str(out), "--which_epoch_TransG", "30"],
        save=False), max_steps=0)
    x = torch.from_numpy(np.random.RandomState(3).randn(
        2, opt.pose_nc, 32, 32).astype(np.float32))
    with torch.no_grad():
        raw = ref(x)
        got = st.renderer.TransG.backbone(x)
    np.testing.assert_allclose(got.numpy(), raw.numpy(), rtol=0, atol=ATOL)
    saved = ckpt.load_net(str(out), "TransG", 30)
    for k, v in st.renderer.TransG.state_dict().items():
        assert torch.equal(v, saved[k]), k


def test_labels_build_their_subnets(tmp_path):
    """TexG and BGNet take their own widths' GlobalGenerator; a LocalEnhancer
    (--netG local is replaced by global, as pix2pixHD's checkpoint is one
    GlobalGenerator)."""
    opt = TrainOptions().parse(TRANSG + ["--netG", "local"], save=False)
    popt = itc.parity_options(opt)
    for label in ("TexG", "BGNet"):
        gen = getattr(init_params(renderer_from_options(popt), 0), label)
        gg = gen.GlobalGenerator_0
        n = len(ti.module_order(gg))
        in_nc = gg.ConvNormRelu_0.Conv_0.weight.shape[1]
        out_nc = gg.order and getattr(gg, gg.order[-1]).Conv_0.weight.shape[0]
        ref = ti.pix2pixhd_global_generator(
            in_nc, out_nc, gg.ConvNormRelu_0.Conv_0.weight.shape[0],
            sum(k.startswith("Upsample_") for k in gg.order),
            sum(k.startswith("ResnetBlock_") for k in gg.order))
        assert len(ti.ordered_torch_convs(ref.state_dict())) == n
        path = str(tmp_path / f"{label}.pth")
        torch.save(ref.state_dict(), path)
        net = itc.import_checkpoint(path, label, opt)
        assert torch.equal(net.GlobalGenerator_0.ConvNormRelu_0.Conv_0.weight,
                           ref.state_dict()["1.weight"])
