"""PyTorch port, pix2pixHD's instance-feature encoder E on the 1024 px
LocalEnhancer configuration (``perfbench/configs/local1024feat.json``)
against the benchmark's plain reference (``perfbench/reference``), on the
CPU.

The file's flags are shrunk to the tiny size of
``test_torch_port_local1024.py`` with E kept at a tiny width (``nef`` 4,
two downsamplings, which 32 px frames can hold); ``instance_feat`` and
``feat_num`` are left as the file has them. Float32, seeded random
weights drawn by ``perfbench/harness/data.py``:
  * ``reference_config`` takes every key of the file, whole and shrunk,
    and the file is ``local1024.json`` plus pix2pixHD's E defaults;
  * the port's rendered frames match the reference's, with a real frame
    encoded and without one;
  * the first step's losses and gradient norms, and the parameters'
    changes over three steps, match, E's leaves (and their EMA) included;
  * the renderer's and the discriminator's weights load strictly from
    either side into the other;
  * E alone matches at its published widths (``nef`` 16, 4
    downsamplings) on a small frame;
  * the operation count behind ``mfu.train`` / ``mfu.render`` equals
    the port's step and forward counted by ``FlopCounterMode``.
The configuration has no benchmark cell yet: at the published widths on
the card, the harness's ``change_gap`` reads E's leaves beyond any limit
that would still catch a frozen state (PERF.md).
"""

import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from neural_human_video_rendering_tpu_torch.models.generators import \
    FeatEncoder
from perfbench.harness import bench as hb
from perfbench.harness import compare, counts, data, port
from perfbench.harness.bench import Run
from perfbench.kinds import render, train
from perfbench.reference import config as rconfig
from perfbench.reference import feat, nets
from perfbench.reference.pose import pose_input
from perfbench.reference.step import dequantize
from test_torch_port_local1024 import TINY

CPU = torch.device("cpu")
SEED = 2 ** 31 + 311

# pix2pixHD's --instance_feat and its defaults for E (base_options.py)
PUBLISHED_E = dict(instance_feat=True, feat_num=3, nef=16, n_downsample_E=4)
# E at a width and depth the tiny 32 px frames hold
TINY_E = dict(nef=4, n_downsample_E=2)


def config_file(config: str = "local1024feat") -> dict:
    return hb.load_json(hb.BENCH / "configs" / f"{config}.json")


def file_flags(config: str = "local1024feat") -> dict:
    return config_file(config)["flags"]


def tiny_flags(**extra) -> dict:
    return dict(file_flags(), **TINY, **TINY_E, dtype="float32", **extra)


def encoder_keys(names) -> list:
    return [k for k in names if ".FeatE." in k or k.startswith("FeatE.")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's CPU thread pool slows many-fold when they share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the file

@pytest.mark.parametrize("size", ["whole", "tiny"])
def test_reference_config_takes_every_key_of_the_file(size):
    flags = file_flags() if size == "whole" else tiny_flags()
    cfg = rconfig.reference_config(flags)
    known = (rconfig.FLAGS + rconfig.LOCAL_FLAGS + rconfig.FEAT_SWITCHES
             + rconfig.FEAT_FLAGS + rconfig.PROGRAM_ONLY)
    assert set(flags) <= set(known)
    for k in rconfig.FLAGS + rconfig.LOCAL_FLAGS + rconfig.FEAT_FLAGS:
        assert getattr(cfg, k) == flags[k], k
    assert cfg.use_feat and cfg.size == flags["loadSize"]


def test_the_file_is_local1024_with_pix2pixhd_encoder_defaults():
    flags, local = file_flags(), file_flags("local1024")
    assert {k: flags[k] for k in PUBLISHED_E} == PUBLISHED_E
    assert {k: v for k, v in flags.items() if k not in PUBLISHED_E} == local
    whole = config_file()
    assert whole["name"] == "local1024feat" and whole["reduced"] == []
    assert set(config_file("local1024")["assumed"]) < set(whole["assumed"])


# ------------------------------------------------ the port vs the reference

@pytest.mark.parametrize("encoded", [True, False])
def test_frames_match_the_reference(encoded):
    flags = tiny_flags()
    cfg = rconfig.reference_config(flags)
    w = data.generator_weights(nets.build(cfg, "meta", vgg=False)["G"],
                               SEED, CPU)
    ref = nets.build(cfg, CPU, vgg=False)["G"]
    ref.load_state_dict(w)
    prog = port.renderer(port.options(flags, train=False), w, CPU).eval()
    assert type(prog.TransG.backbone).__name__ == "LocalEnhancer"
    tex, bg = data.assets(SEED, cfg.size, cfg.tex_tile, cfg.n_parts, CPU)
    b = dequantize(data.train_batches(SEED, 1, 2, cfg.size, CPU)[0], CPU)
    pose = pose_input(cfg, b["joints"])
    kw = {"feat_image": b["image"]} if encoded else {}
    with torch.no_grad():
        got = prog(pose, bg[None], tex[None], **kw)
        want = ref(pose, bg[None], tex[None], **kw)
    # the same parts win every pixel on both sides
    assert torch.equal(got["probs"].argmax(1), want["probs"].argmax(1))
    # float32 both sides: only the order of sums differs, a few ulp of
    # each of the layers a frame passes
    assert torch.allclose(got["fake"], want["fake"], rtol=1e-4, atol=1e-5)
    codes = ref.codes(want["probs"], kw.get("feat_image"))
    assert (codes.abs().amax() > 0) == encoded


@pytest.fixture(scope="module")
def first_steps():
    """(program, reference) readings of the first three steps: losses a
    step, first gradients' norms, each leaf's change."""
    # the port's VGG is bfloat16 always (its loss is compared on the card)
    flags = tiny_flags(no_vgg_loss=True)
    cfg = rconfig.reference_config(flags)
    run = Run("t", SEED, 0.0, False, flags, {}, {}, CPU, time.perf_counter())
    batches = data.train_batches(SEED, 3, cfg.batchSize, cfg.size, CPU)
    tex, bg = data.assets(SEED, cfg.size, cfg.tex_tile, cfg.n_parts, CPU)
    w = train.draw_weights(cfg, SEED, CPU)
    prog = train.first_steps(train.Program(run, cfg, w, tex, bg), batches, w)
    ref = train.reference_readings(run, cfg, batches)
    return prog, ref


@pytest.mark.parametrize("step", [0, 1, 2])
def test_losses_match_the_reference(first_steps, step):
    prog, ref = first_steps
    p, r = prog[0][step], ref[0][step]
    assert p.keys() == r.keys() and "D_total" in r
    for k in r:
        # float32 both sides: summation order alone, a few ulp of each
        # term, compounded over at most three of Adam's updates
        assert p[k] == pytest.approx(r[k], rel=1e-4, abs=1e-6), k
    if step == 0:
        assert train.numbers(prog, ref)["loss_gap"] < 1e-4


def test_first_gradients_match_the_reference(first_steps):
    prog, ref = first_steps
    moving = compare.moving_leaves(ref[1])
    assert any(".enh1_" in k for k in moving)       # the enhancer's leaves
    enc = encoder_keys(ref[1])
    # stem, 2 downs, 2 upsamples and the head: a kernel and a bias each;
    # every kernel of E has a gradient
    assert len(enc) == 12 and all(ref[1][k] > 0 for k in enc[::2])
    # the program's gradients are read back from Adam's first moment,
    # m1 / (1 - beta1): one rounding more than the reference's own
    assert train.numbers(prog, ref)["grad_gap"] < 1e-3
    assert compare.worst_leaf(prog[1], ref[1], enc) < 1e-3


def test_parameter_changes_match_the_reference(first_steps):
    prog, ref = first_steps
    enc = encoder_keys(ref[2])
    # G's leaves of E and the EMA's
    assert len(enc) == 24 and any(k.startswith("E.") for k in enc)
    # Adam's first updates are near sign(g) * lr, so where a gradient is
    # small against the median leaf's a few ulp of it move the update by
    # more than the gradient's own relative gap: ten times grad's bound
    assert train.numbers(prog, ref)["change_gap"] < 1e-2
    moving = set(compare.moving_leaves(ref[1]))
    keep = [k for k in enc if train._of_g(k) in moving]
    assert keep and compare.worst_leaf(prog[2], ref[2], keep) < 1e-2


@pytest.mark.parametrize("net", ["G", "D"])
@pytest.mark.parametrize("into", ["port", "reference"])
def test_weights_load_strictly_either_way(net, into):
    flags = tiny_flags()
    cfg = rconfig.reference_config(flags)
    ref = nets.build(cfg, CPU, vgg=False)[net]
    w = train.draw_weights(cfg, SEED, CPU)
    state = port.train_state(port.options(flags, train=True), w,
                             *data.assets(SEED, cfg.size, cfg.tex_tile,
                                          cfg.n_parts, CPU), CPU)
    prog = state.renderer if net == "G" else state.disc
    if into == "port":
        prog.load_state_dict(ref.state_dict(), strict=True)
    else:
        ref.load_state_dict(prog.state_dict(), strict=True)
    assert list(ref.state_dict()) == list(prog.state_dict())
    if net == "G":
        names = encoder_keys(ref.state_dict())
        assert len(names) == 12 and names == list(ref.state_dict())[-12:]


def test_encoder_matches_at_published_widths():
    """E alone at pix2pixHD's widths (16 wide, 4 downsamplings to 256
    channels) on a 64 px frame, every weight at full scale."""
    cfg = rconfig.reference_config(file_flags())
    ref = feat.FeatEncoder(cfg.feat_num, cfg.nef, cfg.n_downsample_E,
                           cfg.pad_mode)
    prog = FeatEncoder(cfg.feat_num, cfg.nef, cfg.n_downsample_E,
                       pad_mode=cfg.pad_mode, upsample_mode=cfg.upsample_mode,
                       dtype=torch.float32)
    w = data.make_weights(ref, SEED, CPU, "G")
    assert len(w) == 2 * (2 * 4 + 2)
    assert max(t.shape[0] for t in w.values()) == 16 * 2 ** 4
    ref.load_state_dict(w, strict=True)
    prog.load_state_dict(w, strict=True)
    img = torch.rand((2, 3, 64, 64),
                     generator=data.generator(SEED, "drive", CPU)) * 2 - 1
    with torch.no_grad():
        got, want = prog(img), ref(img)
    assert got.shape == want.shape == (2, 3, 64, 64)
    assert want.abs().max() > 0.5
    # float32 both sides: 10 convolutions and 9 norms, each reordering
    # its sums, a few ulp each
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------- the yardstick's arithmetic

@pytest.mark.parametrize("batch", [1, 2])
def test_render_flops_count_the_port_forward(batch):
    """Rendering has no real frame to encode: the count and the port's
    forward leave E out alike."""
    flags = tiny_flags()
    cfg = rconfig.reference_config(flags)
    g = render.g_weights(cfg, SEED, CPU)
    prog = port.renderer(port.options(flags, train=False), g, CPU).eval()
    fwd = port.forward_fn(port.options(flags, train=False), prog)
    tex, bg = data.assets(SEED, cfg.size, cfg.tex_tile, cfg.n_parts, CPU)
    joints = torch.from_numpy(data.driving_sequence(SEED, 1, batch, cfg.size,
                                                    CPU)[0])
    counter = FlopCounterMode(display=False)
    with counter:
        fwd((tex, bg, None), joints)
    want = counter.get_total_flops()
    got = counts.model_flops(cfg, "render", batch)
    # the same convolutions and products on both sides; the port's pose
    # rasterisation and warp add no counted operation
    assert got > 0 and abs(got - want) <= 1e-3 * want, (got, want)


def test_train_flops_count_the_port_step():
    """A train step's count (forward and backward of G with E and the
    pooling's products, D and the losses) against the port's first step
    counted the same way."""
    flags = tiny_flags(no_vgg_loss=True)
    cfg = rconfig.reference_config(flags)
    run = Run("t", SEED, 0.0, False, flags, {}, {}, CPU, time.perf_counter())
    batch, = data.train_batches(SEED, 1, cfg.batchSize, cfg.size, CPU)
    tex, bg = data.assets(SEED, cfg.size, cfg.tex_tile, cfg.n_parts, CPU)
    system = train.Program(run, cfg, train.draw_weights(cfg, SEED, CPU),
                           tex, bg)
    counter = FlopCounterMode(display=False)
    with counter:
        system.step(batch)
    want = counter.get_total_flops()
    got = counts.model_flops(cfg, "train", cfg.batchSize)
    plain = counts.model_flops(
        rconfig.reference_config(dict(flags, instance_feat=False)), "train",
        cfg.batchSize)
    assert got > plain and abs(got - want) <= 1e-3 * want, (got, want)
