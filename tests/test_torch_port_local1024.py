"""PyTorch port, pix2pixHD's 1024 px LocalEnhancer configuration
(``perfbench/configs/local1024.json``) against the benchmark's plain
reference (``perfbench/reference``), on the CPU.

The file's flags are shrunk to a tiny size (widths, depths, 32 px frames)
that keeps what makes them this configuration: ``netG`` local with one
enhancer and its three residual blocks, and three discriminator scales.
Float32, seeded random weights drawn by ``perfbench/harness/data.py``:
  * ``reference_config`` takes every key of the file, whole and shrunk,
    and the file holds pix2pixHD's published widths on the flagship's
    other flags;
  * the port's rendered frames match the reference's;
  * the first step's losses and gradient norms, and the parameters'
    changes over three steps, match;
  * the generator's and the discriminator's weights load strictly from
    either side into the other;
  * each LocalEnhancer alone matches at full-scale weights;
  * the operation count behind ``mfu.train`` / ``mfu.render`` equals the
    port's forward counted by ``FlopCounterMode``, and the float8 control
    reaches every convolution of both enhancers.
The same comparison at the published widths, on the card, decides the
benchmark cell ``local1024.train``'s ``correct``.
"""

import copy
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.harness import bench as hb
from perfbench.harness import compare, counts, data, port
from perfbench.harness.bench import Run
from perfbench.kinds import render, train
from perfbench.reference import config as rconfig
from perfbench.reference import nets

CPU = torch.device("cpu")
SEED = 2 ** 31 + 177

# the benchmark's own tiny size (perfbench/tests/conftest.py TINY); netG,
# the enhancer's flags and num_D are left as the file has them
TINY = dict(loadSize=32, tex_tile=8, ngf=4, ngf_global=4,
            n_blocks_translate=1, n_blocks_global=1, n_blocks_bg=1,
            n_downsample_translate=2, n_downsample_global=1,
            n_downsample_bg=1, ndf=4, n_layers_D=2, bg_s2d=2,
            gpu_ids="-1")

# pix2pixHD's 1024p scripts (--netG local --ngf 32 --num_D 3) and its
# defaults for the local flags, on the flagship's trunk widths
PUBLISHED = dict(loadSize=1024, netG="local", ngf=32,
                 n_downsample_translate=4, n_blocks_translate=9,
                 n_local_enhancers=1, n_blocks_local=3, niter_fix_global=0,
                 num_D=3)


def file_flags() -> dict:
    return copy.deepcopy(hb.configuration(hb.benchmark(), "local1024")
                         ["flags"])


def tiny_flags() -> dict:
    return dict(file_flags(), **TINY, dtype="float32")


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
    known = rconfig.FLAGS + rconfig.LOCAL_FLAGS + rconfig.PROGRAM_ONLY
    assert set(flags) <= set(known)
    for k in rconfig.FLAGS + rconfig.LOCAL_FLAGS:
        assert getattr(cfg, k) == flags[k], k
    assert cfg.size == flags["loadSize"]


def test_the_file_is_pix2pixhd_1024p_on_the_flagship_recipe():
    spec = hb.benchmark()
    flags = file_flags()
    flagship = hb.configuration(spec, "flagship512")["flags"]
    assert {k: flags[k] for k in PUBLISHED} == PUBLISHED
    assert set(flags) == set(flagship) | set(rconfig.LOCAL_FLAGS)
    changed = {k for k in flagship if flags[k] != flagship[k]}
    assert changed == {"loadSize", "netG", "ngf", "num_D"}
    entry, = [c for c in spec["configs"] if c["name"] == "local1024"]
    assert entry["reduced"] == []
    cells = [w for w in spec["workloads"] if w["config"] == "local1024"]
    assert [(w["name"], w["traffic"], w["chips"]) for w in cells] == [
        ("local1024.train", "train", 1)]


# ------------------------------------------------ the port vs the reference

@pytest.mark.parametrize("seed", [SEED, SEED + 2])
def test_frames_match_the_reference(seed):
    flags = tiny_flags()
    cfg = rconfig.reference_config(flags)
    run = Run("t", seed, 0.0, False, flags, {}, {}, CPU, 0.0)
    tex, bg = data.assets(seed, cfg.size, cfg.tex_tile, cfg.n_parts, CPU)
    w = render.g_weights(cfg, seed, CPU)
    prog = render.Program(run, cfg, w, tex, bg)
    ref = render.Reference(cfg, w, tex, bg, CPU, fp8=False)
    joints = torch.from_numpy(data.driving_sequence(seed, 1, 4, cfg.size,
                                                    CPU)[0])
    a, b = prog.frames(joints), ref.frames(joints)
    assert type(prog.g.TransG.backbone).__name__ == "LocalEnhancer"
    assert a.dtype == b.dtype == torch.uint8 and a.shape == b.shape
    # both are float32 on the CPU: only the order of sums differs, which
    # moves a value by a few ulp and so a pixel by at most one level where
    # it lies next to a rounding boundary, and the mean far less
    assert compare.frame_mad(a, b) < 0.01
    assert (a.int() - b.int()).abs().max() <= 1


@pytest.fixture(scope="module")
def first_steps():
    """(program, reference) readings of the first three steps: losses a
    step, first gradients' norms, each leaf's change."""
    # the port's VGG is bfloat16 always (its loss is compared on the card)
    flags = dict(tiny_flags(), no_vgg_loss=True)
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
    assert any(k.startswith("D.") for k in moving)
    # the program's gradients are read back from Adam's first moment,
    # m1 / (1 - beta1): one rounding more than the reference's own
    assert train.numbers(prog, ref)["grad_gap"] < 1e-3


def test_parameter_changes_match_the_reference(first_steps):
    prog, ref = first_steps
    assert any(k.startswith("E.") for k in ref[2])  # the EMA's leaves
    # Adam's first updates are near sign(g) * lr, so where a gradient is
    # small against the median leaf's a few ulp of it move the update by
    # more than the gradient's own relative gap: ten times grad's bound
    assert train.numbers(prog, ref)["change_gap"] < 1e-2


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
        for gen in ("TransG", "TexG"):
            assert (getattr(ref, gen).backbone_name
                    == getattr(prog, gen).backbone_name == "LocalEnhancer_0")
    else:
        assert len(list(ref.children())) == len(list(prog.children()))


@pytest.mark.parametrize("net", ["TransG", "TexG"])
def test_each_local_enhancer_matches_at_full_scale(net):
    """Each LocalEnhancer alone with every weight at full scale (the
    frames see TexG's head at a hundredth of it, where tanh is all but
    the identity)."""
    flags = tiny_flags()
    cfg = rconfig.reference_config(flags)
    ref = nets.build(cfg, CPU, vgg=False)["G"]
    w = data.make_weights(ref, SEED, CPU, "G")
    ref.load_state_dict(w)
    prog = port.renderer(port.options(flags, train=False), w, CPU)
    a, b = getattr(prog, net).backbone, getattr(ref, net).backbone
    size = cfg.size if net == "TransG" else cfg.tex_tile
    x = torch.randn((2, cfg.pose_nc, size, size),
                    generator=data.generator(SEED, "drive", CPU))
    with torch.no_grad():
        got, want = a(x), b(x)
    assert got.shape == want.shape
    assert want.abs().max() > 0.5
    # float32 both sides; the deepest path is ~20 convolutions and norms,
    # each reordering its sums: a few ulp each, under 1e-4 relative
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------- the yardstick's arithmetic

@pytest.mark.parametrize("batch", [1, 2])
def test_render_flops_count_the_port_forward(batch):
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


@pytest.mark.parametrize("net", ["TransG", "TexG"])
def test_float8_reaches_every_enhancer_conv(net):
    cfg = rconfig.reference_config(tiny_flags())
    G = nets.build(cfg, "meta", vgg=False)["G"]
    nets.set_precision(G, "float8")
    gen = getattr(G, net).backbone
    convs = [m for m in gen.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    assert len(convs) > 10
    assert all(m.rounding == nets.ROUND["float8"] for m in convs)
    assert gen.rounding == nets.ROUND["float8"]
