"""pix2pixHD's feature encoder E and its per-part average pooling
(``--instance_feat``) in the frozen reference, against the port on the
CPU.

Each committed configuration, shrunk to the benchmark's tiny size
(``conftest.TINY``) with E switched on at a tiny width, float32, seeded
random weights drawn by ``perfbench/harness/data.py``: ref512 holds the
global generator and the t-1 frame rendered again (E encodes the real
t-1 frame there), flagship512 the global generator with the EMA,
local1024 the LocalEnhancer. Checked:
  * ``reference_config`` takes every feature key, refuses a switch
    without each of ``FEAT_FLAGS`` and refuses E's cluster codes;
  * the renderer's weights load strictly from either side into the other;
  * the rendered frames match, with a real frame encoded and without one;
  * the first step's losses and gradient norms, E's leaves among them,
    and the parameters' (and the EMA's) changes over three steps match;
  * ``part_pool`` equals a loop over the parts present, as pix2pixHD
    pools over its instances;
  * the float8 control reaches every convolution of E, and the operation
    count behind ``mfu.train`` counts E and the pooling.
"""

import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.harness import compare, counts, data, port
from perfbench.harness.bench import Run
from perfbench.kinds import train
from perfbench.reference import config as rconfig
from perfbench.reference import feat, nets
from perfbench.reference.pose import pose_input
from perfbench.reference.step import dequantize

from .conftest import tiny_flags

CPU = torch.device("cpu")
SEED = 2 ** 31 + 263
CONFIGS = ["flagship512", "ref512", "local1024"]
# pix2pixHD's defaults but the width and the depth, which the tiny size
# cannot hold (32 px frames)
FEAT = dict(instance_feat=True, feat_num=3, nef=4, n_downsample_E=2)


def feat_flags(config: str, **extra) -> dict:
    return dict(tiny_flags(config), **dict(FEAT, **extra))


def encoder_keys(names) -> list:
    return [k for k in names if ".FeatE." in k or k.startswith("FeatE.")]


# ------------------------------------------------------------ the keys

@pytest.mark.parametrize("switch", ["instance_feat", "label_feat"])
@pytest.mark.parametrize("config", CONFIGS)
def test_reference_config_takes_every_feature_key(config, switch):
    flags = dict(tiny_flags(config), **{switch: True}, feat_num=3, nef=4,
                 n_downsample_E=2)
    cfg = rconfig.reference_config(flags)
    assert cfg.use_feat
    for k in rconfig.FEAT_FLAGS:
        assert getattr(cfg, k) == flags[k], k
    G = nets.build(cfg, "meta", vgg=False)["G"]
    assert isinstance(G.FeatE, feat.FeatEncoder)


@pytest.mark.parametrize("missing", rconfig.FEAT_FLAGS)
def test_a_switch_without_each_feat_flag_is_refused(missing):
    flags = feat_flags("local1024")
    del flags[missing]
    with pytest.raises(ValueError, match=missing):
        rconfig.reference_config(flags)


@pytest.mark.parametrize("key,value", [("load_features", "codes.npz"),
                                       ("cluster_idx", 0)])
def test_cluster_codes_are_refused(key, value):
    with pytest.raises(ValueError, match=key):
        rconfig.reference_config(feat_flags("flagship512", **{key: value}))


def test_switches_off_build_no_encoder():
    """The feature widths without a switch change nothing, as in the
    port's options."""
    flags = feat_flags("flagship512", instance_feat=False, label_feat=False)
    cfg = rconfig.reference_config(flags)
    G = nets.build(cfg, "meta", vgg=False)["G"]
    plain = nets.build(rconfig.reference_config(tiny_flags("flagship512")),
                       "meta", vgg=False)["G"]
    assert not cfg.use_feat and not hasattr(G, "FeatE")
    assert ([(k, t.shape) for k, t in G.state_dict().items()]
            == [(k, t.shape) for k, t in plain.state_dict().items()])


# ------------------------------------------------ the port vs the reference

@pytest.mark.parametrize("into", ["port", "reference"])
@pytest.mark.parametrize("config", CONFIGS)
def test_weights_load_strictly_either_way(config, into):
    flags = feat_flags(config)
    cfg = rconfig.reference_config(flags)
    ref = nets.build(cfg, CPU, vgg=False)["G"]
    w = train.draw_weights(cfg, SEED, CPU)["G"]
    prog = port.renderer(port.options(flags, train=True), w, CPU)
    if into == "port":
        prog.load_state_dict(ref.state_dict(), strict=True)
    else:
        ref.load_state_dict(prog.state_dict(), strict=True)
    assert list(ref.state_dict()) == list(prog.state_dict())
    names = encoder_keys(ref.state_dict())
    # stem, 2 downs, head and 2 upsamples: a kernel and a bias each
    assert len(names) == 12 and names == list(ref.state_dict())[-12:]


@pytest.mark.parametrize("encoded", [True, False])
@pytest.mark.parametrize("config", CONFIGS)
def test_frames_match_the_port(config, encoded):
    flags = feat_flags(config)
    cfg = rconfig.reference_config(flags)
    w = data.generator_weights(nets.build(cfg, "meta", vgg=False)["G"],
                               SEED, CPU)
    ref = nets.build(cfg, CPU, vgg=False)["G"]
    ref.load_state_dict(w)
    prog = port.renderer(port.options(flags, train=False), w, CPU).eval()
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
    # each of the ~20 layers a frame passes
    assert torch.allclose(got["fake"], want["fake"], rtol=1e-4, atol=1e-5)
    codes = ref.codes(want["probs"], kw.get("feat_image"))
    assert (codes.abs().amax() > 0) == encoded


@pytest.fixture(scope="module", params=CONFIGS)
def first_steps(request):
    """(flags, program readings, reference readings) of the first three
    steps: losses a step, first gradients' norms, each leaf's change."""
    # the port's VGG is bfloat16 always (its loss is compared on the card)
    flags = feat_flags(request.param, no_vgg_loss=True)
    cfg = rconfig.reference_config(flags)
    run = Run("t", SEED, 0.0, False, flags, {}, {}, CPU, time.perf_counter())
    batches = data.train_batches(SEED, 3, cfg.batchSize, cfg.size, CPU)
    tex, bg = data.assets(SEED, cfg.size, cfg.tex_tile, cfg.n_parts, CPU)
    w = train.draw_weights(cfg, SEED, CPU)
    prog = train.first_steps(train.Program(run, cfg, w, tex, bg), batches, w)
    ref = train.reference_readings(run, cfg, batches)
    return flags, prog, ref


@pytest.mark.parametrize("step", [0, 1, 2])
def test_losses_match_the_port(first_steps, step):
    _, prog, ref = first_steps
    p, r = prog[0][step], ref[0][step]
    assert p.keys() == r.keys() and "D_total" in r
    for k in r:
        # float32 both sides: summation order alone, a few ulp of each
        # term, compounded over at most three of Adam's updates
        assert p[k] == pytest.approx(r[k], rel=1e-4, abs=1e-6), k
    if step == 0:
        assert train.numbers(prog, ref)["loss_gap"] < 1e-4


def test_first_gradients_match_the_port(first_steps):
    _, prog, ref = first_steps
    # the program's gradients are read back from Adam's first moment,
    # m1 / (1 - beta1): one rounding more than the reference's own
    assert train.numbers(prog, ref)["grad_gap"] < 1e-3
    enc = encoder_keys(ref[1])
    assert len(enc) == 12 and all(ref[1][k] > 0 for k in enc[::2])
    # every leaf of E, the biases before a norm included, held to the
    # same bound against the larger of its norm and the median leaf's
    assert compare.worst_leaf(prog[1], ref[1], enc) < 1e-3


def test_parameter_changes_match_the_port(first_steps):
    flags, prog, ref = first_steps
    enc = encoder_keys(ref[2])
    # G's leaves of E and, with the EMA, the EMA's
    assert len(enc) == (24 if flags["ema_decay"] > 0 else 12)
    # Adam's first updates are near sign(g) * lr, so where a gradient is
    # small against the median leaf's a few ulp of it move the update by
    # more than the gradient's own relative gap: ten times grad's bound
    assert train.numbers(prog, ref)["change_gap"] < 1e-2
    moving = set(compare.moving_leaves(ref[1]))
    keep = [k for k in enc if train._of_g(k) in moving]
    assert keep and compare.worst_leaf(prog[2], ref[2], keep) < 1e-2


# ---------------------------------------------------------- the pooling

def pix2pixhd_pool(fmap: torch.Tensor, parts: torch.Tensor) -> torch.Tensor:
    """pix2pixHD's instance-wise average pooling: for each sample and
    each label present, every pixel of the label gets the label's mean
    feature."""
    out = torch.zeros_like(fmap)
    for b in range(fmap.shape[0]):
        for label in torch.unique(parts[b]):
            where = parts[b] == label
            out[b][:, where] = fmap[b][:, where].mean(dim=1, keepdim=True)
    return out


@pytest.mark.parametrize("side", ["reference", "port"])
def test_part_pool_matches_a_loop_over_parts(side):
    from neural_human_video_rendering_tpu_torch.models import generators
    g = data.generator(SEED, "drive", CPU)
    fmap = torch.rand((2, 3, 16, 16), generator=g) * 2 - 1
    # 25 regions, two of them absent from the map
    probs = torch.rand((2, 25, 16, 16), generator=g)
    probs[:, 3:5] = 0.0
    onehot = feat.regions(probs)
    pool = feat.part_pool if side == "reference" else generators.part_pool
    got = pool(fmap, onehot)
    want = pix2pixhd_pool(fmap, probs.argmax(1))
    # sums over at most 256 pixels in another order, and the +1e-6 in
    # the divisor: ~1e-6 relative at most
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------- the yardstick's arithmetic

def test_float8_reaches_every_encoder_conv():
    cfg = rconfig.reference_config(feat_flags("local1024"))
    G = nets.set_precision(nets.build(cfg, "meta", vgg=False)["G"], "float8")
    convs = [m for m in G.FeatE.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    assert len(convs) == 6
    assert all(m.rounding == nets.ROUND["float8"] for m in convs)
    assert G.FeatE.rounding == nets.ROUND["float8"]


@pytest.mark.parametrize("config", ["ref512", "local1024"])
def test_model_flops_count_the_encoder(config):
    """A train step's count grows by E's forward and backward, counted
    alone, and the pooling's four products (two forward, one backward
    each); the rest of the growth is TexG's wider input, far less than E.
    Rendering, which has no real frame to encode, runs no E."""
    plain = rconfig.reference_config(tiny_flags(config))
    cfg = rconfig.reference_config(feat_flags(config))
    B, S = cfg.batchSize, cfg.size
    with torch.device("meta"):
        enc = feat.FeatEncoder(cfg.feat_num, cfg.nef, cfg.n_downsample_E,
                               cfg.pad_mode)
        img = torch.zeros((B, 3, S, S))
    counter = FlopCounterMode(display=False)
    with counter:
        enc(img).sum().backward()
    e = counter.get_total_flops()
    pool = 4 * 2 * B * (cfg.n_parts + 1) * cfg.feat_num * S * S
    grown = (counts.model_flops(cfg, "train", B)
             - counts.model_flops(plain, "train", B))
    assert e > 0 and e + pool <= grown < 2 * e + pool, (e, pool, grown)
    render = (counts.model_flops(cfg, "render", B)
              - counts.model_flops(plain, "render", B))
    assert 0 <= render < e / 10, (render, e)
