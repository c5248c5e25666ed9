"""The reference builds the generator the configuration names and refuses
what it does not implement; the yardstick of the global configurations
is pinned.

At conftest's TINY size, float32, on the CPU: pix2pixHD's LocalEnhancer
(netG "local" on flagship512's flags) against the port's eager path, the
refusals of ``reference_config``, digests of the drawn weights and of the
reference's first-step losses, the operation count and the float8
control's reach."""

import hashlib
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.harness import counts, data, port
from perfbench.harness.bench import Run
from perfbench.kinds import train
from perfbench.reference import nets
from perfbench.reference.config import reference_config

from .conftest import tiny_flags
from .test_perfbench_reference import (SEED, first_steps_match,
                                       frames_match)

CPU = torch.device("cpu")
LOCAL = dict(netG="local", n_local_enhancers=1, n_blocks_local=3,
             niter_fix_global=0)


def local_flags() -> dict:
    return dict(tiny_flags("flagship512"), **LOCAL)


def render_weights(cfg):
    return data.generator_weights(nets.build(cfg, "meta", vgg=False)["G"],
                                  SEED, CPU)


@pytest.mark.parametrize("check", [frames_match, first_steps_match],
                         ids=["frames", "first_steps"])
def test_local_enhancer_matches_the_port(check):
    check(local_flags())


def test_local_weights_load_strictly_both_ways():
    flags = local_flags()
    cfg = reference_config(flags)
    ref = nets.build(cfg, CPU, vgg=False)["G"]
    prog = port.renderer(port.options(flags, train=False),
                         render_weights(cfg), CPU)
    assert type(ref.TransG.backbone).__name__ == "LocalEnhancer"
    assert ref.TransG.backbone_name == prog.TransG.backbone_name
    ref.load_state_dict(prog.state_dict(), strict=True)
    prog.load_state_dict(ref.state_dict(), strict=True)
    assert list(ref.state_dict()) == list(prog.state_dict())


@pytest.mark.parametrize("net", ["TransG", "TexG"])
def test_local_backbone_matches_the_port_at_full_scale(net):
    """Each LocalEnhancer alone, with every weight at full scale (the
    frames see TexG's head at a hundredth of it, where tanh is all but
    the identity)."""
    flags = local_flags()
    cfg = reference_config(flags)
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
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)


def test_texg_head_is_scaled_through_the_backbone():
    """generator_weights finds TexG's output conv in either generator."""
    for flags, head in ((tiny_flags("flagship512"), None),
                        (local_flags(), "head")):
        cfg = reference_config(flags)
        G = nets.build(cfg, "meta", vgg=False)["G"]
        bb = G.TexG.backbone
        name = (f"TexG.{G.TexG.backbone_name}."
                f"{head or bb.order[-1]}.Conv_0.weight")
        w = data.generator_weights(G, SEED, CPU)
        full = data.make_weights(G, SEED, CPU, "G")
        for k in w:
            scale = data.TEXG_HEAD_SCALE if k == name else 1.0
            assert torch.equal(w[k], full[k] * scale), k


def without(key):
    flags = local_flags()
    del flags[key]
    return flags


REFUSED = {
    "unknown_key": (dict(local_flags(), foo=1), "foo"),
    "netG_foo": (dict(local_flags(), netG="foo"), "netG"),
    "niter_fix_global_1": (dict(local_flags(), niter_fix_global=1),
                           "niter_fix_global"),
    "upsample_resize": (dict(local_flags(), upsample_mode="resize"),
                        "upsample_mode"),
    "local_lacks_n_blocks_local": (without("n_blocks_local"),
                                   "n_blocks_local"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_reference_config_refuses(case):
    flags, key = REFUSED[case]
    with pytest.raises(ValueError, match=key):
        reference_config(flags)


def digest(tensors) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().float().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def loss_digest(losses) -> str:
    h = hashlib.sha256()
    for k in sorted(losses):
        h.update(f"{k}={float(losses[k]).hex()};".encode())
    return h.hexdigest()[:16]


# taken before the reference could build a LocalEnhancer, on the CPU with
# one torch thread, at TINY (float32), seed 2**31 + 99: the weights drawn
# for G, D and VGG and the reference's losses of the first step
PINNED = {
    "flagship512": {"G": "f4475fea40d02fcd", "D": "3749e143fe33c73f",
                    "VGG": "70ce085b37e85e42", "losses": "3c21bbaab6c900c2"},
    "ref512": {"G": "dc8f38e43a5a4e8b", "D": "fb617d132a9134d0",
               "VGG": "70ce085b37e85e42", "losses": "f38c1e2aecedbad3"},
}


@pytest.mark.parametrize("config", sorted(PINNED))
def test_the_yardstick_is_pinned(config):
    flags = tiny_flags(config)
    cfg = reference_config(flags)
    w = train.draw_weights(cfg, SEED, CPU)
    run = Run("t", SEED, 0.0, False, flags, {}, {}, CPU, time.perf_counter())
    batches = data.train_batches(SEED, 3, cfg.batchSize, cfg.size, CPU)
    losses = train.reference_readings(run, cfg, batches)[0]
    got = {k: digest(w[k]) for k in ("G", "D", "VGG")}
    got["losses"] = loss_digest(losses[0])
    assert got == PINNED[config]


def test_render_flops_count_the_port_forward():
    flags = local_flags()
    cfg = reference_config(flags)
    B = 2
    prog = port.renderer(port.options(flags, train=False),
                         render_weights(cfg), CPU).eval()
    fwd = port.forward_fn(port.options(flags, train=False), prog)
    tex, bg = data.assets(SEED, cfg.size, cfg.tex_tile, 24, CPU)
    joints = torch.from_numpy(data.driving_sequence(SEED, 1, B, cfg.size,
                                                    CPU)[0])
    counter = FlopCounterMode(display=False)
    with counter:
        fwd((tex, bg, None), joints)
    want = counter.get_total_flops()
    got = counts.model_flops(cfg, "render", B)
    assert got > 0 and abs(got - want) <= 1e-3 * want, (got, want)
    # the count takes in the enhancer's residual blocks
    more = reference_config(dict(flags, n_blocks_local=4))
    assert counts.model_flops(more, "render", B) > got


def test_float8_reaches_every_local_enhancer_conv():
    cfg = reference_config(local_flags())
    G = nets.build(cfg, "meta", vgg=False)["G"]
    nets.set_precision(G, "float8")
    for gen in (G.TransG.backbone, G.TexG.backbone):
        convs = [m for m in gen.modules()
                 if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
        assert len(convs) > 10
        assert all(m.rounding == nets.ROUND["float8"] for m in convs)
        assert gen.rounding == nets.ROUND["float8"]
