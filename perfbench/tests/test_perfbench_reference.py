"""The frozen reference against the port's eager path on the CPU, at a
tiny size of each configuration, float32, the same weights and inputs:
the rendered frames, and the first train steps' losses, gradients and
parameter changes."""

import time

import pytest
import torch

from perfbench.harness import bench as hb
from perfbench.harness import compare, data
from perfbench.harness.bench import Run
from perfbench.kinds import render, train
from perfbench.reference.config import reference_config

from .conftest import tiny_flags

CPU = torch.device("cpu")
SEED = 2 ** 31 + 99
CONFIGS = [c["name"] for c in hb.benchmark()["configs"]]


def frames_match(flags: dict) -> None:
    cfg = reference_config(flags)
    run = Run("t", SEED, 0.0, False, flags, {}, {}, CPU, 0.0)
    tex, bg = data.assets(SEED, cfg.size, cfg.tex_tile, 24, CPU)
    w = render.g_weights(cfg, SEED, CPU)
    prog = render.Program(run, cfg, w, tex, bg)
    ref = render.Reference(cfg, w, tex, bg, CPU, fp8=False)
    joints = torch.from_numpy(data.driving_sequence(SEED, 1, 4, cfg.size,
                                                    CPU)[0])
    a, b = prog.frames(joints), ref.frames(joints)
    assert a.dtype == b.dtype == torch.uint8 and a.shape == b.shape
    assert compare.frame_mad(a, b) < 0.01
    assert (a.int() - b.int()).abs().max() <= 1


def first_steps_match(flags: dict) -> None:
    flags = dict(flags, no_vgg_loss=True)  # the port's VGG is bf16 always
    cfg = reference_config(flags)
    run = Run("t", SEED, 0.0, False, flags, {}, {}, CPU, time.perf_counter())
    batches = data.train_batches(SEED, 3, 2, cfg.size, CPU)
    tex, bg = data.assets(SEED, cfg.size, cfg.tex_tile, 24, CPU)
    w = train.draw_weights(cfg, SEED, CPU)
    prog = train.first_steps(train.Program(run, cfg, w, tex, bg), batches, w)
    ref = train.reference_readings(run, cfg, batches)
    for p, r in zip(prog[0], ref[0]):
        assert p.keys() == r.keys()
        for k in r:
            assert p[k] == pytest.approx(r[k], rel=1e-4, abs=1e-6), k
    gaps = train.numbers(prog, ref)
    assert gaps["loss_gap"] < 1e-4
    assert gaps["grad_gap"] < 1e-3
    assert gaps["change_gap"] < 1e-2
    # the EMA's leaves are held too, under their own names
    if cfg.ema_decay > 0:
        assert any(k.startswith("E.") for k in ref[2])


@pytest.mark.parametrize("config", CONFIGS)
def test_frames_match_the_port(config):
    frames_match(tiny_flags(config))


@pytest.mark.parametrize("config", CONFIGS)
def test_first_steps_match_the_port(config):
    first_steps_match(tiny_flags(config))
