"""A run with the timed path broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run
(``perfbench.run.execute``: set-up, window, the reference, the checks
against the cell's own limits) on the CPU at a small size of the cell's
configuration: the program passes; the float8 control and every fault
the cell can have fail."""

import copy

import pytest
import torch

from perfbench import run as prun
from perfbench.harness import bench as hb

from .conftest import SMALL, tiny_flags

SMALLER = {"train": {"pool": 4}, "render": {"sequence": 3, "sample": 2},
           "serve": {"rate": 10.0, "sample": 4}}
# At this small size the control's readings depend on the seed more than
# at the cells' own (ref512.train's loss_gap 0.007-0.030 over three
# seeds here, 0.029-0.076 at full size on the card); this seed puts every
# cell's control above its limit, as every seed does on the card.
SEED = 99
FAULTS = {"train": ["fault:frozen", "fault:half_batch"],
          "render": ["fault:half_batch", "fault:altered"],
          "serve": ["fault:altered"]}


def cells():
    spec = hb.benchmark()
    return [(w["name"], hb.traffic(w["traffic"])["kind"])
            for w in spec["workloads"]]


def drive(monkeypatch, workload: str, side: str) -> dict:
    spec = hb.benchmark()
    cell = hb.cell(spec, workload)
    flags = tiny_flags(cell["config"], size=SMALL)
    traffic = hb.traffic(cell["traffic"])
    traffic = dict(traffic, **SMALLER[traffic["kind"]])
    monkeypatch.setattr(hb, "configuration",
                        lambda s, name: {"flags": copy.deepcopy(flags)})
    monkeypatch.setattr(hb, "traffic", lambda name: dict(traffic))
    args = prun.parse(["--workload", workload, "--seed", str(SEED),
                       "--seconds", "1"])
    return prun.execute(args, torch.device("cpu"), 1, side=side)


def cases():
    out = []
    for name, kind in cells():
        out.append((name, "program", True))
        out.append((name, "control", False))
        out += [(name, f, False) for f in FAULTS[kind]]
    return out


@pytest.mark.parametrize("workload,side,correct", cases())
def test_correct_only_for_the_sound_program(monkeypatch, workload, side,
                                            correct):
    line = drive(monkeypatch, workload, side)
    assert line["correct"] is correct, line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
