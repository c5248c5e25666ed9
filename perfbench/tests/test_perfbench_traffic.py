"""Seeded inputs: the same seed gives the same batches, poses, assets and
weights; another seed gives others; the batches are in the trainer's
wire format."""

import numpy as np
import torch

from perfbench.harness import data
from perfbench.reference import nets
from perfbench.reference.config import reference_config

from .conftest import tiny_flags

CPU = torch.device("cpu")
BIG = 2 ** 31 + 12345


def test_train_batches_repeat_for_a_seed_and_differ_between_seeds():
    a = data.train_batches(BIG, 3, 2, 32, CPU)
    b = data.train_batches(BIG, 3, 2, 32, CPU)
    c = data.train_batches(BIG + 1, 3, 2, 32, CPU)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["image"], c[0]["image"])
    assert not np.array_equal(a[0]["joints"], a[1]["joints"])   # distinct


def test_train_batches_are_wire_batches():
    b = data.train_batches(7, 1, 2, 32, CPU)[0]
    dtypes = {"image": np.uint8, "image_prev": np.uint8, "mask": np.uint8,
              "dp_parts": np.uint8, "dp_uv": np.uint8, "flow": np.float16,
              "flow_inv": np.float16, "joints": np.float32,
              "joints_prev": np.float32}
    for k, dt in dtypes.items():
        assert b[k].dtype == dt, k
    assert b["image"].shape == (2, 32, 32, 3)
    assert b["mask"].shape == (2, 32, 32, 1)
    assert set(np.unique(b["mask"])) <= {0, 255}
    assert b["dp_parts"].max() <= 24 and (b["dp_parts"] > 0).any()
    inside = (b["joints"][..., :2] >= 4) & (b["joints"][..., :2] <= 28)
    assert inside.all()
    np.testing.assert_array_equal(b["flow"], -b["flow_inv"])


def test_driving_sequence_and_assets_repeat():
    s1 = data.driving_sequence(BIG, 4, 8, 64, CPU)
    s2 = data.driving_sequence(BIG, 4, 8, 64, CPU)
    assert s1.shape == (4, 8, 18, 3)
    np.testing.assert_array_equal(s1, s2)
    t1, g1 = data.assets(BIG, 64, 16, 24, CPU)
    t2, g2 = data.assets(BIG, 64, 16, 24, CPU)
    assert torch.equal(t1, t2) and torch.equal(g1, g2)
    assert t1.shape == (24, 3, 16, 16) and t1.abs().max() <= 1


def test_weights_repeat_and_follow_the_init_rule():
    cfg = reference_config(tiny_flags("flagship512"))
    G = nets.build(cfg, "meta", vgg=False)["G"]
    w1 = data.make_weights(G, BIG, CPU, "G")
    w2 = data.make_weights(G, BIG, CPU, "G")
    assert w1.keys() == dict(G.named_parameters()).keys()
    for k in w1:
        assert torch.equal(w1[k], w2[k])
    name = "TransG.GlobalGenerator_0.ConvNormRelu_0.Conv_0.weight"
    w = w1[name]
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    assert w.abs().max() <= 2 * std + 1e-6
    assert 0.5 * std < w.std() < 1.5 * std
    assert not torch.equal(w, data.make_weights(G, BIG + 1, CPU, "G")[name])
    biases = [k for k in w1 if k.endswith("bias")]
    assert biases and all(not w1[k].any() for k in biases)
