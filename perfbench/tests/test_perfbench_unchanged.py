"""The committed configurations build the reference they built before it
learned pix2pixHD's feature encoder E.

For each configuration file as committed: ``reference_config`` takes it
unchanged; the reference's networks have the same state_dict keys and
shapes, in the same order (so ``data.make_weights`` draws the same
weights from a seed), with no ``FeatE`` and TexG's input the pose alone;
and the operations behind ``mfu.train`` and ``mfu.render`` are the same
to the FLOP. The figures were read from the reference as it stood before
E, on the meta device.
"""

import hashlib

import pytest

from perfbench.harness import bench as hb
from perfbench.harness import counts
from perfbench.reference import nets
from perfbench.reference.config import reference_config

# (leaves, sha256 of [(name, shape), ...]) of G, D and VGG's state_dicts
STATE = {
    "flagship512": {
        "G": (120, "f2d7b0d0e274579e069c8b26e278c2d3"
                   "5a32ff2a5bf817cdf368c340dddbc237"),
        "D": (20, "980681b7e0cf22812fb2fc62e37ad5ad"
                  "79409f890e220b3c23110a421ac7cfa7"),
        "VGG": (26, "f3a745f248db33cbde843d2f2ababc26"
                    "cd6b44a2c037e1f8736aeda8294759b0")},
    "ref512": {
        "G": (120, "8f6276f0530df1306156fab547c26fb6"
                   "d6565d2fa2bfc57c1fe600e1b4620927"),
        "D": (20, "30ec03072c2504ab7b5e3d73d4933266"
                  "d916db2907cf33d169aca386f746f148"),
        "VGG": (26, "f3a745f248db33cbde843d2f2ababc26"
                    "cd6b44a2c037e1f8736aeda8294759b0")},
    "local1024": {
        "G": (156, "8633d70958d6d40fbb6f1ee5e01b4f1b"
                   "aa63b3e906f6ffa60a0a0c6d95420936"),
        "D": (30, "be97344fd103afb7fd30aa51b0ed8a6c"
                  "481b650b05d38097796a4ee2229b13d8"),
        "VGG": (26, "f3a745f248db33cbde843d2f2ababc26"
                    "cd6b44a2c037e1f8736aeda8294759b0")},
}
# TexG's first kernel: 7x7, on the pose packed by its s2d(2) stem
TEXG_STEM = {"flagship512": (96, 92, 7, 7), "ref512": (96, 12, 7, 7),
             "local1024": (192, 92, 7, 7)}
# model_flops: a train step at the file's batch, rendered batches of 8, 1
FLOPS = {
    "flagship512": (6398223122432, 4971636457472, 651798249472),
    "ref512": (7285248163840, 4563058819072, 600726044672),
    "local1024": (16869845204992, 7732763557888, 1087970213888),
}


def committed(config: str):
    return reference_config(hb.configuration(hb.benchmark(), config)
                            ["flags"])


def digest(module) -> tuple:
    named = [(k, tuple(t.shape)) for k, t in module.state_dict().items()]
    return len(named), hashlib.sha256(repr(named).encode()).hexdigest()


@pytest.mark.parametrize("config", sorted(STATE))
def test_the_file_builds_the_same_networks(config):
    cfg = committed(config)
    assert not cfg.use_feat
    built = nets.build(cfg, "meta", vgg=not cfg.no_vgg_loss)
    for net, want in STATE[config].items():
        assert digest(built[net]) == want, net
    G = built["G"]
    assert not hasattr(G, "FeatE")
    assert not any("FeatE" in k for k in G.state_dict())
    stem = next(iter(G.TexG.state_dict().values()))
    assert tuple(stem.shape) == TEXG_STEM[config]
    assert stem.shape[1] == 4 * cfg.pose_nc


@pytest.mark.parametrize("config", sorted(FLOPS))
def test_the_file_counts_the_same_operations(config):
    cfg = committed(config)
    got = (counts.model_flops(cfg, "train", cfg.batchSize),
           counts.model_flops(cfg, "render", 8),
           counts.model_flops(cfg, "render", 1))
    assert tuple(int(f) for f in got) == FLOPS[config]
