"""Shared fixtures of the benchmark's CPU tests: a tiny configuration of
each cell's flags, and one torch thread (these tests train on the CPU)."""

import copy

import pytest
import torch

from perfbench.harness import bench as hb

TINY = dict(loadSize=32, tex_tile=8, ngf=4, ngf_global=4,
            n_blocks_translate=1, n_blocks_global=1, n_blocks_bg=1,
            n_downsample_translate=2, n_downsample_global=1,
            n_downsample_bg=1, ndf=4, n_layers_D=2, bg_s2d=2,
            gpu_ids="-1")


# the control's float8 rounding grows with depth and width: at TINY it
# reads under the cells' limits, at SMALL over them
SMALL = dict(TINY, loadSize=64, tex_tile=16, ngf=8, ngf_global=8,
             n_blocks_translate=3, n_blocks_global=3, ndf=8)


def tiny_flags(config: str, dtype: str = "float32", size: dict = TINY
               ) -> dict:
    flags = copy.deepcopy(hb.configuration(hb.benchmark(), config)["flags"])
    flags.update(size, dtype=dtype)
    return flags


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided inside the test, never while
    the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
