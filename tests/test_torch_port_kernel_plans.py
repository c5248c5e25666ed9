"""PyTorch port: the backward's launch plan, which its wrapper computes in
Python, and the flow warp on the strided views the temporal loss hands it,
on the CPU (the kernels themselves run only on the card).

* ``texture_warp_kernel.bwd_launch_plan``: the backward's clusters must
  tile all N pixels of every (part, batch) exactly once in chunks that are
  multiples of 4 (the kernel's float4 windows), with at most 16 CTAs a
  cluster and at most 232,448 shared bytes a CTA, at the train step's
  shapes, at T=128, at B=8 and for a batch-1 texture. (The clusters are 8
  wide even where the card cannot hold all of them at once: a waiting
  cluster starts when one finishes, which evens out parts with several
  times the selected pixels of others; PERF.md.)
* ``flow_warp_kernel.flow_warp_fwd`` on channel views of one torch.cat,
  odd widths, padded rows and unaligned storage, against the JAX package's
  ``grid_sample.flow_warp`` on the same values: 2e-6 absolute (values in
  [-1, 1]), as test_torch_port_train_ops.py holds the contiguous case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu.ops.grid_sample import \
    flow_warp as j_flow_warp
from neural_human_video_rendering_tpu_torch.ops import flow_warp_kernel as fk
from neural_human_video_rendering_tpu_torch.ops import texture_warp_kernel as tk

S512 = 512 * 512
FLOW_ATOL = 2e-6

# (B, texture batch, P, C, T, N) -> (groups, cluster, chunk, smem)
PLANS = {
    "train step": ((2, 2, 24, 3, 64, S512), (48, 8, 32768, 81920)),
    "tile 128": ((2, 2, 24, 3, 128, S512), (48, 8, 32768, 229376)),
    "serving batch 8": ((8, 8, 24, 3, 64, S512), (192, 8, 32768, 81920)),
    "texture batch 1": ((2, 1, 24, 3, 64, S512), (24, 8, 32768, 81920)),
    "short last chunk": ((2, 2, 24, 3, 64, 510 * 511),
                         (48, 8, 32580, 81920)),
    "small": ((2, 2, 7, 3, 16, 32 * 32), (14, 1, 1024, 35840)),
    "odd pixels": ((1, 1, 5, 2, 9, 30 * 30), (5, 1, 900, 33424)),
    "two windows": ((1, 1, 3, 3, 16, 4096), (3, 2, 2048, 35840)),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_bwd_launch_plan(name):
    (B, Bt, P, C, T, N), want = PLANS[name]
    plan = tk.bwd_launch_plan(B, Bt, P, C, T, N)
    assert (plan.groups, plan.cluster, plan.chunk, plan.smem) == want
    # a cluster for every (part, batch), or for every part of a batch-1
    # texture, whose CTAs walk the batches
    assert plan.per_sample == (Bt == B and B > 1)
    assert plan.groups == P * (B if plan.per_sample else 1)
    # the ranks of a cluster tile the N pixels exactly once
    hits = np.zeros(N, np.int64)
    for r in range(plan.cluster):
        hits[r * plan.chunk:min((r + 1) * plan.chunk, N)] += 1
    assert (hits == 1).all()
    assert plan.chunk % 4 == 0
    # what an H100 takes, and the layout the kernel writes into
    assert 1 <= plan.cluster <= 16 and plan.cluster & (plan.cluster - 1) == 0
    assert plan.smem <= tk.SMEM_PER_CTA == 232_448
    warps = tk.BWD_THREADS // 32
    assert plan.smem == 4 * (-(-C * T * T // 4) * 4
                             + warps * 4 * tk.BWD_WARP_WINDOW)
    # a CTA's warps each get at least one window of its chunk
    assert plan.cluster == 1 or plan.chunk >= warps * tk.BWD_WARP_WINDOW


def test_bwd_launch_plan_refuses_a_tile_that_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        tk.bwd_launch_plan(2, 2, 24, 4, 128, S512)


def _flow_cases():
    """(name, img, flow) as torch views, each over values in [-1, 1] and a
    flow of a few pixels made from a seed with numpy."""
    rng = np.random.RandomState(3)
    H, W = 16, 24

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    img = t(rng.rand(2, 3, H, W) * 2 - 1)
    flow = t(rng.randn(2, 2, H, W) * 4)
    flow[0, :, :3] = 100.0                            # leaves the image
    cat = torch.cat([img, flow], dim=1)               # the temporal loss's cat
    padded = t(rng.rand(2, 3, H, W + 2) * 2 - 1)[..., :W]   # rows 26 apart
    shifted = t(rng.rand(1 + img.numel()) * 2 - 1)[1:].view(2, 3, H, W)
    return [("contiguous", img, flow),
            ("image a strided channel view", cat[:, 1:], flow),
            ("flow a channel view of cat", cat[:, :3], cat[:, 3:]),
            ("odd width", t(rng.rand(2, 3, H, 22) * 2 - 1),
             t(rng.randn(2, 2, H, 22) * 4)),
            ("padded rows", padded, flow),
            ("unaligned storage", shifted, flow)]


@pytest.mark.parametrize("case", range(6))
def test_flow_warp_fwd_strided_views_match_jax(case):
    name, img, flow = _flow_cases()[case]
    got = fk.flow_warp_fwd(img, flow)
    assert got.is_contiguous() and got.shape == img.shape, name
    ref = np.asarray(j_flow_warp(
        jnp.asarray(np.moveaxis(img.numpy(), 1, -1)),
        jnp.asarray(np.moveaxis(flow.numpy(), 1, -1))))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(ref, -1, 1),
                               atol=FLOW_ATOL, err_msg=name)
