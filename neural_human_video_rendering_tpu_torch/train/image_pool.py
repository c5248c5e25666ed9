"""Fake-image history pool (pix2pixHD's ImagePool, --pool_size): the port
of the JAX package's ``train/image_pool.py``.

The discriminator trains on a mix of the generator's current output and
a history of earlier (pose labels, fake) pairs. The pool is a ring buffer
on the device, updated inside the train step with tensor ops only (no
host round trip), with the JAX package's semantics per batch element:
  * pool not yet full: the fake goes into the next empty slot, and D sees
    the fake;
  * pool full: with probability 1/2 the fake swaps with a random entry
    and D sees the evicted entry, else D sees the fake.
Random entries are drawn over the valid entries only, as distinct indices
once the pool is full (when B <= K); writes of lanes that neither fill
nor swap are dropped, and on a first batch larger than the pool (B > K,
count 0) the overflow lanes see their fresh fakes.

The randomness is split from the update: ``pool_draws`` takes it from an
explicit torch.Generator (the train state's), and ``pool_update`` is a
function of the draws, so a test can feed it the JAX package's own draws
(``jax.random`` streams are not torch's) and compare exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Draws = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]


def pool_draws(gen: torch.Generator, batch: int, size: int) -> Draws:
    """The randomness of one query: (uniform (B,) for the independent
    indices, a permutation of the K slots (None when B > K), uniform (B,)
    for the coins), on the generator's device."""
    dev = gen.device
    uni = torch.rand(batch, generator=gen, device=dev)
    perm = (torch.randperm(size, generator=gen, device=dev)
            if batch <= size else None)
    coin = torch.rand(batch, generator=gen, device=dev)
    return uni, perm, coin


def pool_update(pool: torch.Tensor, count: torch.Tensor, imgs: torch.Tensor,
                draws: Draws) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pooled query of D's fake input.

    pool: (K + 1, C, H, W) float32, rows 0..K-1 the history and row K the
    sink of dropped writes; count: () int64 valid entries; imgs:
    (B, C, H, W) the fresh detached (pose, fake) pairs; draws: pool_draws'.
    Writes the pool in place and returns (D's inputs (B, C, H, W), the new
    count). Where two writing lanes share a slot, the later lane's image
    stays (an in-order scatter, as XLA's on the CPU)."""
    uni, perm, coin_u = draws
    B, K = imgs.shape[0], pool.shape[0] - 1
    valid = torch.clamp(torch.clamp(count, max=K), min=1)
    uni_idx = torch.floor(uni * valid.float()).long()
    if perm is not None:
        rand_idx = torch.where(valid >= K, perm[:B], uni_idx)
    else:
        rand_idx = uni_idx
    coin = coin_u < 0.5
    slot = count + torch.arange(B, device=imgs.device)
    filling = slot < K
    use_hist = coin & ~filling & (count > 0)
    returned = torch.where(use_hist[:, None, None, None], pool[rand_idx],
                           imgs)
    write_idx = torch.where(filling, torch.clamp(slot, max=K - 1), rand_idx)
    do_write = filling | use_hist
    # a lane whose slot a later writing lane also writes is dropped
    later = torch.triu(torch.ones(B, B, dtype=torch.bool,
                                  device=imgs.device), diagonal=1)
    shadowed = ((write_idx[:, None] == write_idx[None, :]) & later
                & do_write[None, :]).any(1)
    write_idx = torch.where(do_write & ~shadowed, write_idx, K)
    pool.index_copy_(0, write_idx, imgs.to(pool.dtype))
    count = torch.clamp(count + filling.sum(), max=K)
    return returned, count
