"""PyTorch port, the image pool (--pool_size) and the trunk freeze of
--niter_fix_global, against the JAX package.

The pool: ``pool_update`` fed the draws the JAX package's ``pool_query``
makes from its key (``jax.random`` streams are not torch's), over a
sequence of batches that fills the pool and crosses the full boundary,
and with a batch larger than the pool; D's inputs, the pool and the count
compared exactly. The freeze: ``make_optimizer`` against the JAX
package's optax chain (freeze_scope_until ahead of Adam, with the LR
schedule) over updates that cross the unfreeze, straight and resumed
through a checkpoint in the middle of the freeze; 1e-6 absolute, as
test_adam_and_schedule_match_optax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neural_human_video_rendering_tpu.config import Options as JOptions
from neural_human_video_rendering_tpu.train import state as jstate
from neural_human_video_rendering_tpu.train.image_pool import pool_query
from neural_human_video_rendering_tpu_torch.config import Options as TOptions
from neural_human_video_rendering_tpu_torch.train import state as tstate
from neural_human_video_rendering_tpu_torch.train.image_pool import (
    pool_draws, pool_update)
from neural_human_video_rendering_tpu_torch.utils import checkpoint as ckpt

ADAM_ATOL = 1e-6


def _draws(key, B, K):
    """pool_query's draws from `key`, in pool_draws' form."""
    k_idx, k_coin, _ = jax.random.split(key, 3)
    perm = (torch.from_numpy(np.array(jax.random.permutation(k_idx, K),
                                      np.int64)) if B <= K else None)
    return (torch.from_numpy(np.array(jax.random.uniform(k_idx, (B,)))),
            perm,
            torch.from_numpy(np.array(jax.random.uniform(k_coin, (B,)))))


@pytest.mark.parametrize("B,K,steps", [(2, 5, 7), (3, 2, 4)])
def test_pool_update_matches_pool_query(B, K, steps):
    """(2, 5): three batches fill the pool, the third crosses the full
    boundary (independent draws over the valid entries), then distinct
    draws; (3, 2): B > K, the first batch's overflow lanes see their own
    fakes (count 0), then colliding swaps."""
    C, H, W = 3, 4, 5
    rng = np.random.default_rng(B * 10 + K)
    jpool, jn = jnp.zeros((K, H, W, C), jnp.float32), jnp.int32(0)
    key = jax.random.PRNGKey(7)
    tpool = torch.zeros((K + 1, C, H, W))
    tn = torch.zeros((), dtype=torch.int64)
    swapped = 0
    for _ in range(steps):
        imgs = rng.standard_normal((B, H, W, C)).astype(np.float32)
        draws = _draws(key, B, K)
        ref, jpool, jn, key_next = pool_query(jpool, jn, key,
                                              jnp.asarray(imgs))
        got, tn = pool_update(tpool, tn, torch.from_numpy(
            imgs.transpose(0, 3, 1, 2).copy()), draws)
        key = key_next
        np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1),
                                      np.asarray(ref))
        np.testing.assert_array_equal(tpool[:K].numpy().transpose(0, 2, 3, 1),
                                      np.asarray(jpool))
        assert int(tn) == int(jn)
        swapped += int((np.asarray(ref) != imgs).any((1, 2, 3)).sum())
    assert int(tn) == K and swapped > 0


def test_pool_draws_from_the_generator():
    gen = torch.Generator().manual_seed(3)
    uni, perm, coin = pool_draws(gen, 2, 5)
    assert uni.shape == coin.shape == (2,) and sorted(perm.tolist()) == \
        list(range(5))
    again = pool_draws(torch.Generator().manual_seed(3), 2, 5)
    assert all(torch.equal(a, b) for a, b in zip((uni, perm, coin), again))
    assert pool_draws(gen, 3, 2)[1] is None


NAMES = ("TransG.LocalEnhancer_0.global_trunk.ConvNormRelu_0.w",
         "TransG.LocalEnhancer_0.enh1_stem.w",
         "TexG.LocalEnhancer_0.global_trunk.ResnetBlock_0.b",
         "BGNet.my_global_trunk_ext.w")
FLAGS = dict(lr=1e-2, beta1=0.5, beta2=0.999, niter=2, niter_decay=2,
             netG="local", niter_fix_global=1)


def _tree(flat):
    out = {}
    for name, v in flat.items():
        node = out
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _optax_run(p0, grads):
    """The JAX package's optimizer over the grads: the params after each
    update, flat by name."""
    tx = jstate.make_optimizer(JOptions(**FLAGS), steps_per_epoch=2)
    p = jax.tree.map(jnp.asarray, _tree(p0))
    s = tx.init(p)
    out = []
    for g in grads:
        ups, s = tx.update(jax.tree.map(jnp.asarray, _tree(g)), s, p)
        p = optax.apply_updates(p, ups)
        flat = {}
        for name in NAMES:
            node = p
            for part in name.split("."):
                node = node[part]
            flat[name] = np.asarray(node)
        out.append(flat)
    return out


@pytest.mark.parametrize("resume_at", [0, 1])
def test_freeze_matches_optax(resume_at, tmp_path):
    """--netG local --niter_fix_global 1 at 2 steps an epoch: the
    parameters under a global_trunk component (not the one whose name
    merely contains it) stay bit-equal for 2 updates, then move as optax's
    do (one shared Adam count, the bias correction included), the LR
    decaying after epoch 2. resume_at 1 saves the optimizers after the
    first update (inside the freeze) and resumes fresh ones from the file
    (utils/checkpoint), as --continue_train does."""
    rng = np.random.default_rng(2)
    p0 = {n: rng.standard_normal(3).astype(np.float32) for n in NAMES}
    grads = [{n: rng.standard_normal(3).astype(np.float32) for n in NAMES}
             for _ in range(6)]
    ref = _optax_run(p0, grads)
    opt = TOptions(**FLAGS)

    def fresh(values):
        params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
                  for n, v in values.items()}
        return params, tstate.make_optimizer(opt, list(params.items()), 2)

    params, adam = fresh(p0)
    assert len(adam.frozen) == 2 and adam.frozen_steps == 2
    for t, g in enumerate(grads):
        if resume_at and t == resume_at:
            ckpt.save_train_state(str(tmp_path), adam, adam, t, -1)
            params, adam = fresh({n: v.detach().numpy()
                                  for n, v in params.items()})
            step, _ = ckpt.load_train_state(str(tmp_path), adam, adam)
            assert step == t and adam.count == t
        for n, v in params.items():
            v.grad = torch.from_numpy(g[n])
        adam.step()
        for n in NAMES:
            got = params[n].detach().numpy()
            if t < 2 and "global_trunk" in n.split("."):
                np.testing.assert_array_equal(got, p0[n], err_msg=n)
            np.testing.assert_allclose(got, ref[t][n], rtol=0,
                                       atol=ADAM_ATOL, err_msg=f"{n} {t}")
    assert adam.count == 6
    assert not np.array_equal(params[NAMES[0]].detach().numpy(), p0[NAMES[0]])


def test_freeze_needs_local_epochs_and_names():
    p = [("a.global_trunk.w", torch.nn.Parameter(torch.ones(2)))]
    assert tstate.make_optimizer(TOptions(**FLAGS), p, 2).frozen_steps == 2
    for over, spe in ((dict(netG="global"), 2), (dict(niter_fix_global=0), 2),
                      ({}, 0)):
        o = TOptions(**{**FLAGS, **over})
        assert tstate.make_optimizer(o, p, spe).frozen == []
    assert tstate.make_optimizer(TOptions(**FLAGS), [p[0][1]], 2).frozen == []
