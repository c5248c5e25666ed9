"""Checkpoints: the port of the JAX package's ``utils/checkpoint.py``.

The pix2pixHD artifact contract in PyTorch's own format: per-subnet files
``{epoch}_net_{label}.pth`` plus a ``latest_net_{label}.pth`` copy under
``{checkpoints_dir}/{name}/``, each one module's ``state_dict`` through
``torch.save`` (tensors on the CPU), read back with ``weights_only=True``.
``latest_state.pth`` holds what resumes a run beyond the weights: both
optimizers' state_dicts (``ScheduledAdam`` adds its update count), the
step and the last completed epoch. The update count drives the LR
schedule and --niter_fix_global's freeze of the LocalEnhancer trunk; a
resume restores it, or fast-forwards a fresh one to the saved step, so a
run resumed inside the freeze stays frozen until the step it would have
unfrozen at (the JAX package fast-forwards its freeze counter the same
way). The image pool of --pool_size is not saved, as in the JAX package:
a resumed run starts with an empty pool.

A run directory written by the JAX package holds ``.msgpack`` files
instead; ``load_net`` reads those too (``utils/flax_msgpack`` and the
bridge), preferring ``.pth`` where both exist, and ``load_train_state``
reads its ``latest_state.msgpack`` (optax's Adam moments and counts, the
schedule's count and the --niter_fix_global freeze's) into the two
ScheduledAdams, with the JAX package's two tolerances: leaves whose path
and shape match are restored, the rest keep their fresh init (one message
counts them), and a schedule or freeze count still at 0 after a resume at
step > 0 is fast-forwarded to the step.
"""

from __future__ import annotations

import io
import json
import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from ..models.bridge import (flax_layout, leaf_from_jax,
                             state_dict_from_flax_file)
from . import flax_msgpack

EXT = ".pth"
JAX_EXT = ".msgpack"
STATE_FILE = "latest_state" + EXT
JAX_STATE_FILE = "latest_state" + JAX_EXT
ANCHOR_FILE = "latest_anchor.json"
# a residual block's prefix in a state_dict key
_RESBLOCK = re.compile(r"^(.*\.)?ResnetBlock_\d+(?=\.)")


def _path(run_dir: str, epoch, label: str, ext: str = EXT) -> str:
    return os.path.join(run_dir, f"{epoch}_net_{label}{ext}")


def _write_atomic(path: str, data: bytes) -> None:
    """Write-then-rename: a crash mid-write cannot truncate an existing
    checkpoint, and a run dir cloned with ``cp -al`` keeps its parent's
    files (os.replace gives the destination a fresh inode)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _torch_bytes(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _cpu(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in state_dict.items()}


def save_net(run_dir: str, label: str, epoch, state_dict) -> str:
    """Save one module's state_dict as {epoch}_net_{label}.pth and
    latest_net_{label}.pth; returns the first path."""
    os.makedirs(run_dir, exist_ok=True)
    blob = _torch_bytes(_cpu(state_dict))
    path = _path(run_dir, epoch, label)
    _write_atomic(path, blob)
    latest = _path(run_dir, "latest", label)
    if os.path.abspath(path) != os.path.abspath(latest):
        _write_atomic(latest, blob)
    return path


def find_net(run_dir: str, label: str, epoch="latest") -> Optional[str]:
    """The file of `label` at `epoch`: .pth first, then .msgpack."""
    for ext in (EXT, JAX_EXT):
        p = _path(run_dir, epoch, label, ext)
        if os.path.isfile(p):
            return p
    return None


def load_net(run_dir: str, label: str, epoch="latest") -> Dict[str, torch.Tensor]:
    """One module's state_dict (CPU tensors) from a .pth file or, where
    there is none, the JAX package's .msgpack file."""
    path = find_net(run_dir, label, epoch)
    if path is None:
        raise FileNotFoundError(
            f"no {epoch}_net_{label}{EXT} or {JAX_EXT} in {run_dir}")
    if path.endswith(JAX_EXT):
        return state_dict_from_flax_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_net_into(module: torch.nn.Module, run_dir: str, label: str,
                  epoch="latest") -> str:
    """load_net into `module` (strict: a missing or extra key fails);
    returns the file read."""
    module.load_state_dict(load_net(run_dir, label, epoch), strict=True)
    return find_net(run_dir, label, epoch)


def has_latest(run_dir: str, label: str, exts=(EXT, JAX_EXT)) -> bool:
    """True when latest_net_{label} exists (.pth or .msgpack): the only
    artifact a run saved purely by --save_latest_freq iteration saves
    leaves behind."""
    return any(os.path.isfile(_path(run_dir, "latest", label, ext))
               for ext in exts)


def latest_epoch(run_dir: str, label: str,
                 exts=(EXT, JAX_EXT)) -> Optional[str]:
    """Highest numeric epoch with a saved file for `label`, or None."""
    if not os.path.isdir(run_dir):
        return None
    best = None
    for f in os.listdir(run_dir):
        for ext in exts:
            if f.endswith(f"_net_{label}{ext}"):
                tag = f.split("_net_")[0]
                if tag.isdigit() and (best is None or int(tag) > int(best)):
                    best = tag
    return best


def save_epoch_anchor(run_dir: str, epoch: int) -> None:
    """Sidecar recording the last COMPLETED epoch, for the single-net
    pretrain stages whose iteration 'latest' saves carry no state file,
    so --continue_train resumes in place instead of at epoch 1."""
    _write_atomic(os.path.join(run_dir, ANCHOR_FILE),
                  json.dumps({"epoch": int(epoch)}).encode())


def load_epoch_anchor(run_dir: str) -> Optional[int]:
    path = os.path.join(run_dir, ANCHOR_FILE)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return int(json.load(f)["epoch"])
    except (ValueError, KeyError, OSError):
        return None


def saved_epoch(run_dir: str) -> Optional[int]:
    """The last completed epoch that a run dir's latest save records:
    latest_state.pth's epoch (stage 2), else the pretrain stages' epoch
    anchor (load_epoch_anchor); None where neither records one."""
    path = os.path.join(run_dir, STATE_FILE)
    if os.path.exists(path):
        ep = int(torch.load(path, map_location="cpu",
                            weights_only=True)["epoch"])
        return ep if ep >= 0 else None
    return load_epoch_anchor(run_dir)


def save_train_state(run_dir: str, g_opt, d_opt, step: int, epoch) -> str:
    """latest_state.pth: both optimizers' state (Adam moments, update
    counts), the step and the epoch (-1 when unknown). With the
    latest_net_* files this makes --continue_train a full resume."""
    os.makedirs(run_dir, exist_ok=True)
    blob = {"g_opt": g_opt.state_dict(), "d_opt": d_opt.state_dict(),
            "step": int(step),
            "epoch": int(epoch) if str(epoch).lstrip("-").isdigit() else -1}
    path = os.path.join(run_dir, STATE_FILE)
    _write_atomic(path, _torch_bytes(blob))
    return path


def _stamp(count: int, step: int) -> int:
    """A count still at 0 after a resume at step > 0 is fast-forwarded to
    the step, so an LR schedule (or the freeze) added on resume starts at
    the checkpoint's position instead of from scratch."""
    return step if step > 0 and count == 0 else count


def _tolerant_load(optimizer, saved, label: str, step: int) -> None:
    """optimizer.load_state_dict that survives a changed parameter
    structure (keeps the fresh state, says so), then fast-forwards the
    update counts (_stamp)."""
    try:
        optimizer.load_state_dict(saved)
    except (ValueError, KeyError) as e:
        print(f"[ckpt] {label}: optimizer structure changed ({e}); kept "
              "fresh init", flush=True)
    if hasattr(optimizer, "count"):
        optimizer.count = _stamp(optimizer.count, step)
        optimizer.freeze_count = _stamp(optimizer.freeze_count, step)


# ---- a JAX run's optimizer state (optax's layout, flax's to_state_dict)

def _optax_target(optimizer, module) -> dict:
    """The state tree the JAX package's make_optimizer would hold for this
    ScheduledAdam over `module`, leaves as their shapes:
    ``{'0': {count, mu, nu}, '1': {count} or {}}`` (Adam, then the
    schedule's count, {} without decay), under --niter_fix_global's freeze
    ``{'0': {count}, '1': <that>}``. mu and nu are flax parameter trees."""
    params: dict = {}
    for name, p in module.named_parameters():
        path, shape = flax_layout(name, p.shape)
        node = params
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = shape
    inner = {"0": {"count": (), "mu": params, "nu": params},
             "1": {"count": ()} if optimizer.scheduled else {}}
    if optimizer.frozen_steps > 0:
        return {"0": {"count": ()}, "1": inner}
    return inner


def _merge(target, raw, path: str, dropped: list):
    """The JAX package's _tolerant_from_state_dict merge: every leaf of
    `target` whose path exists in `raw` with the same shape is taken from
    it; any other (a missing key, a subtree where a leaf is expected or
    the reverse, another shape) is None (fresh) and its path is recorded.
    Keys of `raw` that the target lacks are ignored."""
    if isinstance(target, dict) and isinstance(raw, dict):
        return {k: _merge(v, raw.get(k), f"{path}/{k}", dropped)
                for k, v in target.items()}
    if isinstance(target, dict) or isinstance(raw, dict) or raw is None \
            or tuple(np.shape(raw)) != tuple(target):
        dropped.append(path or "/")
        return None
    return raw


def _leaf(tree, path):
    for part in path:
        if not isinstance(tree, dict):
            return None
        tree = tree.get(part)
    return tree


def _count(node) -> Optional[int]:
    c = _leaf(node, ("count",))
    return None if c is None else int(np.asarray(c))


def load_jax_optimizer(optimizer, module, raw, label: str, step: int) -> None:
    """One optimizer's state of a JAX run (``g_opt`` / ``d_opt`` of
    latest_state.msgpack) into the ScheduledAdam over `module`. Adam's
    mu / nu leaves become exp_avg / exp_avg_sq through the bridge's
    layout change of their parameter (a permutation: bit-equal), optax's
    Adam count each parameter's step; the schedule's count the optimizer's
    count, the freeze's its freeze_count (either fast-forwarded from 0 to
    the step: _stamp). What the merge drops keeps its fresh init: zero
    moments, or no state at all where nothing of Adam was restored."""
    dropped: list = []
    merged = _merge(_optax_target(optimizer, module), raw, "", dropped)
    if dropped:
        print(f"[ckpt] {label}: optimizer structure changed; kept fresh init "
              f"for {len(dropped)} subtree(s) (schedule change?)", flush=True)
    freeze, inner = ((_leaf(merged, ("0",)), _leaf(merged, ("1",)))
                     if optimizer.frozen_steps > 0 else (None, merged))
    adam = _leaf(inner, ("0",))
    adam_count = _count(adam)
    names = {id(p): n for n, p in module.named_parameters()}
    state = {}
    for i, p in enumerate(optimizer.param_groups[0]["params"]):
        path = flax_layout(names[id(p)], p.shape)[0]
        moments = []
        for kind in ("mu", "nu"):
            arr = _leaf(adam, (kind, *path))
            moments.append(None if arr is None else
                           leaf_from_jax(".".join(path), np.asarray(arr))[1])
        if adam_count is None and moments == [None, None]:
            continue
        state[i] = {"step": torch.tensor(float(adam_count or 0)),
                    "exp_avg": (moments[0] if moments[0] is not None
                                else torch.zeros_like(p, device="cpu")),
                    "exp_avg_sq": (moments[1] if moments[1] is not None
                                   else torch.zeros_like(p, device="cpu"))}
    sched = _count(_leaf(inner, ("1",))) if optimizer.scheduled else None
    count = _stamp(sched or 0, step)
    freeze_count = (_stamp(_count(freeze) or 0, step)
                    if optimizer.frozen_steps > 0 else count)
    optimizer.load_state_dict({
        "state": state,
        "param_groups": optimizer.state_dict()["param_groups"],
        "count": count, "freeze_count": freeze_count})


def load_train_state(run_dir: str, g_opt, d_opt, modules=None):
    """Restore both optimizers from latest_state.pth or, where the run dir
    holds the JAX package's latest_state.msgpack instead, from that (then
    ``modules`` = (G, D), the modules the two optimizers update, is
    required); returns (step, saved epoch) or (None, None) when neither
    file exists."""
    path = os.path.join(run_dir, STATE_FILE)
    jax_path = os.path.join(run_dir, JAX_STATE_FILE)
    if os.path.exists(path):
        raw = torch.load(path, map_location="cpu", weights_only=True)
        step = int(raw["step"])
        _tolerant_load(g_opt, raw["g_opt"], "g_opt", step)
        _tolerant_load(d_opt, raw["d_opt"], "d_opt", step)
        return step, int(raw["epoch"])
    if not os.path.exists(jax_path):
        return None, None
    if modules is None:
        raise ValueError(f"{jax_path}: a JAX run's optimizer state needs the "
                         "modules the optimizers update")
    raw = flax_msgpack.restore(jax_path)
    step = int(np.asarray(raw["step"]))
    for label, optimizer, module in (("g_opt", g_opt, modules[0]),
                                     ("d_opt", d_opt, modules[1])):
        load_jax_optimizer(optimizer, module, raw[label], label, step)
    return step, int(np.asarray(raw["epoch"]))


def load_transg_into(renderer: torch.nn.Module, pretrain_dir: str,
                     epoch="latest") -> str:
    """Partial restore: a stage-1 TransG into the stage-2 renderer
    (--load_pretrain_TransG / --which_epoch_TransG).

    A file of the module's structure loads strictly. One that differs from
    it only in the number of residual blocks loads as pix2pixHD's
    load_network loads it: the blocks both have come from the file, the
    others keep their fresh init, and the run says which. The reference's
    own launchers need it: pretrain_trans.sh trains a 5-block TransG,
    train_e2e.sh builds the default 9 (the JAX package refuses that pair).
    Any other difference (a width, the input channels, the downsampling)
    is refused as before."""
    module = renderer.TransG
    saved = load_net(pretrain_dir, "TransG", epoch)
    path = find_net(pretrain_dir, "TransG", epoch)
    own = module.state_dict()
    odd = own.keys() ^ saved.keys()
    clash = sorted(k for k in own.keys() & saved.keys()
                   if own[k].shape != saved[k].shape)
    other = sorted(k for k in odd if not _RESBLOCK.match(k))
    if clash or other:
        raise RuntimeError(
            f"{path} does not fit this TransG beyond its number of residual "
            f"blocks: shapes differ in {clash[:4]}, keys in {other[:4]}")
    module.load_state_dict({**own, **{k: saved[k] for k in own if k in saved}},
                           strict=True)
    if odd:
        fresh = sorted({_RESBLOCK.match(k).group(0) for k in own if k in odd})
        unused = sorted({_RESBLOCK.match(k).group(0)
                         for k in saved if k in odd})
        print(f"[ckpt] {path} has another number of residual blocks than "
              f"this TransG: fresh init kept in {fresh}; not used from the "
              f"file: {unused}", flush=True)
    return path
