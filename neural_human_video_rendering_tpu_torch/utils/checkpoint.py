"""Checkpoints: the port of the JAX package's ``utils/checkpoint.py``.

The pix2pixHD artifact contract in PyTorch's own format: per-subnet files
``{epoch}_net_{label}.pth`` plus a ``latest_net_{label}.pth`` copy under
``{checkpoints_dir}/{name}/``, each one module's ``state_dict`` through
``torch.save`` (tensors on the CPU), read back with ``weights_only=True``.
``latest_state.pth`` holds what resumes a run beyond the weights: both
optimizers' state_dicts (``ScheduledAdam`` adds its update count), the
step and the last completed epoch.

A run directory written by the JAX package holds ``.msgpack`` files
instead; ``load_net`` reads those too (``utils/flax_msgpack`` and the
bridge), preferring ``.pth`` where both exist.
"""

from __future__ import annotations

import io
import json
import os
import re
from typing import Dict, Optional

import torch

from ..models.bridge import state_dict_from_flax_file

EXT = ".pth"
JAX_EXT = ".msgpack"
STATE_FILE = "latest_state" + EXT
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


def has_latest(run_dir: str, label: str, ext: str = EXT) -> bool:
    """True when latest_net_{label} exists: the only artifact a run saved
    purely by --save_latest_freq iteration saves leaves behind."""
    return os.path.isfile(_path(run_dir, "latest", label, ext))


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


def _tolerant_load(optimizer, saved, label: str, step: int) -> None:
    """optimizer.load_state_dict that survives a changed parameter
    structure (keeps the fresh state, says so), then fast-forwards an
    update count still at 0 to the step, so an LR schedule resumes at the
    checkpoint's position."""
    try:
        optimizer.load_state_dict(saved)
    except (ValueError, KeyError) as e:
        print(f"[ckpt] {label}: optimizer structure changed ({e}); kept "
              "fresh init", flush=True)
    if step > 0 and getattr(optimizer, "count", None) == 0:
        optimizer.count = step


def load_train_state(run_dir: str, g_opt, d_opt):
    """Restore both optimizers from latest_state.pth; returns (step,
    saved epoch) or (None, None) when the file does not exist."""
    path = os.path.join(run_dir, STATE_FILE)
    if not os.path.exists(path):
        return None, None
    raw = torch.load(path, map_location="cpu", weights_only=True)
    step = int(raw["step"])
    _tolerant_load(g_opt, raw["g_opt"], "g_opt", step)
    _tolerant_load(d_opt, raw["d_opt"], "d_opt", step)
    return step, int(raw["epoch"])


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
