"""Checkpoint and resume (port of the JAX package's
``train/checkpoints.py``, on ``torch.save`` / ``torch.load``).

A checkpoint is one file ``step_<8+ digits>.pt`` holding the model's
``state_dict`` (parameters and BatchNorm running statistics), the
optimizer's ``state_dict`` and the step.  It is written beside its final
name and moved there with ``os.replace``, so a file that carries a
checkpoint's name is always whole; what a crashed save leaves behind has
another name, is never resumed from and is swept by the next save.

The per-subnetwork split of the model tree (``encoder.`` / head
prefixes) is what ``restore_encoder`` uses for the encoder-only transfer
between tasks (the ``pretrain`` path).

A checkpoint does not depend on the input pipeline that wrote it: the
optimizer is saved as an eager Adam saves it (step counters on the host,
not capturable), also from a capturable Adam (the device pipeline's, whose
steps run in CUDA graphs).  Restoring copies into the live state's
tensors, so everything lands on the state's device: parameters, running
statistics and Adam's moments beside their parameters, Adam's step
counters where the live optimizer keeps them (on the host, unless it is
capturable), and the live optimizer stays capturable or not.

Over several processes (``parallel/``) the state is the same on every
rank: process 0 alone writes and sweeps, the others wait for it at
``parallel.sync``, and every rank restores from the file.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from ..parallel import is_main, sync
from .state import TrainState, set_capturable

_NAME = re.compile(r"^step_(\d{8,})\.pt$")
_TMP = ".tmp-"


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int,
                    keep: int = 3) -> str:
    """Write ``state`` as ``ckpt_dir/step_<step>.pt``, keep the ``keep``
    newest checkpoints, and return the path (on every process; process 0
    writes, the others wait until it has)."""
    root = _abs(ckpt_dir)
    path = os.path.join(root, f"step_{step:08d}.pt")
    if is_main():
        os.makedirs(root, exist_ok=True)
        payload = {"model": state.model.state_dict(),
                   "optimizer": _eager_optimizer_state(state.optimizer),
                   "step": int(state.step)}
        tmp = f"{path}{_TMP}{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        _gc(root, keep)
    sync("checkpoint")
    return path


def _eager_optimizer_state(optimizer) -> dict:
    """``optimizer.state_dict()`` as an eager Adam writes it: step counters
    on the host, ``capturable`` off (new dicts; the live state is not
    touched)."""
    sd = optimizer.state_dict()
    for group in sd["param_groups"]:
        group["capturable"] = False
    sd["state"] = {i: {k: (v.cpu() if k == "step" else v)
                       for k, v in st.items()}
                   for i, st in sd["state"].items()}
    return sd


def _finalized_steps(root: str) -> list:
    """Names of the whole checkpoints under ``root``, ordered by step
    NUMBER (lexicographic order breaks past 8 digits)."""
    matches = (_NAME.fullmatch(d) for d in os.listdir(root))
    return [m.group(0) for m in
            sorted((m for m in matches if m), key=lambda m: int(m.group(1)))]


def _gc(root: str, keep: int) -> None:
    for name in _finalized_steps(root)[:-keep]:
        os.remove(os.path.join(root, name))
    # this runs right after a completed save, so any temporary file left
    # is a crashed save's: dead weight at full checkpoint size
    for name in os.listdir(root):
        if name.startswith("step_") and _TMP in name:
            os.remove(os.path.join(root, name))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The path of the newest whole checkpoint under ``ckpt_dir``, or
    None."""
    root = _abs(ckpt_dir)
    if not os.path.isdir(root):
        return None
    steps = _finalized_steps(root)
    return os.path.join(root, steps[-1]) if steps else None


def _load(path: str) -> dict:
    return torch.load(_abs(path), map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore the full train state (resume) in place; returns ``state``.
    The checkpoint must be of the same model: keys and shapes are checked
    strictly."""
    ckpt = _load(path)
    capturable = any(g.get("capturable", False)
                     for g in state.optimizer.param_groups)
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    set_capturable(state.optimizer, capturable)
    state.step = int(ckpt["step"])
    return state


def restore_encoder(path: str, state: TrainState) -> TrainState:
    """Encoder-only transfer: load just the ``encoder.*`` entries
    (parameters and running statistics) from a full checkpoint of any
    task's model into ``state``'s model, in place.  The head, the
    optimizer and the step stay as they are.  Raises ``KeyError`` when the
    two encoders do not have the same entries and ``ValueError`` on a
    shape mismatch; nothing is changed then."""
    saved = {k: v for k, v in _load(path)["model"].items()
             if k.startswith("encoder.")}
    live = {k: v for k, v in state.model.state_dict().items()
            if k.startswith("encoder.")}
    if set(saved) != set(live):
        raise KeyError(
            f"the checkpoint's encoder and the model's differ: only in the "
            f"checkpoint {sorted(set(saved) - set(live))}, only in the model "
            f"{sorted(set(live) - set(saved))}")
    for k, v in saved.items():
        if tuple(v.shape) != tuple(live[k].shape):
            raise ValueError(f"{k}: the checkpoint has shape "
                             f"{tuple(v.shape)}, the model "
                             f"{tuple(live[k].shape)}")
    with torch.no_grad():
        for k, v in saved.items():
            live[k].copy_(v)
    return state
