"""Train state and optimizer (port of the JAX package's ``train/state.py``).

Two Adams in one ``torch.optim.Adam`` (betas 0.9 / 0.999, eps 1e-8, no
weight decay), one parameter group per subnetwork: ``encoder`` and the
head.  Each group follows the reference's halving schedule, the encoder's
scaled by ``pretrain_lr_ratio`` when a pretrain path is set.  As with
optax, the learning rate of an update is the schedule's value at the
number of updates made before it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from ..config import Config
from ..models import build_model

Schedule = Callable[[int], float]


def halving_schedule(lr0: float, decay_step_epochs: int, ratio: float,
                     clip: float, steps_per_epoch: int) -> Schedule:
    """step -> lr, the closed form of the reference's halving loop.

    The reference decays after epoch e finishes, when ``e % step == 0 and
    e > 0``, so epoch e still trains at the old rate: the halvings in
    effect during epoch e are ``(e - 1) // step`` for e >= 1, not
    ``e // step``; the rate never drops below ``clip``."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        halvings = max(epoch - 1, 0) // max(decay_step_epochs, 1)
        return max(lr0 * ratio ** halvings, clip)

    return schedule


def make_optimizer(model: nn.Module, cfg: Config, steps_per_epoch: int
                   ) -> tuple[torch.optim.Adam, dict[str, Schedule]]:
    """Adam over ``model``'s parameters in two named groups, ``encoder``
    (the parameters under ``model.encoder``) and ``head`` (the rest), and
    the schedule of each group by name."""
    enc_lr0 = cfg.lr * (cfg.pretrain_lr_ratio if cfg.pretrain else 1.0)
    groups = {"encoder": [], "head": []}
    for name, p in model.named_parameters():
        groups["encoder" if name.startswith("encoder.") else "head"].append(p)
    opt = torch.optim.Adam(
        [{"params": ps, "name": n} for n, ps in groups.items() if ps],
        lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    schedules = {
        n: halving_schedule(lr0, cfg.lr_decay_step, cfg.lr_decay_ratio,
                            cfg.lr_clip, steps_per_epoch)
        for n, lr0 in (("encoder", enc_lr0), ("head", cfg.lr))}
    return opt, schedules


@dataclass
class TrainState:
    """The model (in train mode), its optimizer, each group's schedule, and
    the number of updates made."""

    model: nn.Module
    optimizer: torch.optim.Adam
    schedules: dict[str, Schedule]
    step: int = 0

    def apply_gradients(self) -> None:
        """One Adam update from the gradients in the parameters' ``.grad``,
        at each group's rate for the current step; then step += 1.  A
        parameter whose ``.grad`` is None (a bias that a BatchNorm follows)
        is left exactly as it is, as a zero gradient leaves it in optax."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedules[group["name"]](self.step)
        self.optimizer.step()
        self.step += 1


def init_state(cfg: Config, device: str | torch.device = "cuda",
               seed: int | None = None, steps_per_epoch: int = 100,
               model: nn.Module | None = None) -> TrainState:
    """The train state for ``cfg``: the model from ``build_model`` (or the
    one given) switched to train mode, and its optimizer."""
    if model is None:
        model = build_model(cfg, device=device, seed=seed)
    model.train()
    opt, schedules = make_optimizer(model, cfg, steps_per_epoch)
    return TrainState(model=model, optimizer=opt, schedules=schedules)
