"""Train state and optimizer (port of the JAX package's ``train/state.py``).

Two Adams in one ``torch.optim.Adam`` (betas 0.9 / 0.999, eps 1e-8, no
weight decay), one parameter group per subnetwork: ``encoder`` and the
head.  Each group follows the reference's halving schedule, the encoder's
scaled by ``pretrain_lr_ratio`` when a pretrain path is set.  As with
optax, the learning rate of an update is the schedule's value at the
number of updates made before it.

On a card the update of both groups is one call of the hand-written
kernel ``ops.cuda.adam_step`` (``adam_update``), which gives the bits of
the capturable foreach Adam; ``torch.optim.Adam`` still holds the state
(``exp_avg``, ``exp_avg_sq``, ``step``), so checkpoints, ``snapshot`` and
``set_capturable`` see what they saw.  On the CPU ``optimizer.step()``
runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from ..config import Config
from ..models import build_model
from ..ops.cuda.adam_step import adam_step

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
        is left exactly as it is, as a zero gradient leaves it in optax.
        Parameters on a card take ``adam_update``, on the CPU
        ``optimizer.step()``."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedules[group["name"]](self.step)
        if next(self.model.parameters()).is_cuda:
            adam_update(self.optimizer)
        else:
            self.optimizer.step()
        self.step += 1


def adam_update(optimizer: torch.optim.Adam) -> None:
    """``optimizer.step()`` for parameters on a card, in one call of
    ``ops.cuda.adam_step`` over both groups: each parameter with a
    gradient, at its group's rate.  A parameter's state is made at its
    first gradient as ``Adam`` makes it (zero moments; a float32 counter on
    the device when the group is capturable, on the host when not); one
    whose ``.grad`` is None is neither touched nor given state.  Raises on
    a group with weight decay, amsgrad or maximize, or with betas or eps
    other than another group's."""
    groups = optimizer.param_groups
    for group in groups:
        if (group["weight_decay"] or group["amsgrad"] or group["maximize"]
                or group["differentiable"]):
            raise ValueError(f"adam_update: group {group.get('name')} asks "
                             "for weight decay, amsgrad, maximize or a "
                             "differentiable step, which adam_step does not "
                             "compute")
    shared = {(tuple(g["betas"]), g["eps"]) for g in groups}
    if len(shared) != 1:
        raise ValueError(f"adam_update: the groups' betas and eps differ: "
                         f"{sorted(shared)}")
    params, grads, exp_avgs, exp_avg_sqs, steps, lrs = ([] for _ in range(6))
    for group in groups:
        for p in group["params"]:
            if p.grad is None:
                continue
            state = optimizer.state[p]
            if not state:
                state["step"] = (
                    torch.zeros((), dtype=torch.float32, device=p.device)
                    if group["capturable"] else torch.tensor(0.0))
                state["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            params.append(p)
            grads.append(p.grad)
            exp_avgs.append(state["exp_avg"])
            exp_avg_sqs.append(state["exp_avg_sq"])
            steps.append(state["step"])
            lrs.append(group["lr"])
    if params:
        adam_step(params, grads, exp_avgs, exp_avg_sqs, steps, lrs,
                  *shared.pop())


def set_capturable(optimizer: torch.optim.Optimizer, flag: bool) -> None:
    """Make ``optimizer`` (an Adam) capturable in a CUDA graph or not, in
    place: a capturable Adam keeps its step counters on the parameters'
    device and computes its bias correction there, an eager one keeps them
    on the host.  The counters' values are kept."""
    for group in optimizer.param_groups:
        group["capturable"] = flag
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st and "step" in st:
                st["step"] = st["step"].to(
                    device=p.device if flag else "cpu", dtype=torch.float32)


def snapshot(state: TrainState):
    """A function that puts back what a train step changes: weights,
    running statistics, Adam's state (a state first made by the step goes
    back to zeros, which is what a fresh Adam starts from), the step and
    the learning rates.  A captured step's warm-up runs the step once
    between the two (``train/graphs.py``)."""
    live = [*state.model.parameters(), *state.model.buffers()]
    saved = [t.detach().clone() for t in live]
    opt = {p: {k: v.clone() for k, v in s.items()}
           for p, s in state.optimizer.state.items()}
    step = state.step
    lrs = [g["lr"] for g in state.optimizer.param_groups]

    def restore():
        with torch.no_grad():
            for t, s in zip(live, saved):
                t.copy_(s)
            for p, s in state.optimizer.state.items():
                for k, v in s.items():
                    if p in opt:
                        v.copy_(opt[p][k])
                    else:
                        v.zero_()
        state.step = step
        for g, lr in zip(state.optimizer.param_groups, lrs):
            g["lr"] = lr

    return restore


def init_state(cfg: Config, device: str | torch.device = "cuda",
               seed: int | None = None, steps_per_epoch: int = 100,
               model: nn.Module | None = None, mesh=None) -> TrainState:
    """The train state for ``cfg``: the model from ``build_model`` (or the
    one given) switched to train mode, and its optimizer.  Under a mesh
    the weights and statistics are rank 0's on every rank
    (``parallel.replicate``)."""
    if model is None:
        model = build_model(cfg, device=device, seed=seed)
    if mesh is not None:
        from ..parallel import replicate
        model.load_state_dict(replicate(model.state_dict(), mesh))
    model.train()
    opt, schedules = make_optimizer(model, cfg, steps_per_epoch)
    return TrainState(model=model, optimizer=opt, schedules=schedules)
