"""Train and eval steps of the classify and segment tasks (port of the
JAX package's ``train/loops.py``).

Batches are dicts of tensors on the model's device:
``{"pc": (B, N, D), "sn": (B, N, D) | None, "node": (B, M, D),
   "node_knn_I": (B, M, som_k) | None, "label": (B,),
   "seg": (B, N) | None}``.

The epoch that drives the BatchNorm momentum decay and the learning rate
is ``state.step // steps_per_epoch``.  Random draws (point dropout, the
dropout masks) come from a ``torch.Generator`` the caller passes; torch
cannot reproduce JAX's random streams, so the two agree in distribution,
not in their bits.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..config import Config
from ..ops.iou import iou_per_shape
from . import losses
from .state import TrainState

Batch = Dict[str, Any]


def random_point_dropout(pc: torch.Tensor, sn: Optional[torch.Tensor],
                         generator: Optional[torch.Generator],
                         lower_limit: float):
    """Fixed-shape random point dropout: keep a random ``keep_num`` of the
    N points, drawn uniformly in ``[lower_limit, 1) * N``, the same subset
    for the whole batch, and refill the dropped slots with repeats of the
    kept points (the reference subsamples to a variable count; shapes stay
    fixed here, as in the JAX package).  The identity from a lower limit
    of 0.99 on, which is every task's default."""
    if lower_limit >= 0.99:
        return pc, sn
    N = pc.shape[1]
    dev = pc.device
    u = torch.rand((), generator=generator, device=dev)
    keep_ratio = lower_limit + (1.0 - lower_limit) * u
    keep_num = torch.clamp_min(torch.round(keep_ratio * N).long(), 1)
    perm = torch.randperm(N, generator=generator, device=dev)
    slot = torch.arange(N, device=dev)
    idx = torch.where(slot < keep_num, perm, perm[slot % keep_num])
    return (pc.index_select(1, idx),
            sn.index_select(1, idx) if sn is not None else None)


def make_classify_steps(cfg: Config, steps_per_epoch: int
                        ) -> tuple[Callable, Callable]:
    """(train_step, eval_step) for a classify (or retrieve) model.

    ``train_step(state, batch, generator)`` runs one forward in train mode,
    the cross-entropy backward and one Adam update, in place on ``state``
    (returned as well), and leaves this step's gradients in the
    parameters' ``.grad``.  Its metrics are the loss and the accuracy.

    ``eval_step(state, batch)`` runs the eval forward and returns the mean
    loss and accuracy, the per-item ``loss_i`` and ``correct_i``, and the
    ``score`` (B, classes)."""
    spe = max(steps_per_epoch, 1)

    def train_step(state: TrainState, batch: Batch,
                   generator: Optional[torch.Generator] = None):
        model = state.model
        model.train()
        epoch = state.step // spe
        pc, sn = random_point_dropout(batch["pc"], batch.get("sn"), generator,
                                      cfg.random_pc_dropout_lower_limit)
        state.optimizer.zero_grad(set_to_none=True)
        score, _ = model(pc, sn, batch["node"], batch.get("node_knn_I"),
                         epoch=epoch, generator=generator)
        loss = losses.cross_entropy(score, batch["label"])
        loss.backward()
        state.apply_gradients()
        score = score.detach()
        return state, {"loss": loss.detach(),
                       "accuracy": losses.accuracy(score, batch["label"])}

    def eval_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        model = state.model
        model.eval()
        with torch.no_grad():
            score, _ = model(batch["pc"], batch.get("sn"), batch["node"],
                             batch.get("node_knn_I"))
        label = batch["label"]
        loss_i = F.cross_entropy(score, label.long(), reduction="none")
        correct_i = score.argmax(-1) == label
        return {"loss": loss_i.mean(), "accuracy": correct_i.float().mean(),
                "loss_i": loss_i, "correct_i": correct_i, "score": score}

    return train_step, eval_step


def make_segment_steps(cfg: Config, steps_per_epoch: int
                       ) -> tuple[Callable, Callable]:
    """(train_step, eval_step) for a part-segmentation model; ``label`` is
    the shape category and ``seg`` the per-point part labels.

    ``train_step(state, batch, generator)`` is as the classify one, with
    the per-point cross-entropy and no point dropout; its metrics are the
    loss and the per-point ``seg_accuracy``.

    ``eval_step(state, batch)`` returns the mean ``loss``,
    ``seg_accuracy`` and ``iou``, the per-item ``loss_i`` (mean over the
    item's points), ``correct_i`` (its share of correct points) and
    ``iou_i``, and the ``score`` (B, N, classes)."""
    spe = max(steps_per_epoch, 1)

    def train_step(state: TrainState, batch: Batch,
                   generator: Optional[torch.Generator] = None):
        model = state.model
        model.train()
        epoch = state.step // spe
        state.optimizer.zero_grad(set_to_none=True)
        score, _ = model(batch["pc"], batch.get("sn"), batch["node"],
                         batch["label"], batch.get("node_knn_I"),
                         epoch=epoch, generator=generator)
        loss = losses.cross_entropy_seg(score, batch["seg"])
        loss.backward()
        state.apply_gradients()
        score = score.detach()
        return state, {"loss": loss.detach(),
                       "seg_accuracy": losses.seg_accuracy(score,
                                                           batch["seg"])}

    def eval_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        model = state.model
        model.eval()
        with torch.no_grad():
            score, _ = model(batch["pc"], batch.get("sn"), batch["node"],
                             batch["label"], batch.get("node_knn_I"))
        seg = batch["seg"]
        loss_i = F.cross_entropy(score.transpose(1, 2), seg.long(),
                                 reduction="none").mean(-1)          # (B,)
        pred = score.argmax(-1)
        correct_i = (pred == seg).float().mean(-1)
        iou_i = iou_per_shape(pred, seg, batch["label"])
        return {"loss": loss_i.mean(), "seg_accuracy": correct_i.mean(),
                "iou": iou_i.mean(), "loss_i": loss_i,
                "correct_i": correct_i, "iou_i": iou_i, "score": score}

    return train_step, eval_step


def make_steps(cfg: Config, steps_per_epoch: int
               ) -> tuple[Callable, Callable]:
    """(train_step, eval_step) for ``cfg.task``."""
    makers = {"classify": make_classify_steps,
              "retrieve": make_classify_steps,
              "segment": make_segment_steps}
    if cfg.task not in makers:
        raise NotImplementedError(
            f"task {cfg.task!r} is not ported yet (have {sorted(makers)})")
    return makers[cfg.task](cfg, steps_per_epoch)
