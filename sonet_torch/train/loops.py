"""Train and eval steps of the classify, segment and autoencode tasks
(port of the JAX package's ``train/loops.py``).

Batches are dicts of tensors on the model's device:
``{"pc": (B, N, D), "sn": (B, N, D) | None, "node": (B, M, D),
   "node_knn_I": (B, M, som_k) | None, "label": (B,),
   "seg": (B, N) | None}``.

The epoch that drives the BatchNorm momentum decay and the learning rate
is ``state.step // steps_per_epoch``.  Random draws (point dropout, the
dropout masks) come from a ``torch.Generator`` the caller passes; torch
cannot reproduce JAX's random streams, so the two agree in distribution,
not in their bits.

Under a (data, points) mesh (``mesh=``, ``parallel/``) a batch is this
rank's block (``parallel.shard_batch``) and each step runs in
``parallel.collectives.use_mesh``: the model's reductions are global, a
train step's gradients are averaged over the mesh before the update
(``collectives.sync_grads``), and the scalar metrics are the global
batch's (the mean over ``data`` of each data rank's).  The per-item
``*_i`` columns and the outputs stay this rank's block: the caller
gathers them (``parallel.fetch_global``) or sums them itself.  The
state is the same on every rank after every step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..config import Config
from ..ops.chamfer import chamfer
from ..parallel import collectives
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
    of 0.99 on, which is every task's default.  Under a split points
    axis ``pc`` is this rank's block: the subset is drawn over the whole
    cloud, as one process draws it, and the rank keeps its slots."""
    if lower_limit >= 0.99:
        return pc, sn
    P = collectives.axis_size("points")
    N = pc.shape[1] * P
    dev = pc.device
    u = torch.rand((), generator=generator, device=dev)
    keep_ratio = lower_limit + (1.0 - lower_limit) * u
    keep_num = torch.clamp_min(torch.round(keep_ratio * N).long(), 1)
    perm = torch.randperm(N, generator=generator, device=dev)
    slot = torch.arange(N, device=dev)
    idx = torch.where(slot < keep_num, perm, perm[slot % keep_num])
    if P > 1:
        # a split points axis: every rank draws the whole cloud's subset
        # from the same generator state, gathers the cloud and keeps the
        # slots of its own block
        from ..parallel.distributed import all_gather
        mesh, n = collectives.active(), pc.shape[1]
        p = collectives.axis_index("points")
        idx = idx[p * n:(p + 1) * n]
        pc = all_gather(pc, ("points",), mesh, lead=1)
        sn = all_gather(sn, ("points",), mesh, lead=1) if sn is not None \
            else None
    return (pc.index_select(1, idx),
            sn.index_select(1, idx) if sn is not None else None)


def _over_mesh(train_step: Callable, eval_step: Callable, mesh
               ) -> tuple[Callable, Callable]:
    """The steps run inside ``use_mesh(mesh)``: the train step's gradients
    averaged over the mesh before its update, and the scalar metrics of
    both reduced over ``data``."""
    if mesh is None:
        return train_step, eval_step

    def mesh_train_step(state, batch, generator=None):
        with collectives.use_mesh(mesh):
            state, metrics = train_step(state, batch, generator)
            return state, {k: collectives.mean_over_data(v)
                           for k, v in metrics.items()}

    def mesh_eval_step(state, batch):
        with collectives.use_mesh(mesh):
            m = eval_step(state, batch)
            return {k: (collectives.mean_over_data(v) if v.dim() == 0 else v)
                    for k, v in m.items()}

    return mesh_train_step, mesh_eval_step


def _update(state: TrainState) -> None:
    """The gradients averaged over the mesh in effect, then Adam."""
    mesh = collectives.active()
    collectives.sync_grads(state.model, mesh)
    state.apply_gradients()


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
        _update(state)
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
        _update(state)
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
        ce = F.cross_entropy(score.transpose(1, 2), seg.long(),
                             reduction="none")                   # (B, N)
        pred = score.argmax(-1)
        right = (pred == seg).float()
        P = collectives.axis_size("points")
        if P == 1:
            loss_i, correct_i = ce.mean(-1), right.mean(-1)     # (B,)
        else:   # every rank's sums over the item's points, global count
            n = seg.shape[1] * P
            loss_i = collectives.reduce_points(ce.sum(-1)) / n
            correct_i = collectives.reduce_points(right.sum(-1)) / n
        iou_i = iou_per_shape(pred, seg, batch["label"])
        return {"loss": loss_i.mean(), "seg_accuracy": correct_i.mean(),
                "iou": iou_i.mean(), "loss_i": loss_i,
                "correct_i": correct_i, "iou_i": iou_i, "score": score}

    return train_step, eval_step


def _ae_loss(cfg: Config, dec, pc: torch.Tensor):
    """Multi-scale Chamfer loss against the cloud ``pc``: the final cloud,
    plus the conv pyramid's lower taps (``conv_pc4`` when the conv branch
    emits 1024 points, ``conv_pc4`` and ``conv_pc5`` when 4096).  Returns
    the loss and its parts by name."""
    total = chamfer(dec.pc, pc)
    loss = total.loss
    aux = {"chamfer": total.loss, "chamfer_fwd": total.forward_loss,
           "chamfer_bwd": total.backward_loss}
    if cfg.output_conv_pc_num == 1024:
        c4 = chamfer(dec.conv_pc4, pc)
        loss = loss + c4.loss
        aux["chamfer_pc4"] = c4.loss
    elif cfg.output_conv_pc_num == 4096:
        c4 = chamfer(dec.conv_pc4, pc)
        c5 = chamfer(dec.conv_pc5, pc)
        loss = loss + c4.loss + c5.loss
        aux["chamfer_pc4"] = c4.loss
        aux["chamfer_pc5"] = c5.loss
    aux["loss"] = loss
    return loss, aux


def make_autoencode_steps(cfg: Config, steps_per_epoch: int
                          ) -> tuple[Callable, Callable]:
    """(train_step, eval_step) for an autoencoder model.

    ``train_step(state, batch, generator)`` is as the classify one, with
    the multi-scale Chamfer loss taken against the input cloud after the
    random point dropout; its metrics are the loss and its parts
    (``_ae_loss``).

    ``eval_step(state, batch)`` returns the same parts from the eval
    forward, the per-item ``loss_i``, ``chamfer_fwd_i`` and
    ``chamfer_bwd_i`` of the final cloud (B,), and ``predicted_pc``
    (B, output points, 3)."""
    spe = max(steps_per_epoch, 1)

    def train_step(state: TrainState, batch: Batch,
                   generator: Optional[torch.Generator] = None):
        model = state.model
        model.train()
        epoch = state.step // spe
        pc, sn = random_point_dropout(batch["pc"], batch.get("sn"), generator,
                                      cfg.random_pc_dropout_lower_limit)
        state.optimizer.zero_grad(set_to_none=True)
        dec, _ = model(pc, sn, batch["node"], batch.get("node_knn_I"),
                       epoch=epoch, generator=generator)
        loss, aux = _ae_loss(cfg, dec, pc)
        loss.backward()
        _update(state)
        return state, {k: v.detach() for k, v in aux.items()}

    def eval_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        model = state.model
        model.eval()
        with torch.no_grad():
            dec, _ = model(batch["pc"], batch.get("sn"), batch["node"],
                           batch.get("node_knn_I"))
            _, aux = _ae_loss(cfg, dec, batch["pc"])
            c = chamfer(dec.pc, batch["pc"])
        aux.update(loss_i=c.loss_array, chamfer_fwd_i=c.forward_array,
                   chamfer_bwd_i=c.backward_array, predicted_pc=dec.pc)
        return aux

    return train_step, eval_step


def make_steps(cfg: Config, steps_per_epoch: int, mesh=None
               ) -> tuple[Callable, Callable]:
    """(train_step, eval_step) for ``cfg.task``, over ``mesh`` when one is
    given (the module docstring)."""
    makers = {"classify": make_classify_steps,
              "retrieve": make_classify_steps,
              "segment": make_segment_steps,
              "autoencode": make_autoencode_steps}
    if cfg.task not in makers:
        raise NotImplementedError(
            f"unknown task {cfg.task!r} (have {sorted(makers)})")
    return _over_mesh(*makers[cfg.task](cfg, steps_per_epoch), mesh)
