"""The epoch-loop trainer shared by every task (port of the JAX package's
``train/trainer.py``), on one device with the host input pipeline.

Kept from the JAX package, and through it from the reference's four
train scripts (modelnet/train.py, shrec16/train.py, part-seg/train.py,
autoencoder/train.py):

* per-epoch eval weighted by the true item counts (modelnet/train.py:78-90):
  a padded last batch counts only its valid items;
* checkpoints gated on the task metric and a threshold
  (modelnet/train.py:96-103, part-seg/train.py:110-113), plus ungated saves
  every ``checkpoint_every`` steps;
* the encoder-only ``pretrain`` restore (modelnet/train.py:33-34);
* auto-resume from the newest checkpoint of the run, and a graceful stop
  on SIGTERM/SIGINT that checkpoints first;
* host batches read and augmented on the loader's threads, ahead of the
  step that reads them, and copied to the device asynchronously.

The JAX package's device-resident and native input pipelines, its mesh
and its multi-process runs are not ported yet; asking for them raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that brings them.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..data.pipeline import BatchLoader
from ..device import resolve_device
from ..utils.logging import MetricLogger
from . import checkpoints
from .loops import make_steps
from .state import init_state

_EVAL_NAMES = {"loss_i": "loss", "correct_i": "accuracy", "iou_i": "iou"}


def build_dataset(cfg: Config, mode: str, device: str | torch.device = "cuda"):
    """The dataset of ``cfg.dataset`` for ``mode``; ``device`` is where the
    synthetic dataset fits its SOM nodes (the others read theirs from
    disk)."""
    if cfg.dataset == "synthetic":
        from ..data.synthetic import SyntheticDataset
        mult = 16 if mode == "train" else 4
        return SyntheticDataset(cfg,
                                size=max(cfg.batch_size * mult,
                                         cfg.classes * (4 if mode != "train"
                                                        else 8)),
                                mode=mode, seed=cfg.seed, device=device)
    if cfg.dataset == "modelnet":
        from ..data.modelnet import ModelNetDataset
        return ModelNetDataset(cfg.dataroot, mode, cfg)
    if cfg.dataset == "shrec":
        from ..data.modelnet import ShrecDataset
        return ShrecDataset(cfg.dataroot, mode, cfg)
    if cfg.dataset == "shapenet":
        from ..data.shapenet import ShapeNetPartDataset
        return ShapeNetPartDataset(cfg.dataroot, mode, cfg)
    if cfg.dataset == "mnist":
        raise NotImplementedError(
            "dataset 'mnist': the MNIST loader is not ported yet "
            "(ROADMAP.md §1 item 11c)")
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


def _metric_key(cfg: Config) -> tuple[str, bool]:
    """(metric name, higher_is_better) for checkpoint gating."""
    return {
        "classify": ("accuracy", True),
        "retrieve": ("accuracy", True),
        "segment": ("iou", True),
        "autoencode": ("loss", False),
    }[cfg.task]


def _refuse_unported(cfg: Config) -> None:
    if cfg.input_pipeline != "host":
        raise NotImplementedError(
            f"input_pipeline {cfg.input_pipeline!r}: the port runs the host "
            f"pipeline only; the device-resident and native pipelines are "
            f"ROADMAP.md §1 item 11f")
    if math.prod(cfg.mesh_shape) > 1:
        raise NotImplementedError(
            f"mesh_shape {tuple(cfg.mesh_shape)}: the port trains on one "
            f"device; meshes are ROADMAP.md §1 item 12")
    if cfg.distributed:
        raise NotImplementedError(
            f"distributed {cfg.distributed!r}: multi-process runs are "
            f"ROADMAP.md §1 item 12")


class Trainer:
    """Train ``cfg``'s model on ``device`` (``cuda`` unless the caller asks
    for ``cpu``; ``cuda`` without a card raises).  The run directory
    ``out_dir`` (default ``<checkpoints_dir>/<name>``) gets ``config.json``,
    the metric files and ``ckpt/``; with ``resume`` the newest checkpoint
    there is restored."""

    def __init__(self, cfg: Config, *, log_every: int = 200,
                 out_dir: Optional[str] = None, quiet: bool = False,
                 resume: bool = True, device: str | torch.device = "cuda"):
        _refuse_unported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.out_dir = out_dir or os.path.join(cfg.checkpoints_dir, cfg.name)
        os.makedirs(self.out_dir, exist_ok=True)
        cfg.save(os.path.join(self.out_dir, "config.json"))  # opt.txt
        self.logger = MetricLogger(self.out_dir, quiet=quiet)
        self.log_every = log_every

        self.train_set = build_dataset(cfg, "train", self.device)
        eval_mode = "val" if cfg.dataset == "shrec" else "test"
        self.test_set = build_dataset(cfg, eval_mode, self.device)
        self.train_loader = BatchLoader(self.train_set, cfg.batch_size,
                                        shuffle=True, seed=cfg.seed)
        self.test_loader = BatchLoader(self.test_set, cfg.batch_size,
                                       shuffle=False, drop_last=False,
                                       pad_last=True)
        self.steps_per_epoch = max(len(self.train_loader), 1)
        # the JAX package's Trainer draws one batch here as its example
        # input; skipping that pass keeps the loader's epochs and shuffles
        # in step with it, so both packages train on the same batches
        self.train_loader.skip_epoch()

        self.state = init_state(cfg, device=self.device, seed=cfg.seed,
                                steps_per_epoch=self.steps_per_epoch)
        self.model = self.state.model
        if cfg.pretrain:
            checkpoints.restore_encoder(cfg.pretrain, self.state)
        latest = checkpoints.latest_checkpoint(
            os.path.join(self.out_dir, "ckpt"))
        if resume and latest:
            checkpoints.restore_checkpoint(latest, self.state)
            print(f"resumed from {latest} at step {self.state.step}")
        self.train_step, self.eval_step = make_steps(cfg,
                                                     self.steps_per_epoch)
        # the random draws of the steps (point dropout, dropout masks):
        # the counterpart of the JAX package's PRNGKey(seed + 1)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)
        self.best_metric = None
        self._stop_requested = False

    # ------------------------------------------------------------------
    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        """Host arrays -> tensors on the device.  On a card the host side is
        pinned and the copy asynchronous, on the calling thread's stream."""
        out = {}
        for k, v in batch.items():
            if k == "valid":
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _device_batches(self, loader):
        """Yield ``(device batch, valid)`` for ``loader``.  The loader's
        threads read and augment ahead of the step (the reference relies
        on DataLoader workers for this, modelnet/train.py:25); the copy
        from pinned memory is asynchronous to the host and ordered before
        the step on the current stream, so copying a batch ahead would
        only hold back the launch of the step before it.  A loader error
        reaches the consumer; a consumer that stops early closes the
        loader's iterator, which stops its threads."""
        for batch in loader:
            valid = int(batch.pop("valid", self.cfg.batch_size))
            yield self._device_batch(batch), valid

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One pass over the training loader; the last step's metrics and
        ``sec_per_step``, the epoch's wall time (the loader in) over its
        steps, read after the last step's metrics reached the host."""
        t0 = time.perf_counter()
        metrics = None
        steps = 0
        for i, (db, _valid) in enumerate(self._device_batches(self.train_loader)):
            self.state, metrics = self.train_step(self.state, db,
                                                  self.generator)
            steps += 1
            if i % self.log_every == 0:
                self.logger.log(self.state.step,
                                {k: float(v) for k, v in metrics.items()},
                                epoch=epoch, prefix="train_")
            if self._stop_requested:  # per-step granularity
                break
        if metrics is None:  # dataset smaller than one batch
            return {"sec_per_step": 0.0}
        last = {k: float(v) for k, v in metrics.items()}
        last["sec_per_step"] = (time.perf_counter() - t0) / steps
        return last

    def evaluate(self, visualize: bool = False) -> Dict[str, float]:
        """Eval over the test split (``val`` for SHREC), each per-item
        metric averaged over the valid items (modelnet/train.py:78-90)."""
        sums: Dict[str, float] = {}
        count = 0
        first = True
        for db, valid in self._device_batches(self.test_loader):
            m = self.eval_step(self.state, db)
            if visualize and first:
                self._save_visuals(db, m)
                first = False
            count += valid
            for k, v in m.items():
                if k.endswith("_i"):
                    name = _EVAL_NAMES.get(k, k[:-2])
                    if self.cfg.task == "segment" and k == "correct_i":
                        name = "seg_accuracy"
                    total = float(v[:valid].float().sum())
                    sums[name] = sums.get(name, 0.0) + total
        return {k: v / max(count, 1) for k, v in sums.items()}

    def _save_visuals(self, batch, metrics) -> None:
        """Eval-time pictures (the reference's per-epoch visdom displays:
        AE reconstructions autoencoder/train.py:75-76, seg colourings
        segmenter.py:135-155); needs matplotlib."""
        from ..utils.visualize import (HTMLGallery, save_point_cloud_png,
                                       save_seg_comparison)

        def host(t):
            return t.float().cpu().numpy()

        out = os.path.join(self.out_dir, "visuals")
        gallery = HTMLGallery(out)
        step = self.state.step
        paths = []
        if self.cfg.task == "autoencode" and "predicted_pc" in metrics:
            paths.append(save_point_cloud_png(
                os.path.join(out, f"step{step}_input.png"),
                host(batch["pc"][0]), title="input"))
            paths.append(save_point_cloud_png(
                os.path.join(out, f"step{step}_recon.png"),
                host(metrics["predicted_pc"][0]), title="recon"))
        elif self.cfg.task == "segment" and "score" in metrics:
            pred = metrics["score"][0].argmax(-1).cpu().numpy()
            paths += save_seg_comparison(
                out, f"step{step}", host(batch["pc"][0]), pred,
                batch["seg"][0].cpu().numpy(), dataroot=self.cfg.dataroot)
        if paths:
            gallery.add_row(f"step {step}", paths)
            gallery.save()

    def _save(self) -> str:
        return checkpoints.save_checkpoint(
            os.path.join(self.out_dir, "ckpt"), self.state, self.state.step)

    def maybe_checkpoint(self, epoch: int, test_metrics: Dict[str, float],
                         threshold: Optional[float] = None) -> Optional[str]:
        """Save when the task metric improved on the best so far and passes
        ``threshold`` (when one is given); returns the path or None."""
        key, hib = _metric_key(self.cfg)
        val = test_metrics.get(key)
        if val is None:
            return None
        improved = (self.best_metric is None
                    or (val > self.best_metric if hib
                        else val < self.best_metric))
        if improved:
            self.best_metric = val
        gate = True if threshold is None else (
            val > threshold if hib else val < threshold)
        return self._save() if improved and gate else None

    def request_stop(self) -> None:
        """Ask ``fit`` to stop after the current step: it evaluates and
        checkpoints the full train state first, so a new Trainer on the
        same run resumes exactly there (the reference loses everything on
        SIGTERM: its saves are metric-gated only, modelnet/train.py:96-103)."""
        self._stop_requested = True

    def _install_signal_handlers(self):
        """SIGTERM/SIGINT -> graceful stop; a second SIGINT raises
        KeyboardInterrupt as usual.  No-op off the main thread."""
        import signal

        def handler(signum, frame):
            if self._stop_requested and signum == signal.SIGINT:
                raise KeyboardInterrupt
            self._stop_requested = True
            print("stop requested: checkpointing at the next epoch "
                  "boundary (again to force-quit)", flush=True)

        prev = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev[sig] = signal.signal(sig, handler)
        except ValueError:  # not the main thread
            return {}
        return prev

    def fit(self, epochs: Optional[int] = None,
            save_threshold: Optional[float] = None,
            visualize_every: int = 0) -> Dict[str, float]:
        """Train ``epochs`` epochs (default ``cfg.epochs``), each followed by
        an eval, a gated checkpoint and, with ``checkpoint_every``, an
        ungated one; returns the last eval's metrics.  Each epoch's
        training summary (the last step's metrics and ``sec_per_step``)
        is logged with the prefix ``train_``.  Pictures every
        ``visualize_every`` epochs need matplotlib: without it ``fit``
        raises before it trains."""
        import signal

        from ..utils import visualize
        if visualize_every > 0 and not visualize.available():
            raise ImportError(
                f"visualize_every={visualize_every} draws with matplotlib, "
                f"which is not installed; pass 0 to train without pictures")
        epochs = epochs if epochs is not None else self.cfg.epochs
        test_metrics: Dict[str, float] = {}
        ckpt_bucket = 0  # last step // checkpoint_every already saved
        prev_handlers = self._install_signal_handlers()
        try:
            for epoch in range(epochs):
                tr = self.train_epoch(epoch)
                self.logger.log(self.state.step, tr, epoch=epoch,
                                prefix="train_")
                viz = visualize_every > 0 and epoch % visualize_every == 0
                test_metrics = self.evaluate(visualize=viz)
                self.logger.log(self.state.step, test_metrics,
                                epoch=epoch, prefix="test_")
                saved = self.maybe_checkpoint(epoch, test_metrics,
                                              threshold=save_threshold)
                # --checkpoint_every N: ungated saves every N steps,
                # checked at epoch boundaries, besides the gated ones
                if self.cfg.checkpoint_every > 0:
                    bucket = self.state.step // self.cfg.checkpoint_every
                    if bucket > ckpt_bucket:
                        ckpt_bucket = bucket
                        if saved is None:  # the gated save wrote this step
                            saved = self._save()
                if self._stop_requested:
                    if saved is None:  # ungated: resume must not regress
                        self._save()
                    self.logger.log(self.state.step, {"stopped_early": 1.0},
                                    epoch=epoch, prefix="train_")
                    break
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
            # a consumed stop must not cut short a later fit() on the
            # same Trainer
            self._stop_requested = False
        return test_metrics
