"""The epoch-loop trainer shared by every task (port of the JAX package's
``train/trainer.py``), on one device or over a mesh of processes.

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
* three input pipelines (``cfg.input_pipeline``): ``host`` reads and
  augments batches on the loader's threads, ahead of the step that reads
  them, and copies them to the device asynchronously; ``native`` does the
  same in C++ threads (``data/native_loader.py``, the ModelNet, SHREC and
  ShapeNetPart layouts); ``device`` keeps the raw split on the device
  (``data/device_pipeline.py``; chunked above ``device_budget_gb``) and
  samples and augments inside the step.  Device epochs stop at the epoch
  boundary, host epochs after the step.

On a card every train and eval step is a captured CUDA graph
(``train/graphs.py``), as every step of the JAX package is a jitted
program: the host and native pipelines' steps are ``StepGraph``s, each
batch copied from pinned memory into the graph's static buffers on the
compute stream and one replay a batch; the device pipeline's are
``EpochGraph``s, replayed once per row of the epoch's index table, their
metrics fetched once an epoch.  On the CPU the same steps run eagerly.

Over several processes (``cfg.distributed``, ``parallel/``) the Trainer
runs one program on every rank over a (data, points) mesh
(``cfg.mesh_shape``; with none given, data parallel over every process;
a mesh that does not cover the process group is refused, and so is a
mesh in one process without ``--distributed``).  Every rank loads the
global batch and keeps its block; the state is replicated; rank 0 alone
writes the run directory and the console; a stop asked for on any rank
stops every rank at the same step.  Steps over a gloo mesh run eagerly
(``train/graphs.py``).
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..data.pipeline import BatchLoader
from ..parallel import collectives, distributed, mesh as pmesh
from ..utils.logging import MetricLogger
from . import checkpoints
from .graphs import EpochGraph, StepGraph
from .loops import make_steps
from .state import init_state, set_capturable, snapshot

_EVAL_NAMES = {"loss_i": "loss", "correct_i": "accuracy", "iou_i": "iou"}


def build_dataset(cfg: Config, mode: str, device: str | torch.device = "cuda"):
    """The dataset of ``cfg.dataset`` for ``mode``; ``device`` is where the
    synthetic and the MNIST datasets fit their SOM nodes (the others read
    theirs from disk).  With ``input_pipeline="native"`` the ModelNet,
    SHREC and ShapeNetPart layouts get their C++ loaders (whose build
    raises when it fails); other datasets warn and use the Python one."""
    native = cfg.input_pipeline == "native"
    if native and cfg.dataset not in ("modelnet", "shrec", "shapenet"):
        warnings.warn(
            f"--input_pipeline native supports the modelnet/shrec/"
            f"shapenet prepared layouts; dataset {cfg.dataset!r} falls "
            f"back to the python host pipeline")
    if cfg.dataset == "synthetic":
        from ..data.synthetic import SyntheticDataset
        mult = 16 if mode == "train" else 4
        return SyntheticDataset(cfg,
                                size=max(cfg.batch_size * mult,
                                         cfg.classes * (4 if mode != "train"
                                                        else 8)),
                                mode=mode, seed=cfg.seed, device=device)
    if cfg.dataset == "modelnet":
        if native:
            from ..data.native_loader import NativeModelNetDataset
            return NativeModelNetDataset(cfg.dataroot, mode, cfg)
        from ..data.modelnet import ModelNetDataset
        return ModelNetDataset(cfg.dataroot, mode, cfg)
    if cfg.dataset == "shrec":
        if native:
            from ..data.native_loader import NativeShrecDataset
            return NativeShrecDataset(cfg.dataroot, mode, cfg)
        from ..data.modelnet import ShrecDataset
        return ShrecDataset(cfg.dataroot, mode, cfg)
    if cfg.dataset == "shapenet":
        if native:
            from ..data.native_loader import NativeShapeNetPartDataset
            return NativeShapeNetPartDataset(cfg.dataroot, mode, cfg)
        from ..data.shapenet import ShapeNetPartDataset
        return ShapeNetPartDataset(cfg.dataroot, mode, cfg)
    if cfg.dataset == "mnist":
        from ..data.mnist import MNISTPointCloudDataset
        return MNISTPointCloudDataset(cfg.dataroot, mode, cfg, device=device)
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


def _metric_key(cfg: Config) -> tuple[str, bool]:
    """(metric name, higher_is_better) for checkpoint gating."""
    return {
        "classify": ("accuracy", True),
        "retrieve": ("accuracy", True),
        "segment": ("iou", True),
        "autoencode": ("loss", False),
    }[cfg.task]


def _check_pipeline(cfg: Config) -> None:
    if cfg.input_pipeline not in ("host", "native", "device"):
        raise ValueError(f"input_pipeline {cfg.input_pipeline!r}: want "
                         f"'host', 'native' or 'device'")


class Trainer:
    """Train ``cfg``'s model on ``device`` (``cuda`` unless the caller asks
    for ``cpu``; ``cuda`` without a card raises).  The run directory
    ``out_dir`` (default ``<checkpoints_dir>/<name>``) gets ``config.json``,
    the metric files and ``ckpt/``; with ``resume`` the newest checkpoint
    there is restored."""

    def __init__(self, cfg: Config, *, log_every: int = 200,
                 out_dir: Optional[str] = None, quiet: bool = False,
                 resume: bool = True, device: str | torch.device = "cuda"):
        _check_pipeline(cfg)
        # several processes: the group comes up before any device work
        cfg, self.mesh, self.device = pmesh.setup_mesh(cfg, device)
        self.multiprocess = self.mesh is not None
        self.is_main = distributed.is_main()
        self.cfg = cfg
        self.out_dir = out_dir or os.path.join(cfg.checkpoints_dir, cfg.name)
        if self.is_main:
            os.makedirs(self.out_dir, exist_ok=True)
            cfg.save(os.path.join(self.out_dir, "config.json"))  # opt.txt
        self.logger = MetricLogger(self.out_dir if self.is_main else None,
                                   quiet=quiet or not self.is_main)
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
                                steps_per_epoch=self.steps_per_epoch,
                                mesh=self.mesh)
        self.model = self.state.model
        if cfg.pretrain:
            checkpoints.restore_encoder(cfg.pretrain, self.state)
        latest = checkpoints.latest_checkpoint(
            os.path.join(self.out_dir, "ckpt"))
        if resume and latest:
            checkpoints.restore_checkpoint(latest, self.state)
            if self.is_main:
                print(f"resumed from {latest} at step {self.state.step}")
        self.train_step, self.eval_step = make_steps(
            cfg, self.steps_per_epoch, mesh=self.mesh)
        # the random draws of the steps (point dropout, dropout masks, the
        # device pipeline's sampling): the counterpart of the JAX
        # package's PRNGKey(seed + 1)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)
        self.device_train = self.device_eval = None
        self._keys: Dict[int, tuple] = {}
        if cfg.input_pipeline == "device":
            self._init_device_pipeline()
        else:
            self.train_graph = StepGraph(
                self._host_train_step, self.device,
                generators=(self.generator,), key=self._step_key,
                snapshot=self._snapshot, on_replay=self._advance,
                mesh=self.mesh)
            self.eval_graph = StepGraph(self._host_eval_step, self.device,
                                        mesh=self.mesh)
        # a captured step needs Adam's step counters on the card
        set_capturable(self.state.optimizer, self.device.type == "cuda")
        self.best_metric = None
        self._stop_requested = False

    # -- the device-resident pipeline ----------------------------------
    def _init_device_pipeline(self) -> None:
        """Stack both splits' raw items and put them on the device, or
        stream a split above ``device_budget_gb`` in chunks; set up the
        train and eval steps over them (captured on a card)."""
        from ..data.device_pipeline import (ChunkedDeviceData,
                                            ShardedDeviceSplit,
                                            device_data_from_host,
                                            split_nbytes, stack_host_split)
        cfg = self.cfg
        if cfg.dataset_placement not in ("replicated", "sharded"):
            raise ValueError(
                f"--dataset_placement {cfg.dataset_placement!r}: want "
                f"'replicated' or 'sharded'")
        if (cfg.dataset_placement == "sharded" and self.mesh is None
                and self.is_main):
            print("device pipeline: --dataset_placement sharded needs a "
                  "mesh (--mesh_shape); using replicated placement on the "
                  "single device", flush=True)
        budget = int(cfg.device_budget_gb * 1e9)

        def build(dataset, what):
            if (what == "train" and self.mesh is not None
                    and cfg.dataset_placement == "sharded"):
                sd = ShardedDeviceSplit(dataset, self.mesh, seed=cfg.seed,
                                        device=self.device)
                if self.is_main:
                    print(f"device pipeline [{what}]: sharded over {sd.dp} "
                          f"data shards of <= {sd.per} items "
                          f"({sd.nbytes_per_shard() / 1e9:.3f} GB a "
                          f"rank)", flush=True)
                return sd
            host = stack_host_split(dataset)
            nbytes = split_nbytes(host)
            if budget > 0 and nbytes > budget:
                cd = ChunkedDeviceData(host, budget, cfg.batch_size,
                                       self.device, seed=cfg.seed)
                if self.is_main:
                    print(f"device pipeline [{what}]: split "
                          f"{nbytes / 1e9:.2f} "
                          f"GB exceeds --device_budget_gb "
                          f"{cfg.device_budget_gb:g}: streaming "
                          f"{cd.num_chunks} chunks of {cd.chunk_items} items "
                          f"(double-buffered)", flush=True)
                return cd
            return device_data_from_host(host, self.device)

        self.device_train = build(self.train_set, "train")
        self.device_eval = build(self.test_set, "eval")
        # eval draws (the subsample) restart from one seed every evaluate,
        # so the same split evaluates to the same bits
        self.eval_generator = torch.Generator(device=self.device)
        self.train_graph = EpochGraph(
            self._device_train_step, self.device,
            generators=(self.generator,), key=self._step_key,
            snapshot=self._snapshot, on_replay=self._advance, mesh=self.mesh)
        self.eval_graph = EpochGraph(
            self._device_eval_step, self.device,
            generators=(self.eval_generator,), mesh=self.mesh)

    def _rank_rows(self, data, idx):
        """This rank's rows of a table row: its block of a global row, or
        the whole row of a sharded split's local table."""
        if getattr(data, "shard", False):
            return idx
        return pmesh.block(idx, ("data",), self.mesh)

    def _device_train_step(self, data, idx):
        from ..data.device_pipeline import sample_batch
        # under a mesh: the global batch's draws, this rank's block of it
        batch = sample_batch(data, self._rank_rows(data, idx),
                             self.generator, self.cfg, train=True,
                             mesh=self.mesh)
        _, metrics = self.train_step(self.state, batch, self.generator)
        return metrics

    def _device_eval_step(self, data, idx):
        from ..data.device_pipeline import sample_batch
        batch = sample_batch(data, self._rank_rows(data, idx),
                             self.eval_generator, self.cfg, train=False,
                             mesh=self.mesh)
        m = self.eval_step(self.state, batch)
        # per-item columns and scalars only: what evaluate() reads
        return {k: v for k, v in m.items()
                if k.endswith("_i") or v.dim() == 0}

    def _host_train_step(self, **batch):
        _, metrics = self.train_step(self.state, batch, self.generator)
        return metrics

    def _host_eval_step(self, **batch):
        return self.eval_step(self.state, batch)

    def _step_key(self) -> tuple:
        """What a captured train step reads from Python: each group's
        learning rate and every BatchNorm's momentum, both constant within
        an epoch."""
        epoch = self.state.step // self.steps_per_epoch
        key = self._keys.get(epoch)
        if key is None:
            st = self.state
            lrs = tuple(st.schedules[g["name"]](st.step)
                        for g in st.optimizer.param_groups)
            momenta = tuple(m.momentum_at(epoch) for m in self.model.modules()
                            if hasattr(m, "momentum_at"))
            key = self._keys[epoch] = (lrs, momenta)
        return key

    def _advance(self) -> None:
        self.state.step += 1

    def _snapshot(self):
        """A function that puts back what a train step changes
        (``train.state.snapshot``)."""
        return snapshot(self.state)

    def _device_epoch_index(self, data, shuffle: bool, epoch: int):
        """((S, B) int64 index table, each row's valid count) for one
        epoch over a resident split: the JAX package's tables for the same
        seed and epoch (a shuffle by ``default_rng(seed + 1000 + epoch)``
        cut to whole batches; in order, the last row padded by repeating
        its last item, without)."""
        T, B = data.size, self.cfg.batch_size
        order = np.arange(T)
        if shuffle:
            order = np.random.default_rng(
                self.cfg.seed + 1000 + epoch).permutation(T)
            order = order[: (T // B) * B]  # drop last, like the train loader
        valids, rows = [], []
        for i in range(0, len(order), B):
            chunk = order[i:i + B]
            valids.append(len(chunk))
            if len(chunk) < B:  # pad by repeating the last item
                chunk = np.concatenate([chunk,
                                        np.full(B - len(chunk), chunk[-1])])
            rows.append(chunk)
        if not rows:
            return None, []
        return np.stack(rows).astype(np.int64), valids

    def _device_splits(self, data, shuffle: bool, epoch: int,
                       drop_last: bool):
        """``(DeviceData, table, valids)`` for each part of an epoch: one
        for a resident split, one a chunk for a chunked one."""
        from ..data.device_pipeline import (ChunkedDeviceData,
                                            ShardedDeviceSplit)
        if isinstance(data, ChunkedDeviceData):
            yield from data.epoch_chunks(shuffle, epoch, self.cfg.batch_size,
                                         drop_last)
            return
        if isinstance(data, ShardedDeviceSplit):
            table, valids = data.epoch_index(shuffle, epoch,
                                             self.cfg.batch_size)
            if table is not None:
                yield data.data, table, valids
            return
        table, valids = self._device_epoch_index(data, shuffle, epoch)
        if table is not None:
            yield data, table, valids

    # ------------------------------------------------------------------
    def _pinned_batch(self, batch) -> Dict[str, torch.Tensor]:
        """Host arrays -> tensors for a step: pinned on a card, whose
        captured step copies them into its static buffers asynchronously,
        on the compute stream, so the next batch's copy cannot overwrite a
        buffer that a running replay still reads."""
        out = {}
        for k, v in pmesh.shard_batch(batch, self.mesh).items():
            if k == "valid":
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory()
            out[k] = t
        return out

    def _device_batches(self, loader):
        """Yield ``(batch, valid)`` for ``loader``.  The loader's threads
        read and augment ahead of the step (the reference relies on
        DataLoader workers for this, modelnet/train.py:25); the copy from
        pinned memory is asynchronous to the host and ordered before the
        step's replay on the current stream, so copying a batch ahead
        would only hold back the replay before it.  Every batch has the
        same shape (the last eval batch is padded), so one graph covers
        an epoch.  A loader error reaches the consumer; a consumer that
        stops early closes the loader's iterator, which stops its
        threads."""
        for batch in loader:
            valid = int(batch.pop("valid", self.cfg.batch_size))
            yield self._pinned_batch(batch), valid

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One pass over the training split; the last step's metrics and
        ``sec_per_step``, the epoch's wall time (the loader in) over its
        steps, read after the last step's metrics reached the host."""
        if self.device_train is not None:
            return self._train_epoch_device(epoch)
        t0 = time.perf_counter()
        metrics = None
        steps = 0
        for i, (db, _valid) in enumerate(self._device_batches(self.train_loader)):
            metrics = self.train_graph(**db)
            steps += 1
            if i % self.log_every == 0:
                self.logger.log(self.state.step,
                                {k: float(v) for k, v in metrics.items()},
                                epoch=epoch, prefix="train_")
            if self._should_stop():  # per-step granularity
                break
        if metrics is None:  # dataset smaller than one batch
            return {"sec_per_step": 0.0}
        last = {k: float(v) for k, v in metrics.items()}
        last["sec_per_step"] = (time.perf_counter() - t0) / steps
        return last

    def _train_epoch_device(self, epoch: int) -> Dict[str, float]:
        """The device pipeline's epoch: the train step replayed once per row
        of the epoch's table (each chunk's, for a chunked split), the
        stacked metrics fetched once a part, logged every ``log_every``
        steps."""
        t0 = time.perf_counter()
        parts = [self.train_graph.run(dd, table) for dd, table, _ in
                 self._device_splits(self.device_train, True, epoch, True)]
        if not parts:  # dataset smaller than one batch
            return {"sec_per_step": 0.0}
        ms = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        steps = len(next(iter(ms.values())))
        for i in range(0, steps, self.log_every):
            self.logger.log(self.state.step - steps + i + 1,
                            {k: float(v[i]) for k, v in ms.items()},
                            epoch=epoch, prefix="train_")
        last = {k: float(v[-1]) for k, v in ms.items()}
        last["sec_per_step"] = (time.perf_counter() - t0) / steps
        return last

    def _eval_batches(self):
        """``(batch or None, metrics, valid)`` per eval batch: the host
        loader's batches through the eval step (on a card the metrics are
        the graph's buffers, good until the next batch), or the device
        pipeline's rows, whose metrics arrive stacked, once a part."""
        if self.device_eval is None:
            for db, valid in self._device_batches(self.test_loader):
                yield db, self.eval_graph(**db), valid
            return
        self.eval_generator.manual_seed(self.cfg.seed)
        for dd, table, valids in self._device_splits(self.device_eval,
                                                     False, 0, False):
            ms = self.eval_graph.run(dd, table)
            for i, valid in enumerate(valids):
                yield None, {k: torch.as_tensor(v[i])
                             for k, v in ms.items()}, valid

    def evaluate(self, visualize: bool = False) -> Dict[str, float]:
        """Eval over the test split (``val`` for SHREC), each per-item
        metric averaged over the valid items (modelnet/train.py:78-90).
        Each batch's sums (float32) are added up in float64 where the
        metrics lie, before the next batch's step overwrites them, and
        fetched once.  Under a mesh each rank sums the valid items of its
        block and the sums are added over ``data`` before the fetch."""
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        first = True
        per = self.cfg.batch_size // pmesh.mesh_shape(self.mesh)[0]
        for db, m, valid in self._eval_batches():
            if visualize and first and db is not None and self.is_main:
                self._save_visuals(db, m)
                first = False
            count += valid
            mine = collectives.local_valid(valid, per, self.mesh)
            for k, v in m.items():
                if k.endswith("_i"):
                    name = _EVAL_NAMES.get(k, k[:-2])
                    if self.cfg.task == "segment" and k == "correct_i":
                        name = "seg_accuracy"
                    total = v[:mine].float().sum().double()
                    sums[name] = (sums[name] + total if name in sums
                                  else total)
        if self.mesh is not None and sums:
            names = sorted(sums)
            with collectives.use_mesh(self.mesh):
                total = collectives.all_reduce(
                    torch.stack([sums[k] for k in names]), ("data",))
            sums = dict(zip(names, total))
        return {k: float(v) / max(count, 1) for k, v in sums.items()}

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

    def _should_stop(self) -> bool:
        """The stop decision, the same on every rank: a launcher may signal
        one process only, and a rank that left the loop alone would leave
        the others waiting in the next collective.  Any rank's request
        stops all; called at the same points on every rank."""
        if not self.multiprocess:
            return self._stop_requested
        return distributed.any_process(self._stop_requested)

    def request_stop(self) -> None:
        """Ask ``fit`` to stop after the current step (the current epoch with
        the device pipeline, whose epochs are replayed whole): it evaluates and
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
                if self._should_stop():
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
