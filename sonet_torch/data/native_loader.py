"""Native (C++) host input pipeline for the prepared dataset layouts (port of
the JAX package's ``data/native_loader.py``).

``NativeModelNetDataset``, ``NativeShrecDataset`` and
``NativeShapeNetPartDataset`` are the Python loaders with whole-batch
assembly in C++ worker threads (``sonet_torch/native/loader.cpp``): file
parse, distinct subsample and the train augmentation stack run in one
library call with the interpreter lock released, the counterpart of the
reference's ``DataLoader(num_workers=8)`` worker processes
(modelnet/train.py:25, part-seg/train.py:23, shrec16/train.py).  The
``BatchLoader`` calls ``make_batch`` instead of ``__getitem__`` per item
when a dataset has it; ``__getitem__`` stays the Python one.

Determinism: each item's seed derives from the same (seed, mode, epoch,
index) tuple as the numpy path (``data/seeding.py``) through
``SeedSequence``; the C++ random stream differs from numpy's, so batches
match the Python pipeline in distribution, and the JAX package's native
batches byte for byte.

Asking for the native pipeline builds the library when a dataset is made;
a failed build raises.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..config import Config
from .modelnet import ModelNetDataset, ShrecDataset
from .shapenet import ShapeNetPartDataset


class _NativeMixin:
    """The library handle and the per-item seeds."""

    def _init_native(self, num_threads: int | None) -> None:
        from .. import native
        native.build()  # fail when the dataset is made, not at a batch
        self._native = native
        self.num_threads = num_threads or min(os.cpu_count() or 1, 8)

    def item_seed(self, idx: int) -> np.uint64:
        ss = np.random.SeedSequence(
            (self._seed, self._mode_id, self._epoch, int(idx)))
        return ss.generate_state(1, np.uint64)[0]

    def _seeds(self, indices) -> np.ndarray:
        return np.asarray([self.item_seed(int(i)) for i in indices],
                          np.uint64)


class NativeModelNetDataset(_NativeMixin, ModelNetDataset):
    """ModelNet npy dataset with C++ batch assembly (``make_batch``)."""

    def __init__(self, root: str, mode: str, cfg: Config, *,
                 num_threads: int | None = None):
        super().__init__(root, mode, cfg)
        self._init_native(num_threads)

    def make_batch(self, indices, valid: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        pc_paths, som_paths, labels = [], [], []
        for i in indices:
            pc_path, label, som_path = self.items[int(i)]
            pc_paths.append(pc_path)
            som_paths.append(som_path)
            labels.append(label)
        pc, sn, node = self._native.load_batch_native(
            pc_paths, som_paths, self._seeds(indices),
            cfg.input_pc_num, cfg.node_num,
            augment=(self.mode == "train"),
            rot_horizontal=cfg.rot_horizontal,
            rot_perturbation=cfg.rot_perturbation,
            translation_perturbation=cfg.translation_perturbation,
            num_threads=self.num_threads)
        return {"pc": pc, "sn": sn, "node": node,
                "label": np.asarray(labels, np.int64),
                "valid": np.asarray(valid, np.int32)}


class NativeShrecDataset(_NativeMixin, ShrecDataset):
    """SHREC2016 npz dataset with C++ batch assembly: ``ShrecDataset``'s
    layout and augmentation (modelnet_shrec_loader.py:67-113, 219-245)."""

    def __init__(self, root: str, mode: str, cfg: Config, *,
                 num_threads: int | None = None):
        super().__init__(root, mode, cfg)
        self._init_native(num_threads)

    def make_batch(self, indices, valid: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        paths, labels, ids = [], [], []
        for i in indices:
            npz_path, label, name = self.items[int(i)]
            paths.append(npz_path)
            labels.append(label)
            try:
                ids.append(int(name))
            except ValueError:
                ids.append(int(i))
        pc, sn, node = self._native.load_npz_batch_native(
            paths, self._seeds(indices), cfg.input_pc_num, cfg.node_num,
            augment_mode=(1 if self.mode == "train" else 0),
            rot_horizontal=cfg.rot_horizontal,
            rot_perturbation=cfg.rot_perturbation,
            translation_perturbation=cfg.translation_perturbation,
            num_threads=self.num_threads)
        return {"pc": pc, "sn": sn, "node": node,
                "label": np.asarray(labels, np.int64),
                "id": np.asarray(ids, np.int64),
                "valid": np.asarray(valid, np.int32)}


class NativeShapeNetPartDataset(_NativeMixin, ShapeNetPartDataset):
    """ShapeNetPart npz dataset with C++ batch assembly:
    ``ShapeNetPartDataset``'s layout and augmentation
    (shapenet_loader.py:131-175: distinct subsample or resample up with
    replacement, jitter and scale in training); part labels ride along."""

    def __init__(self, root: str, mode: str, cfg: Config, *,
                 num_threads: int | None = None):
        super().__init__(root, mode, cfg)
        self._init_native(num_threads)

    def make_batch(self, indices, valid: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        paths, labels = [], []
        for i in indices:
            path, label = self.item_path_label(int(i))
            paths.append(path)
            labels.append(label)
        pc, sn, node, seg = self._native.load_npz_batch_native(
            paths, self._seeds(indices), cfg.input_pc_num, cfg.node_num,
            augment_mode=(2 if self.mode == "train" else 0),
            with_seg=True, num_threads=self.num_threads)
        return {"pc": pc, "sn": sn, "node": node,
                "label": np.asarray(labels, np.int64),
                "seg": seg.astype(np.int64),
                "valid": np.asarray(valid, np.int32)}
