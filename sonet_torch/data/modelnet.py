"""ModelNet40/10 and SHREC2016 dataset loaders (port of the JAX package's
``data/modelnet.py``; numpy only, the same items for the same seed).

File layouts are those of the reference's prepared datasets
(README.md:44-49):

* ModelNet (modelnet_shrec_loader.py:28-64, 193-202):
  ``<root>/modelnet{10,40}_shape_names.txt``, ``modelnet{10,40}_{train,test}.txt``,
  per-shape ``<root>/<class>/<name>.npy`` (Nx6 xyz+normal), SOM nodes at
  ``<root>/<rows>x<cols>_som_nodes/<class>/<name>.npy``.
* SHREC16 (modelnet_shrec_loader.py:67-113): ``category.txt``,
  ``{train,val,test}.txt``, per-shape
  ``<root>/<rows>x<cols>/<mode>/model_<name>.npz`` with {pc, sn, som_node}.

Differences from the reference: the per-item Faiss kNN of SOM nodes
(modelnet_shrec_loader.py:257-261) is gone (the encoder computes node kNN
on the device).  Items are channel-last ``(N, 3)``.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Tuple

import numpy as np

from ..config import Config
from . import augmentation as aug
from .seeding import EpochSeeded


def _read_lines(path: str) -> List[str]:
    with open(path) as f:
        return [ln.rstrip() for ln in f.readlines() if ln.strip()]


def make_dataset_modelnet(root: str, mode: str, cfg: Config):
    """(pc_path, label, som_path) triplets (modelnet_shrec_loader.py:28-64)."""
    rows = cfg.rows
    shapes = _read_lines(os.path.join(
        root, f"modelnet{cfg.classes}_shape_names.txt"))
    if mode not in ("train", "test"):
        raise ValueError(f"mode {mode!r}")
    names = _read_lines(os.path.join(
        root, f"modelnet{cfg.classes}_{mode}.txt"))
    items = []
    for name in names:
        folder = name[0:-5]  # strip _0001 suffix
        label = shapes.index(folder)
        items.append((os.path.join(root, folder, name + ".npy"), label,
                      os.path.join(root, f"{rows}x{rows}_som_nodes", folder,
                                   name + ".npy")))
    return items


def make_dataset_shrec2016(root: str, mode: str, cfg: Config):
    """(npz_path, label) pairs (modelnet_shrec_loader.py:67-113)."""
    rows = cfg.rows
    categories = _read_lines(os.path.join(root, "category.txt"))
    lines = _read_lines(os.path.join(root, f"{mode}.txt"))
    items = []
    if mode in ("train", "val"):
        for line in lines:
            parts = [x.strip() for x in line.split(",")]
            name, category = parts[0], parts[1]
            try:
                label = categories.index(category)
            except ValueError:
                continue
            items.append((os.path.join(root, f"{rows}x{rows}", mode,
                                       f"model_{name}.npz"), label, name))
    elif mode == "test":
        for line in lines:
            # test labels unknown; reference fakes int(name) % 55
            items.append((os.path.join(root, f"{rows}x{rows}", mode,
                                       f"model_{line}.npz"),
                          int(line) % len(categories), line))
    else:
        raise ValueError(f"mode {mode!r}")
    return items


class ModelNetDataset(EpochSeeded):
    """ModelNet40/10 10k-point .npy layout."""

    def __init__(self, root: str, mode: str, cfg: Config):
        self.cfg = cfg
        self.mode = mode
        self.items = make_dataset_modelnet(root, mode, cfg)
        self._init_seeding(cfg.seed, mode)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self.item_rng(idx)
        pc_path, label, som_path = self.items[idx]
        data = np.load(pc_path)
        choice = rng.choice(data.shape[0], cfg.input_pc_num,
                            replace=False)
        data = data[choice]
        pc, sn = data[:, 0:3], data[:, 3:6]
        node = np.load(som_path)
        if self.mode == "train":
            pc, sn, node = aug.train_augment(
                pc, sn, node, rng,
                rot_horizontal=cfg.rot_horizontal,
                rot_perturbation=cfg.rot_perturbation,
                translation_perturbation=cfg.translation_perturbation)
        return {"pc": pc.astype(np.float32), "sn": sn.astype(np.float32),
                "node": node.astype(np.float32),
                "label": np.int64(label)}

    def raw_item(self, idx: int) -> Dict[str, np.ndarray]:
        """The item at full resolution, without subsample or augmentation,
        for the device-resident pipeline (``data/device_pipeline.py``)."""
        pc_path, label, som_path = self.items[idx]
        data = np.load(pc_path)
        return {"pc": np.ascontiguousarray(data[:, 0:3], np.float32),
                "sn": np.ascontiguousarray(data[:, 3:6], np.float32),
                "node": np.load(som_path).astype(np.float32),
                "label": np.int64(label)}


class ShrecDataset(EpochSeeded):
    """SHREC2016 npz layout; returns the shape id for retrieval
    (modelnet_shrec_loader.py:268-269)."""

    def __init__(self, root: str, mode: str, cfg: Config):
        self.cfg = cfg
        self.mode = mode
        self.items = make_dataset_shrec2016(root, mode, cfg)
        self._init_seeding(cfg.seed, mode)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self.item_rng(idx)
        npz_path, label, name = self.items[idx]
        data = np.load(npz_path)
        pc, sn, node = data["pc"], data["sn"], data["som_node"]
        choice = rng.choice(pc.shape[0], cfg.input_pc_num,
                            replace=False)
        pc, sn = pc[choice], sn[choice]
        if self.mode == "train":
            pc, sn, node = aug.train_augment(
                pc, sn, node, rng,
                rot_horizontal=cfg.rot_horizontal,
                rot_perturbation=cfg.rot_perturbation,
                translation_perturbation=cfg.translation_perturbation)
        item = {"pc": pc.astype(np.float32), "sn": sn.astype(np.float32),
                "node": node.astype(np.float32), "label": np.int64(label)}
        try:
            item["id"] = np.int64(int(name))
        except ValueError:
            item["id"] = np.int64(idx)
        return item

    def raw_item(self, idx: int) -> Dict[str, np.ndarray]:
        """The item at full resolution, without subsample or augmentation,
        for the device-resident pipeline (the subsample to input_pc_num
        happens on the device).  The retrieval ``id`` is not carried:
        retrieval reads the host loader."""
        npz_path, label, _name = self.items[idx]
        data = np.load(npz_path)
        return {"pc": data["pc"].astype(np.float32),
                "sn": data["sn"].astype(np.float32),
                "node": data["som_node"].astype(np.float32),
                "label": np.int64(label)}
