"""ShapeNetPart segmentation dataset loader (port of the JAX package's
``data/shapenet.py``; numpy only, the same items for the same seed).

Layout of the reference's prepared data (data/shapenet_loader.py:31-43,
131-139): PointNet++ split JSONs at
``<root>/train_test_split/shuffled_{train,test}_file_list.json`` whose
entries look like ``shape_data/<folder>/<name>``; per-shape npz at
``<root>/<folder>/<name>_<rows>x<cols>.npz`` with
{pc, sn, part_label, som_node}.  The 16 category folders are hardcoded
(shapenet_loader.py:117-120).

Kept from the reference: resample up with replacement when the cloud is
smaller than input_pc_num (shapenet_loader.py:142-154), jitter+scale-only
augmentation (:156-175), drop one item if len % batch_size == 1
(:113-114).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from ..config import Config
from . import augmentation as aug
from .seeding import EpochSeeded

CATEGORIES = ["Airplane", "Bag", "Cap", "Car", "Chair", "Earphone",
              "Guitar", "Knife", "Lamp", "Laptop", "Motorbike", "Mug",
              "Pistol", "Rocket", "Skateboard", "Table"]
FOLDERS = ["02691156", "02773838", "02954340", "02958343", "03001627",
           "03261776", "03467517", "03624134", "03636649", "03642806",
           "03790512", "03797390", "03948459", "04099429", "04225987",
           "04379243"]


def make_dataset_shapenet(root: str, mode: str):
    if mode not in ("train", "test"):
        raise ValueError(f"mode {mode!r}")
    path = os.path.join(root, "train_test_split",
                        f"shuffled_{mode}_file_list.json")
    with open(path) as f:
        return json.load(f)


class ShapeNetPartDataset(EpochSeeded):
    def __init__(self, root: str, mode: str, cfg: Config):
        self.cfg = cfg
        self.root = root
        self.mode = mode
        self.items = make_dataset_shapenet(root, mode)
        if len(self.items) % cfg.batch_size == 1:  # shapenet_loader.py:113
            self.items.pop()
        self._init_seeding(cfg.seed, mode)

    def __len__(self):
        return len(self.items)

    def item_path_label(self, idx: int):
        """(npz path, category label) for a split entry.

        The one place that knows the prepared-file naming: entries
        look like 'shape_data/02691156/xxxx' (strip the prefix), files
        are '<name>_<rows>x<rows>.npz', the 8-char folder id is the
        category (shapenet_loader.py:31-43, 117-120)."""
        file = self.items[idx][11:]
        rows = self.cfg.rows
        path = os.path.join(self.root, f"{file}_{rows}x{rows}.npz")
        return path, FOLDERS.index(file[0:8])

    def raw_item(self, idx: int) -> Dict[str, np.ndarray]:
        """The item without augmentation, at a fixed size, for the
        device-resident pipeline.

        A shape is resampled to ``2 * input_pc_num`` raw points (seeded by
        the item) so that the split stacks into one array; the subsample
        to ``input_pc_num`` happens on the device.  A shape that already
        has that many points is loaded as it is."""
        cfg = self.cfg
        path, label = self.item_path_label(idx)
        data = np.load(path)
        pc, sn = data["pc"], data["sn"]
        seg = data["part_label"]
        node = data["som_node"]
        R = 2 * cfg.input_pc_num
        n = pc.shape[0]
        if n != R:
            r = np.random.default_rng(cfg.seed * 100_003 + idx)
            if n > R:
                choice = r.choice(n, R, replace=False)
            else:
                choice = np.concatenate(
                    [np.arange(n), r.choice(n, R - n, replace=True)])
            pc, sn, seg = pc[choice], sn[choice], seg[choice]
        return {"pc": pc.astype(np.float32), "sn": sn.astype(np.float32),
                "node": node.astype(np.float32),
                "label": np.int64(label), "seg": seg.astype(np.int64)}

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self.item_rng(idx)
        path, label = self.item_path_label(idx)
        data = np.load(path)
        pc, sn = data["pc"], data["sn"]
        seg = data["part_label"]
        node = data["som_node"]

        n = cfg.input_pc_num
        if n < pc.shape[0]:
            choice = rng.choice(pc.shape[0], n, replace=False)
            pc, sn, seg = pc[choice], sn[choice], seg[choice]
        else:
            extra = rng.choice(pc.shape[0], n - pc.shape[0], replace=True)
            pc = np.concatenate([pc, pc[extra]], 0)
            sn = np.concatenate([sn, sn[extra]], 0)
            seg = np.concatenate([seg, seg[extra]], 0)

        if self.mode == "train":  # jitter + scale only (:156-175)
            pc = aug.jitter_point_cloud(pc, rng)
            sn = aug.jitter_point_cloud(sn, rng)
            node = aug.jitter_point_cloud(node, rng, sigma=0.04, clip=0.1)
            scale = rng.uniform(0.8, 1.2)
            pc, sn, node = pc * scale, sn * scale, node * scale

        return {"pc": pc.astype(np.float32), "sn": sn.astype(np.float32),
                "node": node.astype(np.float32),
                "label": np.int64(label), "seg": seg.astype(np.int64)}
