"""Synthetic point-cloud datasets for tests and runs without a dataset
(port of the JAX package's ``data/synthetic.py``).

Classification: each class is a parametric surface (sphere, cube shell,
cylinder, torus) at one of several scales.  Segmentation labels the
quadrants of the shape with its category's parts.  The clouds, labels and
augmentation draws are the JAX package's, bit for bit, for the same seed;
the SOM nodes are fitted at construction by ``sonet_torch.som.fit`` on the
device the caller names (``cuda`` unless it asks for ``cpu``), as the
offline prep fits them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import Config
from ..ops import PART_LABEL
from ..som import SOMConfig, fit as som_fit
from . import augmentation as aug
from .seeding import EpochSeeded


def _unit(v, axis=-1):
    return v / (np.linalg.norm(v, axis=axis, keepdims=True) + 1e-9)


def _shape_cloud(cls: int, n: int, rng: np.random.Generator):
    """Returns (pc (n,3), sn (n,3)) for class id (mod 4 shape families)."""
    t = cls % 4
    if t == 0:  # sphere
        p = _unit(rng.standard_normal((n, 3)))
        return p, p.copy()
    if t == 1:  # cube shell
        p = rng.uniform(-1, 1, (n, 3))
        face = rng.integers(0, 3, n)
        sign = rng.choice([-1.0, 1.0], n)
        p[np.arange(n), face] = sign
        sn = np.zeros((n, 3))
        sn[np.arange(n), face] = sign
        return p, sn
    if t == 2:  # cylinder
        theta = rng.uniform(0, 2 * np.pi, n)
        z = rng.uniform(-1, 1, n)
        p = np.stack([np.cos(theta), z, np.sin(theta)], 1)
        sn = np.stack([np.cos(theta), np.zeros(n), np.sin(theta)], 1)
        return p, sn
    # torus
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    R, r = 0.8, 0.35
    p = np.stack([(R + r * np.cos(v)) * np.cos(u), r * np.sin(v),
                  (R + r * np.cos(v)) * np.sin(u)], 1)
    sn = np.stack([np.cos(v) * np.cos(u), np.sin(v),
                   np.cos(v) * np.sin(u)], 1)
    return p, sn


class SyntheticDataset(EpochSeeded):
    """In-memory synthetic dataset with SOM nodes fitted on ``device``.
    Raises when ``device`` is ``cuda`` and there is no card."""

    def __init__(self, cfg: Config, size: int = 64, mode: str = "train",
                 seed: int = 0, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.mode = mode
        self._init_seeding(seed, mode)
        rng = np.random.default_rng(seed + (0 if mode == "train" else 10_000))
        n, M = cfg.input_pc_num, cfg.node_num
        self.pc = np.zeros((size, n, 3), np.float32)
        self.sn = np.zeros((size, n, 3), np.float32)
        self.label = np.zeros((size,), np.int64)
        self.seg = np.zeros((size, n), np.int64)
        for i in range(size):
            cls = i % cfg.classes
            pc, sn = _shape_cloud(cls, n, rng)
            # class = (shape family) x (scale): families repeat mod 4, the
            # scale distinguishes cls and cls+4
            scale = 0.75 + 0.25 * (cls // 4)
            self.pc[i] = pc * scale
            self.sn[i] = sn
            if cfg.task == "segment":
                # seg task: label is the 16-way shape category; parts come
                # from that category's slots in the ShapeNetPart table
                label16 = cls % 16
                self.label[i] = label16
                parts = PART_LABEL[label16]
                octant = ((pc[:, 0] > 0).astype(int)
                          + 2 * (pc[:, 1] > 0).astype(int))
                self.seg[i] = np.asarray(parts)[octant % len(parts)]
            else:
                self.label[i] = cls

        # offline SOM prep, batched on the device (replaces save_som.ipynb)
        som_cfg = SOMConfig(rows=cfg.rows, cols=cfg.cols, dim=3,
                            schedule="prep")
        nodes = som_fit(self.pc, som_cfg, device=device)
        self.som_node = nodes.cpu().numpy()

    def __len__(self):
        return len(self.pc)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        pc, sn, node = self.pc[idx], self.sn[idx], self.som_node[idx]
        if self.mode == "train":
            pc, sn, node = aug.train_augment(
                pc, sn, node, self.item_rng(idx),
                rot_horizontal=cfg.rot_horizontal,
                rot_perturbation=cfg.rot_perturbation,
                translation_perturbation=cfg.translation_perturbation)
        item = {"pc": pc.astype(np.float32), "sn": sn.astype(np.float32),
                "node": node.astype(np.float32),
                "label": self.label[idx].astype(np.int64)}
        if cfg.task == "segment":
            item["seg"] = self.seg[idx]
        return item

    def raw_item(self, idx: int) -> Dict[str, np.ndarray]:
        """The item without augmentation, for the device-resident
        pipeline (``data/device_pipeline.py``)."""
        item = {"pc": self.pc[idx], "sn": self.sn[idx],
                "node": self.som_node[idx],
                "label": self.label[idx].astype(np.int64)}
        if self.cfg.task == "segment":
            item["seg"] = self.seg[idx]
        return item
