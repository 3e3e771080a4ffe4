"""MNIST as 2D point clouds (port of the JAX package's ``data/mnist.py``).

The reference README lists MNIST classification (README.md:21) and the
code supports 2D inputs (operations.py:31 asserts C in {2,3};
util/som.py takes a ``dim``), but no MNIST loader exists in the snapshot
(SURVEY.md §2.1 caveat) — this module supplies the missing task.

Images become point sets of their bright pixels (threshold 128), pixel
coordinates mapped to [-1, 1]^2, resampled to ``input_pc_num`` points
(512 by default).  "Surface normals" don't exist in 2D; the encoder runs
with ``surface_normal=False``.  SOM nodes (5x5 by default) are fitted at
construction by ``sonet_torch.som.fit`` on the device the caller names
(``cuda`` unless it asks for ``cpu``), in chunks of 512 clouds.  Points,
augmentation draws and the cache file are the JAX package's: a cache
written by either package reads the same in the other.

Accepted dataroot contents:
* ``mnist.npz`` with keys {x_train, y_train, x_test, y_test} (the
  standard keras-style archive), or
* raw IDX files ``{train,t10k}-images-idx3-ubyte`` (+ labels), optionally
  gzipped.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from .seeding import EpochSeeded


def _load_idx(path: str) -> np.ndarray:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def load_mnist_split(root: str, mode: str) -> Tuple[np.ndarray, np.ndarray]:
    npz = os.path.join(root, "mnist.npz")
    if os.path.exists(npz):
        data = np.load(npz)
        key = "train" if mode == "train" else "test"
        return data[f"x_{key}"], data[f"y_{key}"]
    prefix = "train" if mode == "train" else "t10k"
    for suffix in ("", ".gz"):
        ip = os.path.join(root, f"{prefix}-images-idx3-ubyte{suffix}")
        lp = os.path.join(root, f"{prefix}-labels-idx1-ubyte{suffix}")
        if os.path.exists(ip) and os.path.exists(lp):
            return _load_idx(ip), _load_idx(lp)
    raise FileNotFoundError(
        f"no mnist.npz or IDX files under {root!r} for mode {mode!r}")


def image_to_points(img: np.ndarray, n: int, rng: np.random.Generator,
                    threshold: int = 128) -> np.ndarray:
    """(H, W) uint8 -> (n, 2) float32 points in [-1, 1]^2."""
    ys, xs = np.nonzero(img >= threshold)
    if len(ys) == 0:  # blank image safeguard
        ys, xs = np.array([img.shape[0] // 2]), np.array([img.shape[1] // 2])
    h, w = img.shape
    # x right, y up, centered
    pts = np.stack([xs / (w - 1) * 2 - 1, -(ys / (h - 1) * 2 - 1)], 1)
    idx = rng.choice(len(pts), n, replace=len(pts) < n)
    pts = pts[idx]
    # sub-pixel jitter so duplicated pixels don't coincide exactly
    pts = pts + rng.uniform(-0.5, 0.5, pts.shape) * (2.0 / (w - 1)) * 0.5
    return pts.astype(np.float32)


def cache_path(root: str, mode: str, count: int, cfg: Config) -> str:
    """The points-and-nodes cache of a split, keyed on everything that
    changes them (the JAX package's name)."""
    return os.path.join(
        root, f"sonet_cache_{mode}_{count}x{cfg.input_pc_num}"
              f"_{cfg.rows}x{cfg.cols}_s{cfg.seed}.npz")


class MNISTPointCloudDataset(EpochSeeded):
    """MNIST digits as 2-D clouds with SOM nodes fitted on ``device``.
    Raises when ``device`` is ``cuda`` and there is no card."""

    def __init__(self, root: str, mode: str, cfg: Config,
                 limit: int | None = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.mode = mode
        dev = resolve_device(device)
        images, labels = load_mnist_split(root, mode)
        if limit:
            images, labels = images[:limit], labels[:limit]
        self.labels = labels.astype(np.int64)
        n = cfg.input_pc_num

        # on-disk cache of the point sets + SOM fits: re-fitting ~60k
        # SOMs per construction is fine for test fixtures but not for
        # real MNIST
        cache = cache_path(root, mode, len(images), cfg)
        if os.path.exists(cache):
            data = np.load(cache)
            self.points = data["points"]
            self.som_node = data["som_node"]
            self._init_seeding(cfg.seed, mode)
            return

        rng = np.random.default_rng(cfg.seed)
        pts = np.stack([image_to_points(img, n, rng) for img in images])
        self.points = pts  # (T, n, 2)

        # batched SOM fit for the whole split on the device
        from ..som import SOMConfig, fit as som_fit
        som_cfg = SOMConfig(rows=cfg.rows, cols=cfg.cols, dim=2,
                            schedule="prep")
        nodes = []
        chunk = 512
        for i in range(0, len(pts), chunk):
            nodes.append(som_fit(pts[i:i + chunk], som_cfg,
                                 device=dev).cpu().numpy())
        self.som_node = np.concatenate(nodes, 0).astype(np.float32)
        try:
            np.savez(cache, points=self.points, som_node=self.som_node)
        except OSError:
            pass  # read-only dataroot: cache is best-effort
        self._init_seeding(cfg.seed, mode)

    def __len__(self):
        return len(self.points)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        pc = self.points[idx]
        node = self.som_node[idx]
        if self.mode == "train":
            rng = self.item_rng(idx)
            # light jitter + scale augmentation (2D analogue of the
            # loaders' stack; no rotations — digits are orientation-bound)
            pc = pc + np.clip(
                0.01 * rng.standard_normal(pc.shape), -0.05, 0.05)
            scale = rng.uniform(0.9, 1.1)
            pc, node = pc * scale, node * scale
        return {"pc": pc.astype(np.float32),
                "node": node.astype(np.float32),
                "label": self.labels[idx]}

    def raw_item(self, idx: int) -> Dict[str, np.ndarray]:
        """The item without augmentation, for the device-resident
        pipeline (the points are already at input_pc_num, so the device
        draws no subsample)."""
        return {"pc": self.points[idx].astype(np.float32),
                "node": self.som_node[idx].astype(np.float32),
                "label": self.labels[idx]}
