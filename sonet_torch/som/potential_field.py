"""Potential-field initial SOM nodes (the port's own copy of the JAX
package's ``som/potential_field.py``; numpy only).

N-body inverse-cube repulsion plus a wall force in [-1, 1]^dim, 100
iterations from a fixed seed (2017), then a row-major grid reorder (by x,
then by y within a row), so that node i sits at grid cell
(i // cols, i % cols).  Runs once per (node_num, dim) and is cached.
"""

from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=16)
def potential_field_nodes(node_num: int, dim: int) -> np.ndarray:
    """(node_num, dim) float32 node positions in [-1, 1]^dim.  The array
    is shared between callers: copy it before writing to it."""
    rng = np.random.RandomState(2017)
    node = rng.rand(node_num, dim) * 2.0 - 1.0

    lr = 0.01
    for _ in range(100):
        # pairwise repulsion: f(src -> dst) = (dst - src) / (|.| + 1e-5)^3
        diff = node[None, :, :] - node[:, None, :]      # [src, dst, dim]
        norm = np.linalg.norm(diff, axis=-1) + 1e-5     # [src, dst]
        force = np.sum(diff / (norm ** 3)[..., None], axis=0)  # over src
        # wall force: -x * M / 1.5 per dim, dead zone |x| < 0.01
        wall = np.where(np.abs(node) < 0.01, 0.0, -node * node_num / 1.5)
        node = node + (force + wall) * lr

    out = _grid_reorder(node).astype(np.float32)
    out.setflags(write=False)
    return out


def _grid_reorder(node: np.ndarray) -> np.ndarray:
    """Row-major reorder by x, then by y within a row; a node count that
    is no perfect square keeps the x-sort only."""
    node_num, dim = node.shape
    rows = int(math.sqrt(node_num))
    cols = rows
    if rows * cols != node_num:
        return node[node[:, 0].argsort()]
    ordered = node[node[:, 0].argsort()].reshape(rows, cols, dim)
    for i in range(rows):
        ordered[i] = ordered[i][ordered[i][:, 1].argsort()]
    return ordered.reshape(node_num, dim)
