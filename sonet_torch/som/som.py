"""Batched self-organizing map (port of the JAX package's ``som/som.py``).

``fit`` runs the fixed schedule of competitive-learning updates over a
batch of clouds, one SOM per cloud, under ``torch.no_grad()`` on the
device the caller names.  State is explicit: nodes in, nodes out.

Two schedules, as in the JAX package: ``"prep"`` (10 warm-up iterations
at the initial rate and sigma, then 30 decayed by 1 / (1 + it / 30); the
variant the published datasets were built with) and ``"online"`` (20 +
60, decayed by 1 / (1 + 2 it / 60)).

Float32 whatever the process's matmul switches say: the three products of
an update and the distance product that feeds the winner search are
written as a broadcast multiply and a sum, never as a library matmul, so
neither TF32 nor any other reduced-precision matmul mode can reach them
(reduced precision moves nodes by about 2e-3), and a fit gives the same
bits whatever ``torch.backends.cuda.matmul.allow_tf32`` or
``torch.set_float32_matmul_precision`` are set to.  The sums are
``torch.sum`` reductions (no atomics), so a fit also repeats bit for bit
on one device.  The products are tiny (C = 2 or 3, M = 64); the
temporaries are (B, N, M, C) float32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.pairwise import TopKAssign, assign_topk, one_hot_f32
from .potential_field import potential_field_nodes


class SOMConfig(NamedTuple):
    rows: int = 8
    cols: int = 8
    dim: int = 3
    sigma: float = 0.4
    learning_rate: float = 0.5
    schedule: str = "prep"      # "prep" | "online"

    @property
    def node_num(self) -> int:
        return self.rows * self.cols


def init_nodes(cfg: SOMConfig, batch_size: int | None = None,
               device: str | torch.device = "cuda") -> torch.Tensor:
    """Potential-field initial nodes on ``device``: (M, dim) float32, or
    (B, M, dim) when ``batch_size`` is given (a fresh tensor each call)."""
    n = torch.from_numpy(potential_field_nodes(cfg.node_num, cfg.dim).copy())
    n = n.to(resolve_device(device))
    if batch_size is None:
        return n
    return n.expand(batch_size, cfg.node_num, cfg.dim).contiguous()


@functools.lru_cache(maxsize=16)
def _grid_log_gaussian(rows: int, cols: int, sigma: float) -> np.ndarray:
    """log of the initial neighbourhood weight between grid cells i and j:
    log w0[i, j] = -((ri - rj)^2 + (ci - cj)^2) / (2 pi sigma^2).  Other
    sigmas rescale it: w = exp(log w0 / (sigma / sigma0)^2)."""
    idx = np.arange(rows * cols)
    ri, ci = idx // cols, idx % cols
    d2 = (ri[:, None] - ri[None, :]) ** 2 + (ci[:, None] - ci[None, :]) ** 2
    out = (-d2 / (2.0 * np.pi * sigma * sigma)).astype(np.float32)
    out.setflags(write=False)
    return out


def _sqdist(x: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
    """|x|^2 + |node|^2 - 2 x.node clamped at 0, as ``ops.pairwise_sqdist``
    computes it, with the product in true float32 (module doc):
    x (B, N, C), nodes (B, M, C) -> (B, N, M)."""
    x, nodes = x.float(), nodes.float()
    x2 = (x * x).sum(-1, keepdim=True)                       # (B, N, 1)
    n2 = (nodes * nodes).sum(-1)[:, None, :]                 # (B, 1, M)
    xn = (x[:, :, None, :] * nodes[:, None, :, :]).sum(-1)   # (B, N, M)
    return torch.clamp_min(x2 + n2 - 2.0 * xn, 0.0)


def _logw0(cfg: SOMConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        _grid_log_gaussian(cfg.rows, cfg.cols, cfg.sigma).copy()).to(device)


def _update(nodes: torch.Tensor, x: torch.Tensor, learning_rate: float,
            sigma: float, logw0: torch.Tensor, sigma0: float) -> torch.Tensor:
    """``batch_update`` with the log neighbourhood weights on the device."""
    M = nodes.shape[1]
    min_idx = _sqdist(x, nodes).argmin(-1)                   # (B, N)
    onehot = one_hot_f32(min_idx, M)                         # (B, N, M)
    counts = onehot.sum(1)                                   # (B, M)
    occupied = (counts > 0).float()
    cluster_sum = (onehot[..., None] * x[:, :, None, :]).sum(1)   # (B, M, C)
    mean = cluster_sum / (counts[..., None] + 1e-5)

    # the scalar arithmetic in float32, as the JAX package traces it
    ratio = np.float32(sigma) / np.float32(sigma0)
    scale = np.float32(1.0) / (ratio * ratio)
    w = torch.exp(logw0 * float(scale))                      # (M_i, M_j)

    occ_mean = mean * occupied[..., None]                    # zero empty means
    pull = (w[None, :, :, None] * occ_mean[:, :, None, :]).sum(1)  # (B, M_j, C)
    gate = (w[None] * occupied[:, :, None]).sum(1)           # (B, M_j)
    delta = float(np.float32(learning_rate)) * (pull - nodes * gate[..., None])
    return nodes + delta


def batch_update(nodes: torch.Tensor, x: torch.Tensor, learning_rate: float,
                 sigma: float, cfg: SOMConfig) -> torch.Tensor:
    """One competitive-learning update: every point goes to its nearest
    node, each occupied node i pulls every node j toward the mean of its
    points with the grid-neighbourhood weight w[i, j]:

        delta_j = lr * sum_i w[i, j] * occ_i * (mean_i - node_j)
                = lr * (w^T (occ * mean) - node_j * (w^T occ))

    An empty node has no mean and pulls nothing; it moves only by its
    occupied neighbours' pull.  nodes (B, M, C), x (B, N, C) -> new nodes
    (B, M, C), float32, on the tensors' device."""
    nodes, x = nodes.float(), x.float()
    return _update(nodes, x, learning_rate, sigma,
                   _logw0(cfg, nodes.device), cfg.sigma)


def _schedule(cfg: SOMConfig) -> tuple[np.ndarray, np.ndarray]:
    """(lr, sigma) float32 arrays for the whole fit: warm-up, then the
    decayed iterations."""
    lr0, s0 = cfg.learning_rate, cfg.sigma
    if cfg.schedule == "online":
        warm, main, rate = 20, 60, 2.0
    elif cfg.schedule == "prep":
        warm, main, rate = 10, 30, 1.0
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    it = np.arange(main, dtype=np.float32)
    decay = 1.0 / (1.0 + rate * it / main)
    lr = np.concatenate([np.full(warm, lr0, np.float32), lr0 * decay])
    sigma = np.concatenate([np.full(warm, s0, np.float32), s0 * decay])
    return lr, sigma


def fit(x, cfg: SOMConfig, init: Optional[torch.Tensor] = None,
        device: str | torch.device = "cuda") -> torch.Tensor:
    """Fit one SOM per cloud: x (B, N, dim), a tensor or an array ->
    nodes (B, M, dim) float32 on ``device``, from the potential-field
    nodes or from ``init`` (B, M, dim).  Raises when ``device`` is
    ``cuda`` and there is no card."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    if x.dim() != 3 or x.shape[-1] != cfg.dim:
        raise ValueError(f"x must be (B, N, {cfg.dim}), got {tuple(x.shape)}")
    if init is None:
        nodes = init_nodes(cfg, x.shape[0], dev)
    else:
        nodes = torch.as_tensor(init, dtype=torch.float32).to(dev)
    lr, sigma = _schedule(cfg)
    with torch.no_grad():
        logw0 = _logw0(cfg, dev)
        for lr_t, sigma_t in zip(lr, sigma):
            nodes = _update(nodes, x, lr_t, sigma_t, logw0, cfg.sigma)
    return nodes


def query(nodes: torch.Tensor, x: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-node assignment: (min_idx (B, N) int32, occupied (B, M)
    bool)."""
    B, M = nodes.shape[0], nodes.shape[1]
    min_idx = _sqdist(x, nodes).argmin(-1)
    occupied = torch.zeros(B, M, dtype=torch.bool, device=nodes.device)
    occupied.scatter_(1, min_idx, True)
    return min_idx.to(torch.int32), occupied


def query_topk(nodes: torch.Tensor, x: torch.Tensor, k: int) -> TopKAssign:
    """Top-k assignment, as the encoder makes it (``ops.assign_topk``)."""
    return assign_topk(x, nodes, k)
