"""Pairwise-distance and top-k assignment ops (port of the JAX package's
``ops/pairwise.py``).

Channel-last: points are ``(..., N, C)``.  Distances are computed in
float32 as ``|a|^2 + |b|^2 - 2 a.b`` clamped at 0.  Top-k selection uses a
stable ascending sort so that ties go to the lower index, as
``jax.lax.top_k`` does (``torch.topk`` promises no tie order).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distance: a (..., N, C), b (..., M, C) -> (..., N, M)."""
    a = a.float()
    b = b.float()
    a2 = (a * a).sum(-1, keepdim=True)            # (..., N, 1)
    b2 = (b * b).sum(-1, keepdim=True)            # (..., M, 1)
    ab = torch.matmul(a, b.transpose(-1, -2))
    d = a2 + b2.transpose(-1, -2) - 2.0 * ab
    return torch.clamp_min(d, 0.0)


def _smallest_k(d: torch.Tensor, k: int):
    """(values, indices) of the k smallest entries along the last axis,
    ascending, ties broken toward the lower index."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def knn(points: torch.Tensor, k: int,
        queries: torch.Tensor | None = None) -> torch.Tensor:
    """Exact brute-force kNN indices, ascending distance, self first for
    self-kNN.  points (..., M, C); queries (..., Q, C) or None.
    Returns int32 (..., Q, k)."""
    q = points if queries is None else queries
    d = pairwise_sqdist(q, points)
    if queries is None:
        # the matmul-form self-distance is only approximately 0: pin the
        # diagonal below zero so that every node is its own first neighbour
        M = points.shape[-2]
        eye = torch.eye(M, dtype=torch.bool, device=d.device)
        d = d.masked_fill(eye, -1.0)
    _, idx = _smallest_k(d, k)
    return idx.to(torch.int32)


class TopKAssign(NamedTuple):
    """Every point assigned to its top-k nearest SOM nodes.  Stacked arrays
    have length kN, block ``i*N:(i+1)*N`` holding the i-th nearest node."""

    min_idx: torch.Tensor       # (B, kN) int32 node id per stacked point
    mask_row_max: torch.Tensor  # (B, M) bool: node has at least one point
    sqdist: torch.Tensor        # (B, kN) f32 squared distance to the node


def assign_topk(x: torch.Tensor, nodes: torch.Tensor, k: int) -> TopKAssign:
    """x (B, N, C) points; nodes (B, M, C) SOM nodes."""
    B, N, _ = x.shape
    M = nodes.shape[-2]
    if k > M:
        raise ValueError(f"k={k} exceeds the node count {M}")
    d = pairwise_sqdist(x, nodes)                 # (B, N, M)
    vals, idx = _smallest_k(d, k)                 # (B, N, k)
    # stack k-major: (B, k, N) -> (B, kN)
    min_idx = idx.transpose(1, 2).reshape(B, k * N).to(torch.int32)
    sq = vals.transpose(1, 2).reshape(B, k * N)
    counts = torch.zeros(B, M, dtype=torch.int32, device=x.device)
    counts.scatter_add_(1, min_idx.long(), torch.ones_like(min_idx))
    return TopKAssign(min_idx=min_idx, mask_row_max=counts > 0, sqdist=sq)


def one_hot_f32(idx: torch.Tensor, num: int) -> torch.Tensor:
    """One-hot in float32; ids outside ``[0, num)`` give a zero row, as
    ``jax.nn.one_hot`` does."""
    return one_hot(idx, num, torch.float32)


def one_hot(idx: torch.Tensor, num: int, dtype: torch.dtype) -> torch.Tensor:
    """One-hot of ``idx`` over ``num`` classes in ``dtype``; ids outside
    ``[0, num)`` give a zero row."""
    classes = torch.arange(num, device=idx.device, dtype=idx.dtype)
    return (idx[..., None] == classes).to(dtype)


__all__ = ["pairwise_sqdist", "knn", "TopKAssign", "assign_topk",
           "one_hot_f32", "one_hot"]
