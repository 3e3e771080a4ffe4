"""Mesh -> point-cloud sampling (port of the JAX package's
``data/sampler.py``, which replaces the reference's Matlab tooling at
data/sampler_matlab/: sampler.m, read_obj.m, pc_generator.m).

``sample_mesh`` reproduces sampler.m:1-40: triangle areas via cross
products, area-weighted triangle choice, uniform barycentric samples
(sqrt trick, sampler.m:29-35), per-point face normals.  The numpy
functions draw from the generator in the JAX package's order, so they
give the same bytes for the same seed.

``farthest_point_sampling`` reproduces the loaders' FarthestSampler
(modelnet_shrec_loader.py:153-167; present-but-unused in the reference);
``farthest_point_sampling_torch`` is its batched variant on a tensor's
device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def read_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal .obj parser (read_obj.m): vertices (V,3), faces (F,3) int."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                # triangulate fans for polygons
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64) - 1  # obj is 1-indexed
    return v, f


def sample_mesh(vertices: np.ndarray, faces: np.ndarray, n: int,
                rng: np.random.Generator | None = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted triangle sampling -> (points (n,3), normals (n,3))."""
    rng = rng or np.random.default_rng(0)
    a = vertices[faces[:, 0]]
    b = vertices[faces[:, 1]]
    c = vertices[faces[:, 2]]
    cross = np.cross(b - a, c - a)
    area = 0.5 * np.linalg.norm(cross, axis=1)
    total = area.sum()
    if total <= 0:
        raise ValueError("degenerate mesh: zero total area")
    probs = area / total
    tri = rng.choice(len(faces), n, p=probs)
    # uniform barycentric via sqrt trick (sampler.m:29-35)
    r1 = np.sqrt(rng.uniform(size=(n, 1)))
    r2 = rng.uniform(size=(n, 1))
    pts = (1 - r1) * a[tri] + r1 * (1 - r2) * b[tri] + r1 * r2 * c[tri]
    normals = cross[tri] / (np.linalg.norm(cross[tri], axis=1,
                                           keepdims=True) + 1e-12)
    return pts.astype(np.float32), normals.astype(np.float32)


def normalize_cloud(pts: np.ndarray) -> np.ndarray:
    """Center + scale to the unit sphere (standard ModelNet prep)."""
    pts = pts - pts.mean(0, keepdims=True)
    scale = np.linalg.norm(pts, axis=1).max() + 1e-12
    return pts / scale


def farthest_point_sampling(pts: np.ndarray, k: int,
                            rng: np.random.Generator | None = None
                            ) -> np.ndarray:
    """Greedy FPS (modelnet_shrec_loader.py:153-167), numpy."""
    rng = rng or np.random.default_rng(0)
    out = np.zeros((k, pts.shape[1]), pts.dtype)
    out[0] = pts[rng.integers(len(pts))]
    d = np.sum((out[0] - pts) ** 2, 1)
    for i in range(1, k):
        out[i] = pts[d.argmax()]
        d = np.minimum(d, np.sum((out[i] - pts) ** 2, 1))
    return out


def farthest_point_sampling_torch(pts: torch.Tensor, k: int,
                                  first: int = 0) -> torch.Tensor:
    """Greedy FPS over a batch of clouds (B, N, C) on their device: the
    (B, k) int64 indices of the chosen points, starting from point
    ``first`` of every cloud.  Each step takes the first of the points
    farthest from those chosen so far (as ``jnp.argmax`` does); the k - 1
    steps are launched without waiting for the device."""
    B, N, _ = pts.shape
    rows = torch.arange(B, device=pts.device)
    idx = torch.empty(B, k, dtype=torch.long, device=pts.device)
    idx[:, 0] = first
    d = ((pts[:, first:first + 1] - pts) ** 2).sum(-1)           # (B, N)
    for i in range(1, k):
        nxt = _first_argmax(d)
        idx[:, i] = nxt
        d = torch.minimum(d, ((pts[rows, nxt][:, None] - pts) ** 2).sum(-1))
    return idx


def _first_argmax(d: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis: the smallest index
    whose value equals the row's max (``torch.argmax`` does not promise
    which of tied maxima it returns)."""
    n = d.shape[-1]
    hit = d == d.amax(-1, keepdim=True)
    pos = torch.arange(n, device=d.device).expand_as(d)
    return torch.where(hit, pos, n).amin(-1)
