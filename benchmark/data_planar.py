"""The 2-D cells' inputs, made on the device from the run's seed: a split
of planar stroke clouds without normals and their nodes (``data.py``
makes the 3-D ones; the weights come from ``data.weights`` over the 2-D
reference's ``param_specs``).

A cloud of class c is a Lissajous stroke, x = sin(2 pi a_c t + phase),
y = sin(2 pi b_c t), with a_c = c % 5 + 1 and b_c = c // 5 + 1 (so the
ten classes are ten shapes), at a per-cloud phase and radii, ``points``
positions t drawn uniformly along it and spread across it as a pen
stroke's width, then moved and scaled into [-1, 1]^2 (the box MNIST's
pixels map to).  Nodes are picked by farthest-point sampling in 2-D,
standing in for the 5x5 SOM fit of ``prep som``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.data import CHUNK, generator

WIDTH = 0.03          # the stroke's width, a standard deviation


def strokes(T: int, P: int, classes: int, gen: torch.Generator, device
            ) -> Dict[str, torch.Tensor]:
    """``T`` clouds of ``P`` 2-D points: ``pc`` (T, P, 2) float32 in
    [-1, 1]^2 and ``label`` (T,) int64 (cloud i is of class i % classes)."""
    pc = torch.empty((T, P, 2), device=device)
    label = torch.arange(T, device=device) % classes
    for s in range(0, T, CHUNK):
        n = min(CHUNK, T - s)
        c = label[s:s + n]
        freq = torch.stack([c % 5 + 1, c // 5 + 1], -1).float()  # (n, 2)
        t = torch.rand((n, P, 1), generator=gen, device=device)
        phase = torch.rand((n, 1), generator=gen, device=device) * math.pi
        radius = torch.rand((n, 1, 2), generator=gen, device=device) * 0.4 \
            + 0.6
        pen = torch.randn((n, P, 2), generator=gen, device=device) * WIDTH
        angle = 2 * math.pi * freq[:, None, :] * t                # (n, P, 2)
        angle[..., 0] += phase
        x = radius * torch.sin(angle) + pen
        lo, hi = x.amin(1, keepdim=True), x.amax(1, keepdim=True)
        x = x - (lo + hi) / 2
        pc[s:s + n] = x / x.abs().amax((1, 2), keepdim=True)
    return {"pc": pc, "label": label}


def farthest_points(pc: torch.Tensor, M: int) -> torch.Tensor:
    """(T, M, D) nodes of (T, P, D) clouds by farthest-point sampling from
    point 0."""
    T, P, D = pc.shape
    out = torch.empty((T, M, D), device=pc.device)
    for s in range(0, T, CHUNK):
        x = pc[s:s + CHUNK]
        n = x.shape[0]
        rows = torch.arange(n, device=pc.device)
        dist = torch.full((n, P), float("inf"), device=pc.device)
        pick = torch.zeros(n, dtype=torch.int64, device=pc.device)
        for m in range(M):
            p = x[rows, pick]                                 # (n, D)
            out[s:s + n, m] = p
            dist = torch.minimum(dist, (x - p[:, None]).square().sum(-1))
            pick = dist.argmax(1)
    return out


def split(spec: dict, seed: int, device, tag: str = "split"
          ) -> Dict[str, torch.Tensor]:
    """A split of ``spec["items"]`` clouds of ``spec["points"]`` 2-D points
    on ``device``: ``pc``, ``node`` (``spec["nodes"]`` a cloud) and
    ``label``."""
    d = strokes(spec["items"], spec["points"], spec["classes"],
                generator(seed, tag, device), device)
    return {"pc": d["pc"], "label": d["label"],
            "node": farthest_points(d["pc"], spec["nodes"])}
