"""The benchmark's inputs, made on the device from the run's seed: the
clouds of a split, their nodes, and the model's weights.  Both the
measured program and the reference receive these same tensors.

Clouds are superellipsoids with their normals, one shape per class (a
fixed table of axes and exponents) scaled per cloud and normalised into
the unit sphere, as ModelNet's and ShapeNetPart's aligned clouds are.  A
ShapeNetPart-style split also labels each point with one of its
category's parts, by height.  Nodes are picked by farthest-point sampling,
standing in for the SOM fit of ``prep som``.

Seeds: ``sub_seed(seed, tag)`` derives one 63-bit seed per use from the
run's ``--seed`` (any non-negative whole number), so each input is drawn
from its own stream.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Optional

import numpy as np
import torch

# ShapeNetPart's 16 categories and the global ids of their parts
PART_LABEL = [
    [0, 1, 2, 3], [4, 5], [6, 7], [8, 9, 10, 11], [12, 13, 14, 15],
    [16, 17, 18], [19, 20, 21], [22, 23], [24, 25, 26, 27], [28, 29],
    [30, 31, 32, 33, 34, 35], [36, 37], [38, 39, 40], [41, 42, 43],
    [44, 45, 46], [47, 48, 49],
]
CHUNK = 1024          # clouds made at a time


def sub_seed(seed: int, tag: str) -> int:
    """A seed for the use ``tag`` of the run seed ``seed``."""
    ss = np.random.SeedSequence([int(seed), zlib.crc32(tag.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _shape_table(classes: int):
    """(axes (classes, 3), exponents (classes,)): fixed, whatever the seed,
    so every seed draws clouds of the same kinds."""
    rs = np.random.RandomState(1234)
    axes = rs.uniform(0.35, 1.0, (classes, 3)).astype(np.float32)
    expo = rs.uniform(0.4, 1.6, classes).astype(np.float32)
    return axes, expo


def surfaces(T: int, P: int, classes: int, gen: torch.Generator, device
             ) -> Dict[str, torch.Tensor]:
    """``T`` clouds of ``P`` points with unit normals: ``pc``, ``sn`` (T, P,
    3) float32, ``label`` (T,) int64 (cloud i is of class i % classes) and
    ``height`` (T, P) in [0, 1) along the shape's own vertical axis."""
    axes, expo = (torch.from_numpy(a).to(device) for a in _shape_table(classes))
    pc = torch.empty((T, P, 3), device=device)
    sn = torch.empty((T, P, 3), device=device)
    height = torch.empty((T, P), device=device)
    label = torch.arange(T, device=device) % classes
    for s in range(0, T, CHUNK):
        n = min(CHUNK, T - s)
        c = label[s:s + n]
        u = torch.randn((n, P, 3), generator=gen, device=device)
        u = u / u.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        jitter = torch.rand((n, 1, 3), generator=gen, device=device) * 0.3 + 0.85
        a = axes[c][:, None, :] * jitter                      # (n, 1, 3)
        e = expo[c][:, None, None]
        mag = u.abs()
        x = a * torch.sign(u) * mag.pow(e)
        # the gradient of sum |x_i / a_i|^(2/e), up to a positive factor
        nrm = torch.sign(u) * mag.pow(2 - e) / a
        nrm = nrm / nrm.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        x = x - x.mean(1, keepdim=True)
        x = x / x.norm(dim=-1).amax(1)[:, None, None]
        pc[s:s + n], sn[s:s + n] = x, nrm
        lo, hi = x[..., 1].amin(1, keepdim=True), x[..., 1].amax(1, keepdim=True)
        height[s:s + n] = ((x[..., 1] - lo) / (hi - lo)).clamp(0, 0.999999)
    return {"pc": pc, "sn": sn, "label": label, "height": height}


def part_labels(label: torch.Tensor, height: torch.Tensor) -> torch.Tensor:
    """(T, P) int64 global part ids: a cloud of category c is cut by height
    into as many bands as c has parts."""
    C = len(PART_LABEL)
    width = max(len(p) for p in PART_LABEL)
    table = torch.full((C, width), -1, dtype=torch.int64)
    for c, parts in enumerate(PART_LABEL):
        table[c, :len(parts)] = torch.tensor(parts)
    table = table.to(label.device)
    nparts = (table >= 0).sum(1)
    cat = label % C
    band = (height * nparts[cat][:, None]).long()
    return table[cat[:, None], band]


def farthest_points(pc: torch.Tensor, M: int) -> torch.Tensor:
    """(T, M, 3) nodes of (T, P, 3) clouds by farthest-point sampling from
    point 0."""
    T, P, _ = pc.shape
    out = torch.empty((T, M, 3), device=pc.device)
    for s in range(0, T, CHUNK):
        x = pc[s:s + CHUNK]
        n = x.shape[0]
        rows = torch.arange(n, device=pc.device)
        dist = torch.full((n, P), float("inf"), device=pc.device)
        pick = torch.zeros(n, dtype=torch.int64, device=pc.device)
        for m in range(M):
            p = x[rows, pick]                                 # (n, 3)
            out[s:s + n, m] = p
            dist = torch.minimum(dist, (x - p[:, None]).square().sum(-1))
            pick = dist.argmax(1)
    return out


def split(spec: dict, seed: int, device, tag: str = "split"
          ) -> Dict[str, torch.Tensor]:
    """A split of ``spec["items"]`` clouds of ``spec["points"]`` points on
    ``device``: ``pc``, ``sn``, ``node`` (``spec["nodes"]`` a cloud),
    ``label`` (the class, or the ShapeNetPart category), and with
    ``spec["parts"]`` the per-point ``seg``."""
    gen = generator(seed, tag, device)
    d = surfaces(spec["items"], spec["points"], spec["classes"], gen, device)
    out = {"pc": d["pc"], "sn": d["sn"], "label": d["label"],
           "node": farthest_points(d["pc"], spec["nodes"])}
    if spec.get("parts"):
        out["seg"] = part_labels(d["label"], d["height"])
    return out


def weights(specs: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """One tensor per entry of ``specs`` ({name: (shape, kind)}, the
    reference's ``param_specs``), drawn from one normal sample on
    ``device``: dense kernels He-normal by fan-in, biases and BatchNorm
    shifts N(0, 0.05), BatchNorm scales 1 + N(0, 0.05), running means
    N(0, 0.05) and running variances 1 + 0.2 |N(0, 1)|."""
    total = sum(math.prod(shape) for shape, _ in specs.values())
    z = torch.randn(total, generator=generator(seed, "weights", device),
                    device=device)
    out, off = {}, 0
    for name, (shape, kind) in specs.items():
        n = math.prod(shape)
        x = z[off:off + n].view(shape)
        off += n
        if kind == "weight":
            x = x * math.sqrt(2.0 / shape[1])
        elif kind in ("bias", "bn_bias", "running_mean"):
            x = x * 0.05
        elif kind == "bn_weight":
            x = 1.0 + 0.05 * x
        elif kind == "running_var":
            x = 1.0 + 0.2 * x.abs()
        else:
            raise ValueError(f"{name}: kind {kind!r}")
        out[name] = x.contiguous()
    return out


def subsample(pc: torch.Tensor, n: int, gen: Optional[torch.Generator]
              ) -> torch.Tensor:
    """(T, n) indices of a uniform subset of each cloud's points."""
    keys = torch.rand(pc.shape[:2], generator=gen, device=pc.device)
    return torch.argsort(keys, dim=1)[:, :n]
