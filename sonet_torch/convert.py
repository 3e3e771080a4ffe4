"""Carry weights between the JAX package and the port.

The JAX package keeps a model's variables as a nested tree; flattened
with ``/`` its keys read like

    params/encoder/first_pointnet/PointLayer_3/Dense_0/kernel   (320, 384)
    params/encoder/first_pointnet/PointLayer_0/BatchNorm_0/scale (64,)
    batch_stats/encoder/first_pointnet/PointLayer_0/BatchNorm_0/mean

The port's modules carry the same path names, so a key maps to a
``state_dict`` entry by its path and its leaf: a dense ``kernel``
(in, out) becomes ``weight`` (out, in); BatchNorm ``scale`` / ``bias``
become ``weight`` / ``bias``; ``mean`` / ``var`` become the
``running_mean`` / ``running_var`` buffers.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

_PARAM_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def flatten(tree: Mapping, sep: str = "/") -> dict[str, np.ndarray]:
    """A nested mapping of arrays -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            for kk, vv in flatten(v, sep).items():
                out[f"{k}{sep}{kk}"] = vv
        else:
            out[str(k)] = np.asarray(v)
    return out


def _torch_key(key: str) -> tuple[str, bool]:
    """JAX variable key -> (state_dict key, whether to transpose)."""
    parts = key.split("/")
    if len(parts) < 3:
        raise KeyError(f"unexpected variable key {key!r}")
    coll, path, leaf = parts[0], parts[1:-1], parts[-1]
    table = {"params": _PARAM_LEAF, "batch_stats": _STAT_LEAF}.get(coll)
    if table is None or leaf not in table:
        raise KeyError(f"unexpected variable key {key!r}")
    return ".".join(path + [table[leaf]]), leaf == "kernel"


def load_jax_variables(model: nn.Module, variables: Mapping) -> None:
    """Load the JAX package's variables (nested, or flattened with ``/``;
    numpy or anything ``np.asarray`` takes) into ``model`` in place.

    Raises on a key the model has no place for, on a model entry left
    unset, and on a shape mismatch."""
    flat = flatten(variables)
    state = model.state_dict()
    seen = set()
    with torch.no_grad():
        for key, arr in flat.items():
            tkey, transpose = _torch_key(key)
            if tkey not in state:
                raise KeyError(f"variable {key!r} has no place in the model "
                               f"(looked for {tkey!r})")
            if transpose:
                arr = arr.T
            dst = state[tkey]
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"variable {key!r}: shape {arr.shape}, model "
                                 f"{tkey!r} has {tuple(dst.shape)}")
            dst.copy_(torch.tensor(np.asarray(arr, np.float32)))
            seen.add(tkey)
    unset = sorted(set(state) - seen)
    if unset:
        raise KeyError(f"model entries not set by the variables: {unset}")


def to_jax_variables(model: nn.Module) -> dict[str, np.ndarray]:
    """The converse: the model's weights as flattened JAX variable keys."""
    out = {}
    for tkey, t in model.state_dict().items():
        *path, leaf = tkey.split(".")
        a = t.detach().cpu().float().numpy()
        if leaf.startswith("running_"):
            coll, jleaf = "batch_stats", leaf[len("running_"):]
        elif leaf == "bias":
            coll, jleaf = "params", "bias"
        elif path[-1].startswith("BatchNorm"):
            coll, jleaf = "params", "scale"
        else:
            coll, jleaf, a = "params", "kernel", a.T
        out["/".join([coll, *path, jleaf])] = np.ascontiguousarray(a)
    return out
