"""Carry weights, batch statistics and gradients between the JAX package
and the port.

The JAX package keeps a model's variables as a nested tree; flattened
with ``/`` its keys read like

    params/encoder/first_pointnet/PointLayer_3/Dense_0/kernel   (320, 384)
    params/encoder/first_pointnet/PointLayer_0/BatchNorm_0/scale (64,)
    batch_stats/encoder/first_pointnet/PointLayer_0/BatchNorm_0/mean

The port's modules carry the same path names, so a key maps to a
``state_dict`` entry by its path and its leaf: a dense ``kernel``
(in, out) becomes ``weight`` (out, in); a convolution ``kernel``
(kh, kw, in, out) becomes ``weight`` (out, in, kh, kw); BatchNorm and
InstanceNorm ``scale`` / ``bias`` become ``weight`` / ``bias``; ``mean`` /
``var`` become the ``running_mean`` / ``running_var`` buffers.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

_PARAM_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}
_NORMS = ("BatchNorm", "InstanceNorm")


def _kernel_to_torch(arr: np.ndarray) -> np.ndarray:
    """A JAX ``kernel`` in the port's layout: (in, out) -> (out, in),
    (kh, kw, in, out) -> (out, in, kh, kw)."""
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    return arr.T


def _kernel_to_jax(arr: np.ndarray) -> np.ndarray:
    """The converse of ``_kernel_to_torch``."""
    if arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    return arr.T


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
    """JAX variable key -> (state_dict key, whether it is a kernel)."""
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
            tkey, is_kernel = _torch_key(key)
            if tkey not in state:
                raise KeyError(f"variable {key!r} has no place in the model "
                               f"(looked for {tkey!r})")
            if is_kernel:
                arr = _kernel_to_torch(arr)
            dst = state[tkey]
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"variable {key!r}: shape {arr.shape}, model "
                                 f"{tkey!r} has {tuple(dst.shape)}")
            dst.copy_(torch.tensor(np.asarray(arr, np.float32)))
            seen.add(tkey)
    unset = sorted(set(state) - seen)
    if unset:
        raise KeyError(f"model entries not set by the variables: {unset}")


def _jax_key(tkey: str) -> tuple[str, bool]:
    """``state_dict`` key -> (flattened JAX variable key, whether it is a
    kernel)."""
    *path, leaf = tkey.split(".")
    if leaf.startswith("running_"):
        return "/".join(["batch_stats", *path, leaf[len("running_"):]]), False
    if leaf == "bias":
        return "/".join(["params", *path, "bias"]), False
    if path[-1].startswith(_NORMS):
        return "/".join(["params", *path, "scale"]), False
    return "/".join(["params", *path, "kernel"]), True


def _to_numpy(t: torch.Tensor, is_kernel: bool) -> np.ndarray:
    a = t.detach().cpu().float().numpy()
    return np.ascontiguousarray(_kernel_to_jax(a) if is_kernel else a)


def to_jax_variables(model: nn.Module) -> dict[str, np.ndarray]:
    """The converse: the model's weights and BatchNorm statistics as
    flattened JAX variable keys."""
    out = {}
    for tkey, t in model.state_dict().items():
        key, is_kernel = _jax_key(tkey)
        out[key] = _to_numpy(t, is_kernel)
    return out


def gradients_to_jax(model: nn.Module) -> dict[str, np.ndarray]:
    """The gradients held in the parameters' ``.grad``, under the same
    ``params/...`` keys and layouts as ``to_jax_variables``, so they
    compare with the JAX package's gradient tree flattened under
    ``params``.  A parameter with no gradient (a bias that a BatchNorm
    follows) reads zeros, as its cotangent is zero in the JAX package."""
    out = {}
    for tkey, p in model.named_parameters():
        key, is_kernel = _jax_key(tkey)
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        out[key] = _to_numpy(g, is_kernel)
    return out
