"""Reusable network blocks, channel-last (port of the JAX package's
``nn/layers.py``, eval mode).

Shared MLPs are dense layers over the trailing channel axis of
``(B, N, C)``.  Submodules carry the JAX package's parameter names
(``PointLayer_0``, ``Dense_0``, ``BatchNorm_0``, ...) so that
``convert.py`` maps one tree onto the other by path.

Precision follows the JAX package: with a ``compute_dtype`` (bf16), the
input, kernel and bias are cast to it before the matmul and the bias add;
BatchNorm normalises in float32 and casts back to the input's dtype.
Parameters and BatchNorm statistics stay float32.

Only eval mode is ported: train-mode BatchNorm statistics and the
momentum decay arrive with training, ``InstanceNorm`` and ``UpConv`` with
the slices that use them.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gather import knn_gather


def activation_fn(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """relu / elu / swish / leakyrelu(0.1)."""
    if name is None:
        return lambda x: x
    return {
        "relu": F.relu,
        "elu": F.elu,
        "swish": lambda x: x * torch.sigmoid(x),
        "leakyrelu": lambda x: F.leaky_relu(x, 0.1),
    }[name]


def he_normal_in_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """normal(0, sqrt(2 / fan_in)) in place; ``weight`` is (out, in)."""
    std = math.sqrt(2.0 / weight.shape[1])
    with torch.no_grad():
        weight.copy_(torch.randn(weight.shape, generator=generator) * std)


class Dense(nn.Module):
    """x @ kernel + bias over the trailing axis.  ``weight`` is (out, in),
    the transpose of the JAX package's ``kernel``."""

    def __init__(self, in_features: int, features: int,
                 generator: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))
        he_normal_in_(self.weight, generator)

    def _params(self, dtype: torch.dtype):
        return self.weight.to(dtype), self.bias.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # without a compute dtype the operands promote, as in the JAX
        # package (a bf16 input to a float32 layer runs in float32)
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        w, b = self._params(dt)
        return F.linear(x.to(dt), w) + b


class ConcatDense(Dense):
    """Dense over the concatenation of several inputs, computed as one
    sliced matmul per input plus a sum; the (sum C_i, F) kernel is one
    matrix, as in the JAX package."""

    def __init__(self, in_features: Sequence[int], features: int,
                 generator: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(sum(in_features), features, generator, compute_dtype)
        self.splits = tuple(in_features)

    def forward(self, *xs: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.float32
        w, b = self._params(dt)
        y = None
        off = 0
        for x, c in zip(xs, self.splits):
            part = F.linear(x.to(dt), w[:, off:off + c])
            y = part if y is None else y + part
            off += c
        return y + b


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the trailing channel axis, with the
    running statistics as buffers."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm is not ported yet; call .eval()")
        y = (x.float() - self.running_mean) * torch.rsqrt(
            self.running_var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class PointLayer(nn.Module):
    """Dense -> [BatchNorm] -> [activation] over the trailing axis.  Given
    a sequence of input widths it acts on the virtual concatenation of as
    many inputs (``ConcatDense``)."""

    def __init__(self, in_features: int | Sequence[int], features: int,
                 generator: torch.Generator,
                 activation: Optional[str] = "relu",
                 normalization: Optional[str] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if normalization not in (None, "batch"):
            raise NotImplementedError(f"normalization={normalization!r}")
        if isinstance(in_features, int):
            self.Dense_0 = Dense(in_features, features, generator,
                                 compute_dtype)
        else:
            self.Dense_0 = ConcatDense(in_features, features, generator,
                                       compute_dtype)
        self.BatchNorm_0 = (BatchNorm(features) if normalization == "batch"
                            else None)
        self.compute_dtype = compute_dtype
        self.act = activation_fn(activation)

    def forward(self, *xs: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(*xs)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        return self.act(x)


def _add_layers(module: nn.Module, layers: Sequence[nn.Module]) -> None:
    for i, layer in enumerate(layers):
        module.add_module(f"PointLayer_{i}", layer)


class PointNetMLP(nn.Module):
    """Stack of PointLayers; the last has no activation or normalization."""

    def __init__(self, in_features: int, out_channels: Sequence[int],
                 generator: torch.Generator, activation: str = "relu",
                 normalization: Optional[str] = "batch",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        n = len(out_channels)
        layers, cin = [], in_features
        for i, c in enumerate(out_channels):
            last = i == n - 1
            layers.append(PointLayer(
                cin, c, generator, activation=None if last else activation,
                normalization=None if last else normalization,
                compute_dtype=compute_dtype))
            cin = c
        _add_layers(self, layers)
        self.n = n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"PointLayer_{i}")(x)
        return x


class PointResNet(nn.Module):
    """First-layer-skip residual MLP: the last layer consumes
    concat(out0, out[-2]) and has no activation or normalization."""

    def __init__(self, in_features: int, out_channels: Sequence[int],
                 generator: torch.Generator, activation: str = "relu",
                 normalization: Optional[str] = "batch",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype)
        layers = [PointLayer(in_features, out_channels[0], generator,
                             activation, normalization, **kw)]
        cin = out_channels[0]
        for c in out_channels[1:-1]:
            layers.append(PointLayer(cin, c, generator, activation,
                                     normalization, **kw))
            cin = c
        layers.append(PointLayer((out_channels[0], cin), out_channels[-1],
                                 generator, None, None, **kw))
        _add_layers(self, layers)
        self.n = len(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out0 = self.PointLayer_0(x)
        h = out0
        for i in range(1, self.n - 1):
            h = getattr(self, f"PointLayer_{i}")(h)
        return getattr(self, f"PointLayer_{self.n - 1}")(out0, h)


class KNNModule(nn.Module):
    """kNN aggregation over SOM nodes: gather K neighbours per node,
    decenter their coordinates, shared MLP over (B, M, K, C'), max over K.
    Every layer keeps its activation and normalization."""

    def __init__(self, coord_dim: int, in_features: int,
                 out_channels: Sequence[int], generator: torch.Generator,
                 activation: str = "relu",
                 normalization: Optional[str] = "batch",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        layers, cin = [], coord_dim + in_features
        for c in out_channels:
            layers.append(PointLayer(cin, c, generator, activation,
                                     normalization, compute_dtype))
            cin = c
        _add_layers(self, layers)
        self.n = len(layers)

    def forward(self, coordinate: torch.Tensor, x: torch.Tensor,
                knn_idx: torch.Tensor, center_type: str = "avg"):
        """coordinate (B, M, D); x (B, M, C); knn_idx (B, M, K).
        Returns (neighbours' center (B, M, D), feature (B, M, out[-1]))."""
        neighbors = knn_gather(coordinate, knn_idx)       # (B, M, K, D)
        if center_type == "avg":
            center = neighbors.mean(2, keepdim=True)
        elif center_type == "center":
            center = coordinate[:, :, None, :]
        else:
            raise ValueError(f"center_type={center_type!r}")
        decentered = neighbors - center
        x_neighbors = knn_gather(x, knn_idx)              # (B, M, K, C)
        dt = torch.promote_types(decentered.dtype, x_neighbors.dtype)
        h = torch.cat([decentered.to(dt), x_neighbors.to(dt)], -1)
        for i in range(self.n):
            h = getattr(self, f"PointLayer_{i}")(h)
        return center.squeeze(2), h.amax(2)
