"""Reusable network blocks, channel-last (port of the JAX package's
``nn/layers.py``).

Shared MLPs are dense layers over the trailing channel axis of
``(B, N, C)``.  Submodules carry the JAX package's parameter names
(``PointLayer_0``, ``Dense_0``, ``BatchNorm_0``, ...) so that
``convert.py`` maps one tree onto the other by path.

Precision follows the JAX package: with a ``compute_dtype`` (bf16), the
input, kernel and bias are cast to it before the matmul and the bias add;
BatchNorm normalises in float32 and casts back to the input's dtype.
Parameters and BatchNorm statistics stay float32.

Train or eval follows ``nn.Module.training``.  In training, BatchNorm
normalises with the batch statistics and updates its running ones with
torch-convention momentum and the reference's epoch momentum decay, and
the bias of a dense layer that a BatchNorm follows gets no gradient
(``stop_bias_grad``).

``UpConv`` (the autoencoder's decoder) keeps the JAX package's NHWC
interface; inside, the 3x3 convolution sees the same memory as an NCHW
tensor in ``channels_last`` format, so no copy is made for the layout.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda import batchnorm_act
from ..ops.gather import knn_gather
from ..parallel import collectives


_RECOMPUTE = threading.local()


@contextlib.contextmanager
def recomputation():
    """Marks a forward that rematerialisation runs a second time, in the
    backward (``torch.utils.checkpoint``'s ``context_fn``; the encoder's
    ``cfg.remat``): BatchNorm leaves its running statistics alone there,
    so a step updates them once, as flax's ``nn.remat`` does.  The mark
    is per thread: the recomputation runs on the thread of the backward
    that asks for it."""
    before = getattr(_RECOMPUTE, "on", False)
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = before


def recomputing() -> bool:
    """Whether this thread runs inside ``recomputation()``."""
    return getattr(_RECOMPUTE, "on", False)


def fused(x: torch.Tensor) -> bool:
    """Whether ``BatchNorm`` runs ``x`` through the fused CUDA kernels:
    every CUDA tensor (the kernels raise on what they do not take)."""
    return x.is_cuda


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


def _he_normal_(weight: torch.Tensor, fan: int,
                generator: torch.Generator) -> None:
    with torch.no_grad():
        weight.copy_(torch.randn(weight.shape, generator=generator)
                     * math.sqrt(2.0 / fan))


def he_normal_in_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """normal(0, sqrt(2 / fan_in)) in place; ``weight`` is (out, in)."""
    _he_normal_(weight, weight.shape[1], generator)


def he_normal_out_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """normal(0, sqrt(2 / fan_out)) in place, for a convolution kernel
    ``weight`` (out, in, kh, kw): fan_out = out * kh * kw (UpConv's init,
    which the reference scales by the output channels)."""
    _he_normal_(weight, weight.shape[0] * math.prod(weight.shape[2:]),
                generator)


class Dense(nn.Module):
    """x @ kernel + bias over the trailing axis.  ``weight`` is (out, in),
    the transpose of the JAX package's ``kernel``.

    ``stop_bias_grad``: the bias gets no gradient (the JAX package's
    ``DenseBN``).  A BatchNorm that follows subtracts the batch mean, which
    cancels a per-channel bias exactly, so its true gradient is 0; autograd
    would still give it summation noise, which Adam turns into steps of
    about lr.  The forward add stays: eval-mode BatchNorm uses running
    statistics, where the bias is live."""

    def __init__(self, in_features: int, features: int,
                 generator: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None,
                 stop_bias_grad: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.stop_bias_grad = stop_bias_grad
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))
        he_normal_in_(self.weight, generator)

    def _params(self, dtype: torch.dtype):
        b = self.bias.detach() if self.stop_bias_grad else self.bias
        return self.weight.to(dtype), b.to(dtype)

    def product(self, x: torch.Tensor):
        """(x @ kernel, bias), both in the compute dtype: the output before
        its bias add, for a BatchNorm that adds the bias itself."""
        # without a compute dtype the operands promote, as in the JAX
        # package (a bf16 input to a float32 layer runs in float32)
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        w, b = self._params(dt)
        return F.linear(x.to(dt), w), b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, b = self.product(x)
        return y + b


class ConcatDense(Dense):
    """Dense over the concatenation of several inputs, computed as one
    sliced matmul per input plus a sum; the (sum C_i, F) kernel is one
    matrix, as in the JAX package.

    Rank-2 inputs ``(B, C_i)`` among rank-3 ones are broadcast along the
    points (the segmenter's global feature and label one-hot): their
    matmul runs at ``(B, C_i)`` and its result is broadcast-added, so
    neither the ``(B, N, C_i)`` copies nor their N-fold redundant products
    exist."""

    def __init__(self, in_features: Sequence[int], features: int,
                 generator: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None,
                 stop_bias_grad: bool = False):
        super().__init__(sum(in_features), features, generator, compute_dtype,
                         stop_bias_grad)
        self.splits = tuple(in_features)

    def product(self, *xs: torch.Tensor):
        """(the sum of the sliced products, bias), as ``Dense.product``."""
        dt = self.compute_dtype or torch.float32
        w, b = self._params(dt)
        out_rank = max(x.dim() for x in xs)
        y = None
        off = 0
        for x, c in zip(xs, self.splits):
            part = F.linear(x.to(dt), w[:, off:off + c])
            for _ in range(out_rank - x.dim()):      # broadcast along points
                part = part.unsqueeze(1)
            y = part if y is None else y + part
            off += c
        return y, b

    def forward(self, *xs: torch.Tensor) -> torch.Tensor:
        y, b = self.product(*xs)
        return y + b


class BatchNorm(nn.Module):
    """BatchNorm over the trailing channel axis, with the running
    statistics as buffers and the reference's epoch momentum decay.

    Training: biased batch variance, two-pass below ``TWO_PASS_BELOW``
    (8192) reduced rows (stable where mean^2 >> var) and one-pass
    E[x^2] - E[x]^2 from there on (one read of the input), as in the JAX
    package (``ops.cuda.batchnorm_act.batch_stats``); running statistics
    ``r = (1 - m) r + m batch`` with the unbiased variance, where
    ``m = max(momentum * decay^(epoch // step), 0.01)`` from epoch 1 on when
    ``momentum_decay_step`` is set, else ``momentum``; not inside
    ``recomputation()``, the second forward of a rematerialised block.

    Under a mesh (``parallel.collectives.use_mesh``) the training
    statistics are the global ones, as GSPMD computes them for the JAX
    package: the sums are all-reduced over ``data`` and, for a layer on
    each rank's points (``sharded_points``), over ``points`` too; the row
    count ``n`` (and with it the two-pass / one-pass choice) is the
    global one.  Two-pass takes a second all-reduce.  Every rank then
    updates its running statistics with the same values.

    The layers call ``normalise(y, epoch, bias, activation)``: this
    module on ``y + bias`` (a dense layer's product and its bias; ``y``
    alone without one), then the named activation.  On a CUDA tensor
    that whole chain runs as the fused kernels of ``ops.cuda.batchnorm_act``
    (the ReLU inside them; another activation after them), with the same
    rounding points: the bias add rounded to ``y``'s type, statistics and
    normalisation in float32, the output rounded to ``y``'s type.  The
    kernels take float32 or bf16 of a width that is a multiple of 8 and
    raise on anything else; there is no second path on the card.  On the
    CPU it runs as ``forward`` and the activation."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1,
                 momentum_decay_step: Optional[int] = None,
                 momentum_decay: float = 0.6, sharded_points: bool = False):
        super().__init__()
        self.eps = eps
        self.sharded_points = sharded_points
        self.momentum = momentum
        self.momentum_decay_step = momentum_decay_step
        self.momentum_decay = momentum_decay
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def momentum_at(self, epoch: Optional[int]) -> float:
        """The running-statistics momentum during ``epoch``."""
        step = self.momentum_decay_step
        if step is None or step <= 0 or epoch is None or epoch < 1:
            return self.momentum
        return max(self.momentum * self.momentum_decay ** (epoch // step),
                   0.01)

    def forward(self, x: torch.Tensor,
                epoch: Optional[int] = None) -> torch.Tensor:
        xf = x.float()
        if self.training:
            # the sums seen by autograd: the CPU's backward needs them
            mean, var = batchnorm_act.batch_stats(xf, self.mesh_axes,
                                                  collectives.sum_over)
            if not recomputing():
                self._update_running(mean, var, self._rows(x), epoch)
        else:
            mean, var = self.running_mean, self.running_var
        return batchnorm_act.normalised(xf, mean, var, self.weight, self.bias,
                                        self.eps, x.dtype)

    def normalise(self, y: torch.Tensor, epoch: Optional[int] = None,
                  bias: Optional[torch.Tensor] = None,
                  activation: Optional[str] = None) -> torch.Tensor:
        """The named activation of this BatchNorm of ``y + bias``."""
        if fused(y):
            return self._fused(y, epoch, bias, activation)
        return activation_fn(activation)(
            self(y if bias is None else y + bias, epoch))

    def _fused(self, x, epoch, bias, activation):
        relu = activation == "relu"
        if self.training:
            out, mean, var = batchnorm_act.batchnorm_act_train(
                x, bias, self.weight, self.bias, self.eps, relu,
                self.mesh_axes)
            if not recomputing():
                self._update_running(mean, var, self._rows(x), epoch)
        else:
            out = batchnorm_act.batchnorm_act_eval(
                x, bias, self.weight, self.bias, self.running_mean,
                self.running_var, self.eps, relu)
        return out if relu else activation_fn(activation)(out)

    @property
    def mesh_axes(self) -> tuple:
        """The mesh axes the training statistics are summed over."""
        return ("data", "points") if self.sharded_points else ("data",)

    def _rows(self, x: torch.Tensor) -> int:
        """The rows of ``x`` over the whole mesh: the statistics' count."""
        return math.prod(x.shape[:-1]) * math.prod(
            collectives.axis_size(a) for a in self.mesh_axes)

    @torch.no_grad()
    def _update_running(self, mean, var, n, epoch):
        m = self.momentum_at(epoch)
        unbiased = var * (n / max(n - 1, 1))
        self.running_mean.mul_(1.0 - m).add_(m * mean)
        self.running_var.mul_(1.0 - m).add_(m * unbiased)


class InstanceNorm(nn.Module):
    """Instance normalization over the point axes (all but the first and
    the last), per sample and channel: affine, no running statistics,
    float32 statistics with the biased variance.  A rank-2 input ``(B, C)``
    has nothing to normalise over and gets the affine map only."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() < 3:
            return x * self.weight + self.bias
        axes = tuple(range(1, x.dim() - 1))
        xf = x.float()
        mean = xf.mean(axes, keepdim=True)
        var = (xf - mean).square().mean(axes, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class PointLayer(nn.Module):
    """Dense -> [BatchNorm | InstanceNorm] -> [activation] over the trailing
    axis (``normalization`` is "batch", "instance" or None).  Given
    a sequence of input widths it acts on the virtual concatenation of as
    many inputs (``ConcatDense``).  ``momentum``, ``bn_momentum_decay_step``
    and ``bn_momentum_decay`` configure the BatchNorm.  ``sharded_points``
    marks a layer that runs on each rank's points under a mesh: its
    BatchNorm reduces over ``points`` too and its parameters' gradients
    are partial along ``points`` (``parallel.collectives.sync_grads``)."""

    def __init__(self, in_features: int | Sequence[int], features: int,
                 generator: torch.Generator,
                 activation: Optional[str] = "relu",
                 normalization: Optional[str] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 momentum: float = 0.1,
                 bn_momentum_decay_step: Optional[int] = None,
                 bn_momentum_decay: float = 0.6,
                 sharded_points: bool = False):
        super().__init__()
        if normalization not in (None, "batch", "instance"):
            raise NotImplementedError(f"normalization={normalization!r}")
        bn = normalization == "batch"
        self.sharded_points = sharded_points
        if isinstance(in_features, int):
            self.Dense_0 = Dense(in_features, features, generator,
                                 compute_dtype, stop_bias_grad=bn)
        else:
            self.Dense_0 = ConcatDense(in_features, features, generator,
                                       compute_dtype, stop_bias_grad=bn)
        self.BatchNorm_0 = (BatchNorm(features, momentum=momentum,
                                      momentum_decay_step=bn_momentum_decay_step,
                                      momentum_decay=bn_momentum_decay,
                                      sharded_points=sharded_points)
                            if bn else None)
        self.InstanceNorm_0 = (InstanceNorm(features)
                               if normalization == "instance" else None)
        self.compute_dtype = compute_dtype
        self.activation = activation
        self.act = activation_fn(activation)

    def forward(self, *xs: torch.Tensor,
                epoch: Optional[int] = None) -> torch.Tensor:
        if self.BatchNorm_0 is not None:
            # the bias (detached: stop_bias_grad) is added inside BatchNorm
            y, b = self.Dense_0.product(*xs)
            return self.BatchNorm_0.normalise(y, epoch, b, self.activation)
        x = self.Dense_0(*xs)
        if self.InstanceNorm_0 is not None:
            x = self.InstanceNorm_0(x)
        return self.act(x)


def _add_layers(module: nn.Module, layers: Sequence[nn.Module]) -> None:
    for i, layer in enumerate(layers):
        module.add_module(f"PointLayer_{i}", layer)


class PointNetMLP(nn.Module):
    """Stack of PointLayers; the last has no activation or normalization.
    ``bn_kw`` (``momentum``, ``bn_momentum_decay_step``,
    ``bn_momentum_decay``) goes to every PointLayer."""

    def __init__(self, in_features: int, out_channels: Sequence[int],
                 generator: torch.Generator, activation: str = "relu",
                 normalization: Optional[str] = "batch",
                 compute_dtype: Optional[torch.dtype] = None, **bn_kw):
        super().__init__()
        n = len(out_channels)
        layers, cin = [], in_features
        for i, c in enumerate(out_channels):
            last = i == n - 1
            layers.append(PointLayer(
                cin, c, generator, activation=None if last else activation,
                normalization=None if last else normalization,
                compute_dtype=compute_dtype, **bn_kw))
            cin = c
        _add_layers(self, layers)
        self.n = n

    def forward(self, x: torch.Tensor,
                epoch: Optional[int] = None) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"PointLayer_{i}")(x, epoch=epoch)
        return x


class PointResNet(nn.Module):
    """First-layer-skip residual MLP: the last layer consumes
    concat(out0, out[-2]) and has no activation or normalization."""

    def __init__(self, in_features: int, out_channels: Sequence[int],
                 generator: torch.Generator, activation: str = "relu",
                 normalization: Optional[str] = "batch",
                 compute_dtype: Optional[torch.dtype] = None, **bn_kw):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, **bn_kw)
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

    def forward(self, x: torch.Tensor,
                epoch: Optional[int] = None) -> torch.Tensor:
        out0 = self.PointLayer_0(x, epoch=epoch)
        h = out0
        for i in range(1, self.n - 1):
            h = getattr(self, f"PointLayer_{i}")(h, epoch=epoch)
        return getattr(self, f"PointLayer_{self.n - 1}")(out0, h, epoch=epoch)


class KNNModule(nn.Module):
    """kNN aggregation over SOM nodes: gather K neighbours per node,
    decenter their coordinates (no gradient), shared MLP over
    (B, M, K, C'), max over K.  Every layer keeps its activation and
    normalization."""

    def __init__(self, coord_dim: int, in_features: int,
                 out_channels: Sequence[int], generator: torch.Generator,
                 activation: str = "relu",
                 normalization: Optional[str] = "batch",
                 compute_dtype: Optional[torch.dtype] = None, **bn_kw):
        super().__init__()
        layers, cin = [], coord_dim + in_features
        for c in out_channels:
            layers.append(PointLayer(cin, c, generator, activation,
                                     normalization, compute_dtype, **bn_kw))
            cin = c
        _add_layers(self, layers)
        self.n = len(layers)

    def forward(self, coordinate: torch.Tensor, x: torch.Tensor,
                knn_idx: torch.Tensor, center_type: str = "avg",
                epoch: Optional[int] = None):
        """coordinate (B, M, D); x (B, M, C); knn_idx (B, M, K).
        Returns (neighbours' center (B, M, D), feature (B, M, out[-1]))."""
        coordinate = coordinate.detach()
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
            h = getattr(self, f"PointLayer_{i}")(h, epoch=epoch)
        return center.squeeze(2), h.amax(2)


class Conv3x3(nn.Module):
    """3x3 "SAME" convolution of an NHWC input.  ``weight`` is (out, in,
    3, 3), the JAX package's (3, 3, in, out) ``kernel`` permuted.  With a
    ``compute_dtype`` the input, kernel and bias are cast to it and the
    bias is added in it, as flax's ``nn.Conv(dtype=...)`` does."""

    def __init__(self, in_features: int, features: int,
                 generator: torch.Generator,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, 3, 3))
        self.bias = nn.Parameter(torch.full((features,), 0.001))
        he_normal_out_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        w = self.weight.to(dt, memory_format=torch.channels_last)
        # (B, H, W, C) memory read as NCHW in channels_last: a view
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), w, padding=1)
        return y.permute(0, 2, 3, 1) + self.bias.to(dt)


class UpConv(nn.Module):
    """2x nearest upsample -> 3x3 convolution -> [BatchNorm] ->
    [activation], NHWC in and out.  The kernel is drawn with the fan_out
    He scale and the bias starts at 0.001."""

    def __init__(self, in_features: int, features: int,
                 generator: torch.Generator,
                 activation: Optional[str] = "relu",
                 normalization: Optional[str] = "batch",
                 compute_dtype: Optional[torch.dtype] = None,
                 momentum: float = 0.1,
                 bn_momentum_decay_step: Optional[int] = None,
                 bn_momentum_decay: float = 0.6):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.Conv_0 = Conv3x3(in_features, features, generator, compute_dtype)
        self.BatchNorm_0 = (BatchNorm(features, momentum=momentum,
                                      momentum_decay_step=bn_momentum_decay_step,
                                      momentum_decay=bn_momentum_decay)
                            if normalization == "batch" else None)
        self.activation = activation
        self.act = activation_fn(activation)

    def forward(self, x: torch.Tensor,
                epoch: Optional[int] = None) -> torch.Tensor:
        """x (B, H, W, C) -> (B, 2H, 2W, features)."""
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        B, H, W, C = x.shape
        x = x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(
            B, 2 * H, 2 * W, C)                       # nearest 2x, one copy
        x = self.Conv_0(x)
        if self.BatchNorm_0 is not None:
            # the convolution's bias has a gradient: it is added before
            return self.BatchNorm_0.normalise(x, epoch,
                                              activation=self.activation)
        return self.act(x)
