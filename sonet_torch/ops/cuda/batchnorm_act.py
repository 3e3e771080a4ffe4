"""BatchNorm over the trailing channel axis fused with the bias add before
it and the activation after it: the CUDA kernels ``csrc/batchnorm_act.cu``
behind three registered operators, plus their plain PyTorch versions.

``y`` is a dense layer's product before its bias (any leading shape,
channel-last), ``bias`` that layer's bias in ``y``'s type or None; the
layer's output was ``h = y + bias``.  Each operator computes what
``nn.layers.BatchNorm`` computes from ``h``, and the ReLU after it when
``relu`` is set:

- ``sonet_torch::batchnorm_act_train(y, bias, weight, beta, eps, relu,
  axes) -> (out, mean, var)``: batch statistics (the biased variance,
  two-pass below ``TWO_PASS_BELOW`` rows, one-pass from there on), summed
  over the mesh ``axes`` in effect (``parallel.collectives``);
- ``sonet_torch::batchnorm_act_eval(y, bias, weight, beta, mean, var, eps,
  relu) -> out``: given (running) statistics;
- ``sonet_torch::batchnorm_act_backward(g, y, bias, weight, beta, mean,
  var, eps, relu, train, axes) -> (dy, dweight, dbeta)``: the backward of
  either, the autograd formula of the other two.  ``bias`` gets no
  gradient (a BatchNorm after it cancels it: ``Dense.stop_bias_grad``).

Each has a CPU implementation (the plain version), a CUDA one (the
kernels) and a fake one, so ``torch.export`` keeps the served forward's
BatchNorms as ``batchnorm_act_eval`` nodes.  The checked entry points
``batchnorm_act_train`` / ``batchnorm_act_eval`` take the plain version
only for tensors on the CPU; for CUDA tensors the operators launch the
kernels or raise, and never fall back.  ``launches`` counts the CUDA
calls by mode (``"train"``, ``"eval"``, ``"backward"``; in a CUDA graph,
its capture): a call is one kernel launch (eval), three (backward, and
train from 8,192 rows) or five (train below).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...parallel import collectives
from . import DTYPE_CODE, launcher, same_device

# the variance is two-pass below this many rows (of the whole mesh),
# one-pass E[h^2] - E[h]^2 from there on, as in the JAX package
TWO_PASS_BELOW = 8192
_WIDTH_MULTIPLE = 8         # a 16-byte vector of bf16; two of float32
launches = {"train": 0, "eval": 0, "backward": 0}


# ---------------------------------------------------------------------------
# plain versions

def _ranks(axes) -> int:
    return math.prod(collectives.axis_size(a) for a in axes)


def _biased(y, bias):
    return y if bias is None else y + bias


def batch_stats(xf, axes, reduce):
    """(mean, biased variance) over the rows of the float ``xf`` (..., C)
    and the mesh ``axes`` in effect: two-pass below ``TWO_PASS_BELOW``
    rows of the whole mesh, one-pass from there on.  ``reduce(t, axes)``
    sums over the ranks: ``collectives.sum_over`` where autograd must see
    the sum, ``collectives.all_reduce`` where it need not."""
    rows = tuple(range(xf.dim() - 1))
    ranks = _ranks(axes)
    n = math.prod(xf.shape[:-1]) * ranks
    if ranks == 1:
        mean = xf.mean(rows)
        if n < TWO_PASS_BELOW:
            return mean, (xf - mean).square().mean(rows)
        return mean, xf.square().mean(rows) - mean.square()
    if n < TWO_PASS_BELOW:
        mean = reduce(xf.sum(rows), axes) / n
        return mean, reduce((xf - mean).square().sum(rows), axes) / n
    sums = reduce(torch.stack([xf.sum(rows), xf.square().sum(rows)]),
                  axes) / n
    return sums[0], sums[1] - sums[0].square()


def normalised(xf, mean, var, weight, beta, eps: float, dtype):
    """The float ``xf`` normalised with the statistics, the affine map,
    rounded to ``dtype``."""
    return ((xf - mean) * torch.rsqrt(var + eps) * weight + beta).to(dtype)


def batchnorm_act_train_plain(y, bias, weight, beta, eps: float, relu: bool,
                              axes=("data",)):
    """(out, mean, var) with the batch statistics, as ``BatchNorm``'s
    training forward computes them from ``y + bias``."""
    x = _biased(y, bias)
    xf = x.float()
    mean, var = batch_stats(xf, axes, collectives.all_reduce)
    out = normalised(xf, mean, var, weight, beta, eps, x.dtype)
    return (torch.relu(out) if relu else out), mean, var


def batchnorm_act_eval_plain(y, bias, weight, beta, mean, var, eps: float,
                             relu: bool):
    """``BatchNorm``'s forward with the given statistics."""
    x = _biased(y, bias)
    out = normalised(x.float(), mean, var, weight, beta, eps, x.dtype)
    return torch.relu(out) if relu else out


def batchnorm_act_backward_plain(g, y, bias, weight, beta, mean, var,
                                 eps: float, relu: bool, train: bool,
                                 axes=("data",)):
    """(dy, dweight, dbeta) from the output's cotangent ``g``: the
    normalised value and the ReLU's mask recomputed from ``y``; in
    training, dy = weight * rstd * (gz - (sum gz + xhat * sum gz xhat) / n)
    with the sums over the mesh; with given statistics, weight * rstd * gz.
    The parameters' gradients are this rank's sums."""
    x = _biased(y, bias)
    rstd = torch.rsqrt(var + eps)
    xhat = (x.float() - mean) * rstd
    gz = g.float()
    if relu:
        z = (xhat * weight + beta).to(x.dtype)
        gz = torch.where(z <= 0, torch.zeros_like(gz), gz)
    rows = tuple(range(x.dim() - 1))
    dbeta = gz.sum(rows)
    dweight = (gz * xhat).sum(rows)
    if train:
        n = math.prod(x.shape[:-1]) * _ranks(axes)
        tot = collectives.all_reduce(torch.stack([dbeta, dweight]), axes)
        dx = weight * rstd * (gz - (tot[0] + xhat * tot[1]) / n)
    else:
        dx = gz * (weight * rstd)
    return dx.to(x.dtype), dweight, dbeta


# ---------------------------------------------------------------------------
# the kernels

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_partials_of = launcher("batchnorm_act", "sonet_batchnorm_partials",
                        [_i, _i, _i, _i], query=True)
_stats_kernel = launcher("batchnorm_act", "sonet_batchnorm_stats",
                         [_p, _i, _p, _i, _i, _p, _p, _f, _p, _p, _i, _p])
_apply_kernel = launcher("batchnorm_act", "sonet_batchnorm_apply",
                         [_p, _i, _p, _i, _i, _p, _p, _p, _p, _f, _i, _p, _i,
                          _p])
_backward_sums = launcher("batchnorm_act", "sonet_batchnorm_backward_sums",
                          [_p, _p, _i, _p, _i, _i, _p, _p, _p, _p, _f, _i, _p,
                           _p, _p, _i, _p])
_backward_dx = launcher("batchnorm_act", "sonet_batchnorm_backward_dx",
                        [_p, _p, _i, _p, _i, _i, _p, _p, _p, _p, _f, _i, _p,
                         _p, _f, _p, _i, _p])


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(y, bias, weight, beta, mean=None, var=None):
    """Raises on what the kernels do not take."""
    if y.dtype not in DTYPE_CODE:
        raise TypeError(f"batchnorm_act: y dtype {y.dtype}, want float32 "
                        "or bfloat16")
    C = y.shape[-1] if y.dim() else 0
    if y.dim() < 2 or C % _WIDTH_MULTIPLE or C == 0:
        raise ValueError(f"batchnorm_act: y {tuple(y.shape)}; want (..., C) "
                         f"with C a multiple of {_WIDTH_MULTIPLE} (on the "
                         "card a BatchNorm of another width is refused)")
    if y.numel() == 0 or y.numel() // C >= 2 ** 31:
        raise ValueError(f"batchnorm_act: {y.numel() // C} rows, want 1 to "
                         "2^31 - 1")
    if not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError("batchnorm_act: y must be contiguous and 16-byte "
                         "aligned")
    if bias is not None and (bias.dtype != y.dtype
                             or tuple(bias.shape) != (C,)
                             or not bias.is_contiguous()):
        raise ValueError(f"batchnorm_act: bias {tuple(bias.shape)} "
                         f"{bias.dtype}; want ({C},) {y.dtype}, contiguous")
    for v in (weight, beta, mean, var):
        if v is not None and (v.dtype != torch.float32
                              or tuple(v.shape) != (C,)
                              or not v.is_contiguous()):
            raise ValueError(f"batchnorm_act: a per-channel vector "
                             f"{tuple(v.shape)} {v.dtype}; want ({C},) "
                             "float32, contiguous")
    same_device("batchnorm_act", y=y, bias=bias, weight=weight, beta=beta,
                mean=mean, var=var)


def _partials(y):
    C = y.shape[-1]
    R = y.numel() // C
    G = _partials_of(R, C, DTYPE_CODE[y.dtype], y.device.index)
    return torch.empty((G, 2, C), dtype=torch.float32, device=y.device)


def _head(y):
    """(R, C, dtype code, device index, stream) of a launch on ``y``."""
    C = y.shape[-1]
    stream = torch.cuda.current_stream(y.device).cuda_stream
    return (y.numel() // C, C, DTYPE_CODE[y.dtype], y.device.index, stream)


def _stats(y, bias, center, part, n, out0, out1):
    R, C, code, dev, stream = _head(y)
    _stats_kernel(y.data_ptr(), code, _ptr(bias), R, C, _ptr(center),
                  part.data_ptr(), float(n), _ptr(out0), out1.data_ptr(), dev,
                  stream)


def _apply(y, bias, weight, beta, mean, var, eps, relu):
    R, C, code, dev, stream = _head(y)
    out = torch.empty_like(y)
    _apply_kernel(y.data_ptr(), code, _ptr(bias), R, C, mean.data_ptr(),
                  var.data_ptr(), weight.data_ptr(), beta.data_ptr(),
                  float(eps), int(relu), out.data_ptr(), dev, stream)
    return out


def _train_cuda(y, bias, weight, beta, eps, relu, axes):
    _check(y, bias, weight, beta)
    C = y.shape[-1]
    ranks = _ranks(axes)
    n = y.numel() // C * ranks
    part = _partials(y)
    vec = dict(dtype=torch.float32, device=y.device)
    if ranks == 1:
        mean, var = torch.empty(C, **vec), torch.empty(C, **vec)
        _stats(y, bias, None, part, n, mean, var)
        if n < TWO_PASS_BELOW:
            _stats(y, bias, mean, part, n, None, var)
    else:
        sums = torch.empty((2, C), **vec)
        _stats(y, bias, None, part, 0, sums[0], sums[1])
        sums = collectives.all_reduce(sums, axes) / n
        mean = sums[0].clone()
        if n < TWO_PASS_BELOW:
            dev = torch.empty(C, **vec)
            _stats(y, bias, mean, part, 0, None, dev)
            var = collectives.all_reduce(dev, axes) / n
        else:
            var = sums[1] - mean.square()
    out = _apply(y, bias, weight, beta, mean, var, eps, relu)
    launches["train"] += 1
    return out, mean, var


def _eval_cuda(y, bias, weight, beta, mean, var, eps, relu):
    _check(y, bias, weight, beta, mean, var)
    out = _apply(y, bias, weight, beta, mean, var, eps, relu)
    launches["eval"] += 1
    return out


def _backward_cuda(g, y, bias, weight, beta, mean, var, eps, relu, train,
                   axes):
    _check(y, bias, weight, beta, mean, var)
    g = g.contiguous()
    if g.dtype != y.dtype or g.shape != y.shape:
        raise ValueError(f"batchnorm_act: cotangent {tuple(g.shape)} "
                         f"{g.dtype}, want {tuple(y.shape)} {y.dtype}")
    R, C, code, dev, stream = _head(y)
    part = _partials(y)
    dbeta = torch.empty(C, dtype=torch.float32, device=y.device)
    dweight = torch.empty_like(dbeta)
    _backward_sums(g.data_ptr(), y.data_ptr(), code, _ptr(bias), R, C,
                   mean.data_ptr(), var.data_ptr(), weight.data_ptr(),
                   beta.data_ptr(), float(eps), int(relu), part.data_ptr(),
                   dbeta.data_ptr(), dweight.data_ptr(), dev, stream)
    sum_gz, sum_gzx, n = dbeta, dweight, 0
    if train:
        ranks = _ranks(axes)
        n = R * ranks
        if ranks > 1:
            tot = collectives.all_reduce(torch.stack([dbeta, dweight]), axes)
            sum_gz, sum_gzx = tot[0], tot[1]
    dy = torch.empty_like(y)
    _backward_dx(g.data_ptr(), y.data_ptr(), code, _ptr(bias), R, C,
                 mean.data_ptr(), var.data_ptr(), weight.data_ptr(),
                 beta.data_ptr(), float(eps), int(relu), sum_gz.data_ptr(),
                 sum_gzx.data_ptr(), float(n), dy.data_ptr(), dev, stream)
    launches["backward"] += 1
    return dy, dweight, dbeta


# ---------------------------------------------------------------------------
# the operators

_VEC = "Tensor weight, Tensor beta"


@torch.library.custom_op(
    "sonet_torch::batchnorm_act_train", mutates_args=(), device_types="cpu",
    schema=f"(Tensor y, Tensor? bias, {_VEC}, float eps, bool relu, "
           "str[] axes) -> (Tensor, Tensor, Tensor)")
def _train_op(y, bias, weight, beta, eps, relu, axes):
    out, mean, var = batchnorm_act_train_plain(y, bias, weight, beta, eps,
                                               relu, axes)
    return out, mean.clone(), var.clone()


@_train_op.register_fake
def _(y, bias, weight, beta, eps, relu, axes):
    C = y.shape[-1]
    return (torch.empty_like(y), y.new_empty(C, dtype=torch.float32),
            y.new_empty(C, dtype=torch.float32))


_train_op.register_kernel("cuda")(_train_cuda)


@torch.library.custom_op(
    "sonet_torch::batchnorm_act_eval", mutates_args=(), device_types="cpu",
    schema=f"(Tensor y, Tensor? bias, {_VEC}, Tensor mean, Tensor var, "
           "float eps, bool relu) -> Tensor")
def _eval_op(y, bias, weight, beta, mean, var, eps, relu):
    return batchnorm_act_eval_plain(y, bias, weight, beta, mean, var, eps,
                                    relu)


@_eval_op.register_fake
def _(y, bias, weight, beta, mean, var, eps, relu):
    return torch.empty_like(y)


_eval_op.register_kernel("cuda")(_eval_cuda)


@torch.library.custom_op(
    "sonet_torch::batchnorm_act_backward", mutates_args=(),
    device_types="cpu",
    schema=f"(Tensor g, Tensor y, Tensor? bias, {_VEC}, Tensor mean, "
           "Tensor var, float eps, bool relu, bool train, str[] axes) -> "
           "(Tensor, Tensor, Tensor)")
def _backward_op(g, y, bias, weight, beta, mean, var, eps, relu, train, axes):
    return batchnorm_act_backward_plain(g, y, bias, weight, beta, mean, var,
                                        eps, relu, train, axes)


@_backward_op.register_fake
def _(g, y, bias, weight, beta, mean, var, eps, relu, train, axes):
    C = y.shape[-1]
    return (torch.empty_like(y), y.new_empty(C, dtype=torch.float32),
            y.new_empty(C, dtype=torch.float32))


_backward_op.register_kernel("cuda")(_backward_cuda)


def _setup_train(ctx, inputs, output):
    y, bias, weight, beta, eps, relu, axes = inputs
    _, mean, var = output
    ctx.save_for_backward(y, bias, weight, beta, mean, var)
    ctx.args = (eps, relu, True, list(axes))
    ctx.mark_non_differentiable(mean, var)


def _setup_eval(ctx, inputs, output):
    y, bias, weight, beta, mean, var, eps, relu = inputs
    ctx.save_for_backward(y, bias, weight, beta, mean, var)
    ctx.args = (eps, relu, False, [])


def _backward(ctx, g, *_):
    y, bias, weight, beta, mean, var = ctx.saved_tensors
    dy, dweight, dbeta = torch.ops.sonet_torch.batchnorm_act_backward(
        g, y, bias, weight, beta, mean, var, *ctx.args)
    return dy, None, dweight, dbeta


_train_op.register_autograd(
    lambda ctx, g, *_: (*_backward(ctx, g), None, None, None),
    setup_context=_setup_train)
_eval_op.register_autograd(
    lambda ctx, g: (*_backward(ctx, g), None, None, None, None),
    setup_context=_setup_eval)


# ---------------------------------------------------------------------------
# checked entry points

def _devices(y, bias, weight, beta, mean=None, var=None):
    """The entry points' checks: one device for every tensor (``_check``
    has the same check, but the dispatcher hands a mix with the CPU or
    ``meta`` to the plain or the fake version, never to ``_check``), and
    no gradient asked of the bias."""
    same_device("batchnorm_act", y=y, bias=bias, weight=weight, beta=beta,
                mean=mean, var=var)
    if bias is not None and bias.requires_grad and torch.is_grad_enabled():
        raise ValueError("batchnorm_act: the bias gets no gradient here; "
                         "pass it detached (Dense.stop_bias_grad)")


def batchnorm_act_train(y, bias, weight, beta, eps: float, relu: bool,
                        axes=("data",)):
    """(out, mean, var): ``y + bias`` normalised with its batch statistics
    (over the mesh ``axes``), the affine map, the ReLU if ``relu``; out in
    ``y``'s type, mean and the biased var float32 (no gradient)."""
    _devices(y, bias, weight, beta)
    return torch.ops.sonet_torch.batchnorm_act_train(
        y, bias, weight, beta, float(eps), bool(relu), list(axes))


def batchnorm_act_eval(y, bias, weight, beta, mean, var, eps: float,
                       relu: bool):
    """``y + bias`` normalised with the given statistics, the affine map,
    the ReLU if ``relu``; in ``y``'s type."""
    _devices(y, bias, weight, beta, mean, var)
    return torch.ops.sonet_torch.batchnorm_act_eval(
        y, bias, weight, beta, mean, var, float(eps), bool(relu))
