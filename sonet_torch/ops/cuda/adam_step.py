"""One Adam update of a train step's parameters: the plain version
``adam_step_plain`` and the CUDA kernel ``csrc/adam_step.cu`` behind the
same function.

``adam_step`` updates each parameter, its ``exp_avg`` and its
``exp_avg_sq`` in place and advances its step counter once, by the
arithmetic of ``torch.optim.Adam(foreach=True, capturable=True)`` without
weight decay, amsgrad or maximize: the moments by ``lerp`` and by ``mul``
then ``addcmul``; the bias corrections from the counter after its
increment, in float32 (``pow``, ``- 1``, ``/ lr``, reciprocal; ``pow``,
``- 1``, negation, ``sqrt``; ATen's foreach division by a Python number
is a product with its reciprocal, taken in double); the denominator
``(sqrt(v) / bc2_sqrt + eps) / step_size``; then ``p += m / denom``.  On a card the kernel rounds every
step as ATen's functors do, so it gives that Adam's bits; on the CPU the
plain version runs the same ops one tensor at a time.  Any other device,
or a mix, raises; it never falls back.  ``adam_step.launches`` counts the
CUDA calls (in a CUDA graph, its capture), one a call whatever the number
of tensors.

A step counter is a 0-dim float32 tensor: on the parameters' device, where
the kernel reads it and advances it on the card (a capturable Adam's), or
on the CPU, where it is advanced on the host before the launch and its new
value passed (an eager Adam's); a call with host counters cannot be
captured in a graph, and raises there.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from . import launcher, same_device

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_kernel = launcher("adam_step", "sonet_adam_step",
                   [_i, _p, _p, _p, _p, _f, _f, _f, _f, _f, _i, _p])

Tensors = Sequence[torch.Tensor]


def adam_step_plain(params: Tensors, grads: Tensors, exp_avgs: Tensors,
                    exp_avg_sqs: Tensors, steps: Tensors,
                    lrs: Sequence[float], betas: tuple[float, float],
                    eps: float) -> None:
    """The update of ``adam_step`` as torch ops, one tensor after another,
    in the capturable foreach chain's order (on the CPU, where ATen
    rounds some of them otherwise than its CUDA functors)."""
    beta1, beta2 = betas
    with torch.no_grad():
        for p, g, m, v, step, lr in zip(params, grads, exp_avgs, exp_avg_sqs,
                                        steps, lrs):
            step.add_(1)
            m.lerp_(g, 1 - beta1)
            v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
            step_size = ((torch.pow(beta1, step) - 1) * (1 / lr)
                         ).reciprocal()
            bc2_sqrt = (-(torch.pow(beta2, step) - 1)).sqrt()
            denom = v.sqrt().div_(bc2_sqrt.to(v.device)).add_(eps)
            p.addcdiv_(m, denom.div_(step_size.to(v.device)))


def _check(params, grads, exp_avgs, exp_avg_sqs, steps, lrs) -> None:
    """Raises on what the function does not take."""
    lists = (params, grads, exp_avgs, exp_avg_sqs, steps, lrs)
    if len({len(x) for x in lists}) != 1:
        raise ValueError("adam_step: params, grads, exp_avgs, exp_avg_sqs, "
                         f"steps and lrs of lengths {[len(x) for x in lists]}")
    for i, (p, g, m, v, step) in enumerate(zip(*lists[:5])):
        for name, t in (("param", p), ("grad", g), ("exp_avg", m),
                        ("exp_avg_sq", v), ("step", step)):
            if t.dtype != torch.float32:
                raise TypeError(f"adam_step: {name} {i} dtype {t.dtype}, "
                                "want float32")
        if not g.shape == m.shape == v.shape == p.shape:
            raise ValueError(f"adam_step: tensor {i}: param "
                             f"{tuple(p.shape)}, grad {tuple(g.shape)}, "
                             f"exp_avg {tuple(m.shape)}, exp_avg_sq "
                             f"{tuple(v.shape)}; want one shape")
        if not all(t.is_contiguous() for t in (p, g, m, v)):
            raise ValueError(f"adam_step: tensor {i} is not contiguous")
        if step.dim() != 0:
            raise ValueError(f"adam_step: step {i} of shape "
                             f"{tuple(step.shape)}; want a 0-dim counter")
        if p.numel() >= 2 ** 31:
            raise ValueError(f"adam_step: tensor {i} of {p.numel()} "
                             "elements, out of the kernel's range")
        same_device("adam_step", param=p, grad=g, exp_avg=m, exp_avg_sq=v,
                    **({} if step.device.type == "cpu" else {"step": step}))
        if p.device != params[0].device:
            raise ValueError(f"adam_step: param {i} on {p.device}, param 0 "
                             f"on {params[0].device}; all must be on one "
                             "device")


def adam_step(params: Tensors, grads: Tensors, exp_avgs: Tensors,
              exp_avg_sqs: Tensors, steps: Tensors, lrs: Sequence[float],
              betas: tuple[float, float], eps: float) -> None:
    """One Adam update, in place, of each ``params[i]`` (float32,
    contiguous) from ``grads[i]``, with its moments ``exp_avgs[i]`` and
    ``exp_avg_sqs[i]`` (the parameter's shape and device) and its 0-dim
    float32 counter ``steps[i]`` (advanced once), at the rate ``lrs[i]``,
    with ``betas`` and ``eps`` shared by all: on a CUDA device the kernel,
    every tensor in one launch; on the CPU the plain version."""
    _check(params, grads, exp_avgs, exp_avg_sqs, steps, lrs)
    if not params:
        return
    dev = params[0].device
    if dev.type == "cpu":
        adam_step_plain(params, grads, exp_avgs, exp_avg_sqs, steps, lrs,
                        betas, eps)
        return
    host = [s.device.type == "cpu" for s in steps]
    if any(host) and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("adam_step: step counters on the host in a CUDA "
                           "graph capture (the graph would keep their values "
                           "of the capture); make the optimizer capturable")
    host_t = np.zeros(len(steps), dtype=np.float32)
    for j, (step, on_host) in enumerate(zip(steps, host)):
        if on_host:
            step.add_(1)
            host_t[j] = float(step)
    ptrs = np.array([[p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                      0 if on_host else s.data_ptr()]
                     for p, g, m, v, s, on_host in zip(
                         params, grads, exp_avgs, exp_avg_sqs, steps, host)],
                    dtype=np.int64)
    numel = np.array([p.numel() for p in params], dtype=np.int64)
    inv_lr = np.array([1 / lr for lr in lrs], dtype=np.float32)
    # ATen takes each Python scalar of the chain to float32 as these do
    beta1, beta2 = betas
    consts = (np.float32(beta1), np.float32(beta2), np.float32(1 - beta1),
              np.float32(1 - beta2), np.float32(eps))
    stream = torch.cuda.current_stream(dev).cuda_stream
    _kernel(len(params), ptrs.ctypes.data, numel.ctypes.data,
            inv_lr.ctypes.data, host_t.ctypes.data,
            *(float(c) for c in consts), dev.index, stream)
    torch.autograd.graph.increment_version(
        [*params, *exp_avgs, *exp_avg_sqs,
         *(s for s, on_host in zip(steps, host) if not on_host)])
    adam_step.launches += 1


adam_step.launches = 0
