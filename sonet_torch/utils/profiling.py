"""Profiling and debugging hooks (port of the JAX package's
``utils/profiling.py``; the reference has none).

* ``trace(log_dir)``: ``torch.profiler`` around a block, its trace
  written to ``log_dir`` for TensorBoard or Perfetto (Chrome format);
* ``enable_nan_checks()``: anomaly detection for the backward, and a
  forward hook on every module that raises at the first non-finite
  output, as ``jax_debug_nans`` checks both directions (each check
  synchronises with the card: not for a captured graph or a timing);
* ``diagnose_grads(model)``: the mean absolute gradient of each
  top-level subnetwork, the reference's ``diagnose_network``;
* ``scan_bench(f, args)``: ms a call with no launch cost in it, from a
  CUDA graph of ``iters`` captured calls replayed (the JAX package loops
  the call inside one jitted ``lax.scan``).
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict

import torch
from torch import nn


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA where there is a card) and write
    its trace to ``log_dir``; yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _floats(obj):
    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point():
            yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _floats(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _floats(v)


def _check_finite(module, inputs, output):
    for t in _floats(output):
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(
                f"non-finite output of {type(module).__name__} "
                f"(shape {tuple(t.shape)})")


def enable_nan_checks():
    """Raise at the first non-finite module output in a forward and at a
    backward that yields one (``torch.autograd.set_detect_anomaly``).
    Returns the forward hook's handle: ``.remove()`` ends the forward
    checks, ``torch.autograd.set_detect_anomaly(False)`` the backward's."""
    torch.autograd.set_detect_anomaly(True)
    return nn.modules.module.register_module_forward_hook(_check_finite)


def diagnose_grads(model: nn.Module) -> Dict[str, float]:
    """{top-level subnetwork: mean |gradient| over its parameters}, under
    the JAX package's keys (``encoder``, ``classifier``, ...).  A
    parameter without a gradient (a bias that a BatchNorm follows) counts
    as zeros, as its cotangent is zero in the JAX package."""
    out = {}
    for name, sub in model.named_children():
        params = list(sub.parameters())
        if not params:
            continue
        total = sum(float(p.grad.detach().abs().double().sum())
                    for p in params if p.grad is not None)
        count = sum(p.numel() for p in params)
        out[name] = total / max(count, 1)
    return out


def scan_bench(f, args=(), iters: int = 50, name: str = "",
               reps: int = 30) -> float:
    """ms a call of ``f(*args)``.  On the card (a CUDA tensor among the
    arguments or the first call's results): the median over ``reps``
    replays of a CUDA graph holding ``iters`` captured calls, over
    ``iters``; the host starts one replay and the card runs the calls back
    to back, so no launch cost is in it.  On the CPU: the host clock over
    ``iters`` calls, median of ``reps``."""
    from .tprof import _tensors
    out = f(*args)
    if any(t.is_cuda for t in _tensors((args, out))):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                f(*args)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                f(*args)
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        del graph
    else:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(iters):
                f(*args)
            times.append((time.perf_counter() - t0) * 1e3 / iters)
    ms = statistics.median(times)
    if name:
        print(f"{name}: {ms:.4f} ms/iter")
    return ms
