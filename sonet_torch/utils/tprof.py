"""Device time from a ``torch.profiler`` trace (port of the JAX package's
``utils/tprof.py``).

``device_time(fn, args)`` runs ``fn(*args)`` ``iters`` times under the
profiler and reads what the card did: the kernels, copies and memsets
(the CUDA rows), per run and by name.  It is the port's honest number for
a forward or a step: the host's launch costs and idle gaps are not in it,
so it holds to about 1% between runs where host and event times swing by
2x.  ``profile`` gives the same rows with their launch counts and the
profiler's table.

Where ``fn`` computes on the CPU (no CUDA tensor among its arguments and
results) the rows read are the CPU operators' own time: a CPU time, never
a device time.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Tuple


class Profile(NamedTuple):
    """What ``profile`` read, each number per run of ``fn``."""
    ms: Dict[str, float]          # row name -> ms
    launches: Dict[str, float]    # row name -> calls
    wall_ms: float                # host clock over the window
    on_card: bool                 # CUDA rows (else CPU operator rows)
    table: str                    # the profiler's table, by self time

    @property
    def total_ms(self) -> float:
        return sum(self.ms.values())


def _tensors(obj):
    """The tensors in ``obj`` and its dicts, lists and tuples."""
    import torch
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def device_rows(events):
    """The CUDA rows of ``key_averages()``: kernels, copies and memsets.
    The operator rows repeat their kernels' time, and so does the span
    that the optimizer step marks on the device (its gaps included)."""
    from torch.autograd import DeviceType
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.step")]


def profile(fn: Callable, args=(), iters: int = 10) -> Profile:
    """Run ``fn(*args)`` once, then ``iters`` times under torch.profiler.
    On the card (a CUDA tensor among the arguments or the first call's
    results) the rows are the CUDA ones, and a window without one raises;
    on the CPU they are the operators' self CPU time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    out = fn(*args)
    on_card = any(t.is_cuda for t in _tensors((args, out)))
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with tprofile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        if on_card:
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    if on_card:
        rows = device_rows(events)
        if not rows:
            raise RuntimeError("the profiler recorded no CUDA row for a "
                               "function on the card")
        ms = {e.key: e.self_device_time_total / 1e3 / iters for e in rows}
        sort_by = "self_device_time_total"
    else:
        rows = [e for e in events if e.self_cpu_time_total > 0]
        ms = {e.key: e.self_cpu_time_total / 1e3 / iters for e in rows}
        sort_by = "self_cpu_time_total"
    launches = {e.key: e.count / iters for e in rows}
    return Profile(ms, launches, wall / iters, on_card,
                   events.table(sort_by=sort_by, row_limit=80))


def device_time(fn: Callable, args=(), iters: int = 10,
                top: int = 0) -> Tuple[float, Dict[str, float]]:
    """(device ms a run, {kernel, copy or memset name: ms a run}) of
    ``fn(*args)`` over ``iters`` runs after a first one; ``top`` prints
    that many of the largest rows.  On the CPU: the operators' CPU ms."""
    p = profile(fn, args, iters)
    if top:
        for name, ms in sorted(p.ms.items(), key=lambda x: -x[1])[:top]:
            print(f"{ms:9.4f} ms  {name[:100]}")
    return p.total_ms, p.ms
