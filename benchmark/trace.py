"""The benchmark's reading of a ``torch.profiler`` trace.

A traced run records one slice of its window inside a span
``bench:slice``; ``collect`` keeps the device's rows (kernels, copies and
memsets) that overlap it and the harness's own spans (``bench:<name>``).
From those: the union of device activity (busy time), the idle gaps and
the span that was open on the host during each, the time of named
kernels, and the device time by bucket.

The buckets are a frozen copy of the program's ``utils/hlocat.py`` (its
patterns as of the benchmark's first version), so that a change to the
program cannot move what the benchmark reports.
"""

from __future__ import annotations

import collections
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

SLICE = "bench:slice"

# (bucket, pattern), the first match wins
BUCKETS = (
    ("pooling kernel", re.compile(
        r"\b(segment_max_window_(bulk|direct)|fill_empty|"
        r"segment_argmax_keys|clear_keys|unpack_keys)\b")),
    ("copies and memsets", re.compile(
        r"^(Memcpy|Memset)|direct_copy_kernel|CatArrayBatchedCopy")),
    ("Adam", re.compile(r"[Aa]dam|multi_tensor_apply_kernel")),
    ("sorts", re.compile(r"(?<!search)[Ss]ort|fill_index_and_segment")),
    ("GEMMs", re.compile(
        r"gemm|Gemm|GEMM|gemv|cutlass|nvjet|xmma|cublas|splitKreduce")),
    ("gathers and scatters", re.compile(r"scatter|gather|[Ii]ndex")),
    ("BatchNorm statistics and other reductions", re.compile(
        r"reduce_kernel|[Rr]educ|welford|[Nn]orm|cumsum")),
    ("elementwise", re.compile(r"elementwise")),
)
OTHER = "other"

Interval = Tuple[str, int, int]          # (name, start ns, end ns)


@dataclasses.dataclass
class Trace:
    """One traced slice: its bounds (ns, the profiler's clock), the device
    rows overlapping it, and the harness's spans overlapping it."""
    start: int
    end: int
    device: List[Interval]
    spans: List[Interval]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9


def _bounds(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        s = int(e.start_ns())
        return s, s + int(e.duration_ns())
    s = int(e.start_us()) * 1000
    return s, s + int(e.duration_us()) * 1000


def collect(prof) -> Trace:
    """The slice of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    cpu, dev = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, t = _bounds(e)
        if e.device_type() == DeviceType.CUDA:
            if (e.is_user_annotation() or name.startswith("bench:")
                    or name.startswith("Optimizer.")):
                continue
            dev.append((name, s, t))
        elif name.startswith("bench:"):
            cpu.append((name, s, t))
    slices = [iv for iv in cpu if iv[0] == SLICE]
    if len(slices) != 1:
        raise RuntimeError(f"a trace needs one {SLICE} span, found "
                           f"{len(slices)}")
    _, lo, hi = slices[0]
    return Trace(lo, hi, [iv for iv in dev if iv[2] > lo and iv[1] < hi],
                 [(n[len("bench:"):], s, t) for n, s, t in cpu
                  if n != SLICE and t > lo and s < hi])


def _merged(intervals: List[Interval], lo: int, hi: int
            ) -> List[Tuple[int, int]]:
    """The union of the intervals clipped to [lo, hi], as disjoint pieces
    in order."""
    pieces = sorted((max(s, lo), min(t, hi)) for _, s, t in intervals
                    if min(t, hi) > max(s, lo))
    out: List[List[int]] = []
    for s, t in pieces:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def busy_s(trace: Trace) -> float:
    """Seconds of the slice in which the device ran something."""
    return sum(t - s for s, t in _merged(trace.device, trace.start,
                                         trace.end)) / 1e9


def gaps(trace: Trace) -> List[Tuple[int, int]]:
    """The slice's idle intervals, in order."""
    out, cur = [], trace.start
    for s, t in _merged(trace.device, trace.start, trace.end):
        if s > cur:
            out.append((cur, s))
        cur = t
    if trace.end > cur:
        out.append((cur, trace.end))
    return out


def open_span(trace: Trace, at: int) -> str:
    """The innermost harness span open at time ``at``, or "no span"."""
    best: Optional[Interval] = None
    for iv in trace.spans:
        if iv[1] <= at < iv[2] and (best is None
                                    or iv[2] - iv[1] < best[2] - best[1]):
            best = iv
    return best[0] if best else "no span"


def idle_gaps(trace: Trace, top: int = 10) -> List[list]:
    """[[span open on the host, seconds]] of the longest idle gaps."""
    longest = sorted(gaps(trace), key=lambda g: g[0] - g[1])[:top]
    return [[open_span(trace, s), (t - s) / 1e9] for s, t in longest]


def bucket(name: str) -> str:
    for label, pattern in BUCKETS:
        if pattern.search(name):
            return label
    return OTHER


def by_bucket(trace: Trace) -> Dict[str, float]:
    """Seconds of device time by bucket (the rows' own durations)."""
    out: Dict[str, float] = collections.Counter()
    for name, s, t in trace.device:
        out[bucket(name)] += (t - s) / 1e9
    return dict(out)


def device_ops(trace: Trace, top: int = 10) -> List[list]:
    """[[bucket, seconds]] of the buckets that took most device time."""
    rows = sorted(by_bucket(trace).items(), key=lambda kv: -kv[1])
    return [[k, v] for k, v in rows[:top]]


def kernel_time(trace: Trace, pattern: str) -> Tuple[float, int]:
    """(seconds, rows) of the device rows whose name matches ``pattern``."""
    rx = re.compile(pattern)
    rows = [(s, t) for name, s, t in trace.device if rx.search(name)]
    return sum(t - s for s, t in rows) / 1e9, len(rows)


def breakdown(trace: Trace) -> dict:
    return {"device_ops": device_ops(trace), "idle_gaps": idle_gaps(trace)}
