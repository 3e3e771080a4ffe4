"""The device time of the program's ranges in a profiled eager step.

Inside a captured step the program's ranges (``sonet:<name>``,
``sonet_torch/utils/spans.py``) are recorded at the capture only, so a
traced train run profiles one eager step of the same train step after its
window and reads them there.  A range's device time is that of the device
rows (kernels, copies, memsets) launched by the range's forward ops and
by their backward ops:

* forward: every op that starts and ends inside the range, on its thread;
* backward: the profiler names each autograd function it runs
  ``autograd::engine::evaluate_function: <Node>`` and gives it the
  sequence number of the forward op that made the node, and the thread
  that op ran on.  A sequence number belongs to the last forward op to
  record it on that thread, the one that made the node (an op that makes
  none records the next number too, so the first op after a range may
  share the last number of an op inside it).  The backward ops of a range
  are the ops inside the autograd functions whose numbers belong to the
  range's forward ops;
* a device row belongs to the op whose correlation id it is linked to
  (the innermost op open when it was launched).

Only the rows inside the harness's span ``bench:<step>`` count, so a step
run before it in the same profiling session (a later session may lose
rows at its start) is left out.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

from benchmark import trace

BACKWARD = "autograd::engine::evaluate_function: "


@dataclasses.dataclass(frozen=True)
class Op:
    """A host-side row: an op, a range or an autograd function."""
    name: str
    corr: int
    thread: int
    start: int
    end: int
    seq: int
    fwd_thread: int


@dataclasses.dataclass
class Events:
    """The host rows and the device rows (name, start, end, linked
    correlation id) of a profiling session."""
    ops: List[Op]
    rows: List[Tuple[str, int, int, int]]


def collect(prof) -> Events:
    """The rows of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    ops, rows = [], []
    for e in prof.profiler.kineto_results.events():
        s, t = trace._bounds(e)
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                rows.append((e.name(), s, t, int(e.linked_correlation_id())))
        else:
            ops.append(Op(e.name(), int(e.correlation_id()),
                          int(e.start_thread_id()), s, t,
                          int(e.sequence_nr()), int(e.fwd_thread_id())))
    return Events(ops, rows)


def _inside(ops: List[Op], outer: List[Op]) -> List[Op]:
    """The ops of ``ops`` that lie inside one of ``outer`` (which do not
    overlap on a thread) on its thread, ``outer`` included."""
    by_thread = collections.defaultdict(list)
    for o in sorted(outer, key=lambda o: o.start):
        by_thread[o.thread].append(o)
    starts = {t: [o.start for o in v] for t, v in by_thread.items()}
    out = []
    for op in ops:
        if op.thread not in by_thread:
            continue
        i = bisect.bisect_right(starts[op.thread], op.start) - 1
        if i >= 0 and op.end <= by_thread[op.thread][i].end:
            out.append(op)
    return out


def span_ops(ev: Events, span: str, lo: int, hi: int
             ) -> Optional[Tuple[List[Op], List[Op]]]:
    """(forward ops, backward ops) of the ranges named ``span`` that lie in
    [lo, hi], or None when there is none; each list holds the ranges or
    the autograd functions themselves too."""
    ranges = [o for o in ev.ops if o.name == span and lo <= o.start
              and o.end <= hi]
    if not ranges:
        return None
    threads = {r.thread for r in ranges}
    forward = _inside(ev.ops, ranges)
    # each sequence number's owner: the last forward op to record it
    owner: Dict[Tuple[int, int], Op] = {}
    for o in sorted(ev.ops, key=lambda o: o.start):
        if (o.seq >= 0 and o.fwd_thread == 0 and o.thread in threads
                and not o.name.startswith(BACKWARD)):
            owner[(o.thread, o.seq)] = o
    inside = set(map(id, forward))
    seqs = {k for k, o in owner.items() if id(o) in inside}
    functions = [o for o in ev.ops if o.name.startswith(BACKWARD)
                 and (o.fwd_thread, o.seq) in seqs]
    return forward, _inside(ev.ops, functions)


def span_device_s(ev: Events, span: str, lo: int, hi: int
                  ) -> Optional[float]:
    """Seconds of the device rows launched by ``span``'s forward and
    backward ops (``span_ops``), or None when the range is not there."""
    found = span_ops(ev, span, lo, hi)
    if found is None:
        return None
    corr = {o.corr for o in found[0] + found[1]}
    return sum(t - s for _, s, t, c in ev.rows if c in corr) / 1e9


def read(prof, step: str, spans: Iterable[str]) -> Dict[str, float]:
    """{range: device seconds} of each of ``spans`` found inside the
    harness's span ``bench:<step>``; a range not found is left out."""
    ev = collect(prof)
    marks = [o for o in ev.ops if o.name == "bench:" + step]
    if len(marks) != 1:
        raise RuntimeError(f"a span reading needs one bench:{step} span, "
                           f"found {len(marks)}")
    lo, hi = marks[0].start, marks[0].end
    out = {}
    for name in spans:
        s = span_device_s(ev, name, lo, hi)
        if s is not None:
            out[name] = s
    return out
