"""The captured steps inside a traced slice of training, and the slice's
idle time split by them.

A part of the train cells is one ``EpochGraph.run``: the table's upload,
one replay of the same captured step a row, then the fetch of the part's
metrics.  Every replay runs the same graph, so its device rows carry the
same names in the same order.  ``extents`` finds them from that alone:
the slice's rows in order are a short head (the upload), the steps'
sequence repeated once a step, and a short tail (the fetch).  A replay's
extent runs from its first row's start to its last row's end, on the
device's clock.

The program marks the same extent itself.  Its ranges are named
``sonet:<name>`` (``sonet_torch/utils/spans.py``), apart from the
harness's ``bench:<name>``; kineto gives ``sonet:EpochGraph.replay`` a
device-side row from the replay's first kernel to its last.
``trace.collect`` leaves every annotation out of the device rows, these
too, so this module finds the extents from the rows it keeps.
``tools/torch_replay_ranges.py`` compares the two on a card: equal to the
nanosecond, but for a few replays whose kineto row ends early when a
part holds ~100,000 rows.

``idle_split`` puts each idle interval of the slice (``trace.gaps``) into
one of three parts, which add up to the slice's idle time:

* ``in_replay``: inside a replay's extent (between the kernels of a step);
* ``between_replays``: after the first replay starts and before the last
  ends, outside every extent;
* ``outside_replays``: before the first replay and after the last (the
  profiler's start, the table's upload, the fetch).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from benchmark import trace

# the most rows the head and the tail of a part may hold each
EDGE = 64

Extent = Tuple[int, int]


def extents(t: trace.Trace, steps: int) -> Optional[List[Extent]]:
    """The (start, end) ns of each of the slice's ``steps`` replays, in
    order, or None when its rows are not a head, exactly ``steps`` repeats
    of one sequence and a tail, the head and the tail of at most ``EDGE``
    rows each and neither one more repeat."""
    rows = sorted(t.device, key=lambda r: (r[1], r[2]))
    names = [r[0] for r in rows]
    n = len(rows)
    if steps <= 0:
        return None
    for head in range(min(EDGE, n) + 1):
        tail = (n - head) % steps
        body = n - head - tail
        if tail > EDGE or body <= 0:
            continue
        k = body // steps
        seq, end = names[head:head + k], head + body
        if (names[head:end - k] == names[head + k:end]
                and names[max(0, head - k):head] != seq
                and names[end:end + k] != seq):
            return [(rows[i][1], max(r[2] for r in rows[i:i + k]))
                    for i in range(head, head + body, k)]
    return None


def _pieces(t: trace.Trace, ext: List[Extent]) -> List[Extent]:
    """The union of the extents inside the slice, disjoint and in order."""
    return trace._merged([("", s, e) for s, e in ext], t.start, t.end)


def _inside(lo: int, hi: int, pieces: List[Extent], ends: List[int]) -> int:
    """ns of [lo, hi) covered by ``pieces`` (disjoint, in order; ``ends``
    their ends)."""
    covered = 0
    for i in range(bisect.bisect_right(ends, lo), len(pieces)):
        s, e = pieces[i]
        if s >= hi:
            break
        covered += min(hi, e) - max(lo, s)
    return covered


def idle_split(t: trace.Trace, ext: List[Extent]) -> Dict[str, float]:
    """Seconds of the slice's idle time in, between and outside the
    replays' extents ``ext``."""
    pieces = _pieces(t, ext)
    ends = [e for _, e in pieces]
    first, last = ext[0][0], max(e for _, e in ext)
    out = {"in_replay": 0, "between_replays": 0, "outside_replays": 0}
    for lo, hi in trace.gaps(t):
        inside = _inside(lo, hi, pieces, ends)
        span = max(0, min(hi, last) - max(lo, first))
        out["in_replay"] += inside
        out["between_replays"] += span - inside
        out["outside_replays"] += (hi - lo) - span
    return {k: v / 1e9 for k, v in out.items()}


def kernels_in_replays(t: trace.Trace, ext: List[Extent]) -> int:
    """The device rows (kernels, copies, memsets) that start inside a
    replay's extent."""
    pieces = _pieces(t, ext)
    starts = [s for s, _ in pieces]
    count = 0
    for _, s, _ in t.device:
        i = bisect.bisect_right(starts, s) - 1
        count += i >= 0 and s < pieces[i][1]
    return count


def of_readings(r: dict) -> Optional[Tuple[trace.Trace, List[Extent]]]:
    """(the traced slice, its replays' extents) from a train driver's
    readings, or None when there is no slice or no replay in it."""
    t, steps = r.get("trace"), r.get("slice_steps")
    if t is None or not steps or t.window_s <= 0:
        return None
    ext = extents(t, steps)
    return (t, ext) if ext else None


def idle_pct(r: dict, part: str) -> Optional[float]:
    """``part`` of ``idle_split`` as a share (%) of the slice's wall time,
    or None when ``of_readings`` finds nothing."""
    found = of_readings(r)
    if found is None:
        return None
    t, ext = found
    return 100.0 * idle_split(t, ext)[part] / t.window_s
