#!/usr/bin/env python3
"""The benchmark's replays of a traced train part against the program's
own ranges, on one CUDA card.

    python3 tools/torch_replay_ranges.py [--workload CELL ...] [--seed N]
        [--seconds S] [--out FILE.json] [--span_ab PARTS]

Runs each train cell of ``BENCHMARK.json`` once with ``--trace 1``, as
``benchmark/run.py`` does, and reads the same profiler slice twice:

- as the benchmark reads it: ``benchmark/replays.py`` finds the part's
  replays from the device rows alone (the repeated sequence of one
  captured step), and the cell's per-layer readers report on them;
- as the program marks it: the device rows named
  ``sonet:EpochGraph.replay`` that kineto adds for the range
  ``EpochGraph.run`` opens around each replay.

It prints, per cell, the replays in the slice, the ranges the program
marked, how many of the found extents equal a marked range to the
nanosecond (and the largest difference), whether each marked range
covers its replay's rows, the idle split against ``device_idle_pct.train``
and the result line's metrics; ``--out`` also writes them as JSON.  It
exits 1 when a marked range differs from its found extent, as kineto's
row of every ~24th replay does at modelnet40's ~109,000 rows a part (it
ends early).

``--span_ab PARTS`` measures instead what the range costs a traced part:
in one process, PARTS traced parts with it and PARTS without it, in turns,
each followed by an untraced part timed on the host clock.  Only a
process's first profiling session is sure to hold every device row: later
ones may lose rows at their start (their busy and idle times are then
wrong), so a part counts where its replays were found (``complete``).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness, replays, trace  # noqa: E402
from sonet_torch.train.graphs import REPLAY  # noqa: E402

CELLS = ("modelnet40.train-device", "shapenetpart.train-device")


def marked_ranges(prof, lo: int, hi: int):
    """The device rows of the program's replay range inside [lo, hi]."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.name() == REPLAY:
            s, t = trace._bounds(e)
            if t > lo and s < hi:
                out.append((s, t))
    return sorted(out)


def check_cell(manifest: dict, cell: str, seed: int, seconds: float) -> dict:
    seen = {}
    collect = trace.collect

    def collect_and_mark(prof):
        t = collect(prof)
        seen["trace"], seen["marked"] = t, marked_ranges(prof, t.start, t.end)
        return t
    trace.collect = collect_and_mark
    try:
        ctx = harness.make_context(manifest, cell, seed, seconds, True,
                                   "cuda", time.perf_counter())
        result = harness.run_cell(ctx)
    finally:
        trace.collect = collect
    if "trace" not in seen:
        raise SystemExit(f"{cell}: the window ended before its traced part "
                         f"(--seconds {seconds} is too short)")
    t, marked = seen["trace"], seen["marked"]
    steps = result.readings["slice_steps"]
    found = replays.extents(t, steps) or []
    pairs = list(zip(found, marked))
    diff = max((max(abs(a[0] - b[0]), abs(a[1] - b[1])) for a, b in pairs),
               default=None)
    covers = [sum(1 for _, s, e in t.device if s >= m0 and e <= m1)
              for m0, m1 in marked]
    # each marked range that is not its found extent: [replay, start
    # difference, end difference (ns, marked - found), rows it covers]
    unequal = [[i, b[0] - a[0], b[1] - a[1], covers[i]]
               for i, (a, b) in enumerate(pairs) if a != b]
    split = replays.idle_split(t, found) if found else {}
    idle = 100.0 * (1.0 - trace.busy_s(t) / t.window_s)
    line = harness.result_line(ctx, result, {})
    return {
        "cell": cell, "seed": seed, "correct": line["correct"],
        "slice_steps": steps, "found": len(found), "marked": len(marked),
        "equal": sum(a == b for a, b in pairs), "max_diff_ns": diff,
        "rows_in_marked": sorted(set(covers)), "unequal": unequal,
        "idle_split_pct": {k: 100.0 * v / t.window_s
                           for k, v in split.items()},
        "idle_pct": idle,
        "metrics": {k: v["value"] for k, v in line["metrics"].items()},
    }


def span_ab(manifest: dict, cell: str, seed: int, parts: int) -> dict:
    """In one process, traced parts with the program's replay range and
    without it (``train.graphs.span`` swapped for a do-nothing context),
    in turns (with, without, without, with, ...), and untraced parts timed
    on the host clock: per part, the device time a step, the idle split
    and the wall time a step."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from sonet_torch.train import graphs
    ctx = harness.make_context(manifest, cell, seed, 0, True, "cuda",
                               time.perf_counter())
    driver = harness.load_module(
        harness.BENCH_DIR / "drivers" / f"{ctx.traffic['driver']}.py", "drv")
    prog = driver.Program(ctx)
    rows, n = prog.rows, ctx.traffic["part_rows"]
    for _ in range(2):                      # the capture, then a warm part
        prog.run(rows.take(n))
    real, off = graphs.span, (lambda name: contextlib.nullcontext())
    out = {"cell": cell, "seed": seed, "span": [], "no_span": [],
           "untraced_ms_per_step": []}
    try:
        for i in range(2 * parts):
            on = i % 4 in (0, 3)
            graphs.span = real if on else off
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with ctx.spans("slice"):
                    prog.run(rows.take(n))
            t = trace.collect(prof)
            ext = replays.extents(t, n)
            split = replays.idle_split(t, ext) if ext else {}
            out["span" if on else "no_span"].append({
                "complete": ext is not None,
                "step_device_ms": trace.busy_s(t) / n * 1e3,
                "window_ms_per_step": t.window_s / n * 1e3,
                "idle_pct": 100.0 * (1 - trace.busy_s(t) / t.window_s),
                **{k: 100.0 * v / t.window_s for k, v in split.items()}})
            graphs.span = real
            t0 = time.perf_counter()
            prog.run(rows.take(n))          # ends with the part's fetch
            out["untraced_ms_per_step"].append(
                (time.perf_counter() - t0) / n * 1e3)
    finally:
        graphs.span = real
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", nargs="+", default=list(CELLS))
    ap.add_argument("--seed", type=int, default=1234567891)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--span_ab", type=int, default=0, metavar="PARTS",
                    help="instead: PARTS traced parts with the replay range "
                         "and PARTS without it, in turns, in one process")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print("card: " + harness.card_line(), flush=True)
    manifest = harness.load_manifest()
    if args.span_ab:
        out = [span_ab(manifest, c, args.seed, args.span_ab)
               for c in args.workload]
        for r in out:
            print(json.dumps(r), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
        return 0
    out = [check_cell(manifest, c, args.seed, args.seconds)
           for c in args.workload]
    for r in out:
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    ok = all(r["found"] == r["marked"] == r["equal"] == r["slice_steps"]
             for r in out)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
