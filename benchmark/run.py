#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the CUDA card(s) of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets the cell up from ``--seed`` (its split, nodes and weights made on the
card, its shapes warmed up and captured), measures for ``--seconds``,
compares what the timed path produced with the plain reference, and
prints one JSON object as the last line of stdout; each number compared
and its limit are also the last lines of stderr.  ``--trace 1`` reports
the cell's per-layer metrics, read from a ``torch.profiler`` trace of a
slice of the window, in place of its end-to-end ones.

Exits non-zero, printing no result, without a card (or with fewer than
the cell asks for), or when a JAX module or the JAX package was loaded.
Run it from the root of a checkout that holds the program.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed: a non-negative whole number")

    os.environ.setdefault("USE_FLAX", "0")
    manifest = harness.load_manifest(ROOT)
    cell = harness.find(manifest["workloads"], args.workload, "workload")
    import torch
    if not torch.cuda.is_available():
        print("benchmark: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    print("card: " + harness.card_line(), flush=True)
    ctx = harness.make_context(manifest, args.workload, args.seed,
                               args.seconds, bool(args.trace), "cuda",
                               T_START)
    result = harness.run_cell(ctx)
    banned = harness.banned_modules()
    if banned:
        print(f"benchmark: modules loaded that no run may load: {banned}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(result.memory_peak_bytes)}
    if args.trace:
        device["busy_s"] = result.busy_s
        device["window_s"] = result.window_s
    line = harness.result_line(ctx, result, device)
    for name, value, limit in result.checks:
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
