#!/usr/bin/env python3
"""The readings the MNIST cell's limits are set from, on the card: for each
seed, every number of the cell's comparison
(``drivers/train_planar.py`` ``comparison``) for the program, for the
control (``reference_float8``: the reference in 8-bit floats), for the
reference in 8-bit integers (``reference_int8``) and rounded as the
program's bfloat16 activations are (``reference_bfloat16``), and for the
fault ``half_batch`` (the loss over half of each batch, the reference in
the program's place).  One JSON line a seed.  ``calibrate.py`` reads the
same variants with the numbers of ``compare.train_numbers`` only.

    python3 benchmark/calibrate_planar.py --seeds 1,2,3
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.reference.precision import Precision  # noqa: E402

CELL = "mnist.train-device"


def readings(ctx, driver, seed: int) -> dict:
    d, tr = ctx.cfg_dict, ctx.traffic
    ctx.seed = seed
    prog = driver.Program(ctx)
    singles, chain, readback = prog.checked_steps(
        tr["checked_first_steps"], tr["checked_run_steps"])
    raws = prog.raw_rows(singles), prog.raw_rows(chain)
    prog.free()
    ref = driver.reference(prog, d, *raws)
    out = {"seed": seed, "program": driver.comparison(readback, ref)}
    for name in ("float8", "int8", "bfloat16"):
        got = driver.reference(prog, d, *raws, prec=Precision(name))
        out["reference_" + name] = driver.comparison(got, ref)
    half = driver.reference(prog, d, *raws, loss_rows=d["batch_size"] // 2)
    out["half_batch"] = driver.comparison(half, ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctx = harness.make_context(harness.load_manifest(ROOT), CELL, seeds[0],
                               0.0, False, args.device, time.perf_counter())
    driver = harness.load_module(
        harness.BENCH_DIR / "drivers" / f"{ctx.traffic['driver']}.py",
        "bench_driver")
    for seed in seeds:
        t0 = time.perf_counter()
        out = readings(ctx, driver, seed)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
