#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card: for each seed,
the numbers of the comparison for the program, for the control (the
reference in the precision below the configuration's: 8-bit floats for
bfloat16 activations) and for the planted faults the cell can have.
One JSON line a seed.  The benchmark's own runs never run this.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control] [--faults]

A train cell's readings beside the program's: the control
(``reference_float8``), the reference rounded as the program's bfloat16
activations are (``reference_bfloat16``, a witness that the program's gap
is its precision's), the reference from weights one float32 ulp away
(``reference_one_ulp``, the steps' own sensitivity), and the fault
``half_batch`` (the loss taken over half of each batch, the reference put
in the program's place).  A state left unchanged reads 1 on
``change_gap`` by construction and needs no run.  ``--compute_dtype
float32`` runs the program in float32 (a witness).  A serving cell's fault (an answer altered where it is
produced) is the serving driver's own test.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import compare, harness  # noqa: E402
from benchmark.reference.precision import Precision  # noqa: E402


def summary(got: dict, ref: dict) -> dict:
    """The comparison's numbers of ``got`` against ``ref``, with each
    first step's loss gap, the run's step losses and the leaves' gaps
    beside them."""
    leaves = compare.kept_leaves(ref["grad"])
    out = compare.train_numbers(got, ref)
    out["first_loss_gaps"] = [abs(p - r) / abs(r) for p, r in
                              zip(got["first_losses"], ref["first_losses"])]
    out["chain_loss_gaps"] = [abs(p - r) / abs(r) for p, r in
                              zip(got["chain_losses"], ref["chain_losses"])]
    for k in ("grad", "change"):
        gaps = compare.leaf_gaps(got[k], ref[k], leaves)
        out[k + "_worst_gap"] = max(gaps.values())
        out[k + "_worst_leaf"] = max(gaps, key=gaps.get)
    return out


def nudged(weights: dict) -> dict:
    """The weights one float32 ulp away, up or down by a fixed pattern."""
    out = {}
    for n, w in weights.items():
        sign = torch.where(torch.arange(w.numel(), device=w.device) % 2 == 0,
                           1.0, -1.0).view(w.shape)
        out[n] = torch.nextafter(w, w + sign)
    return out


def train_readings(ctx, driver, seeds, control, faults):
    d, tr = ctx.cfg_dict, ctx.traffic
    for seed in seeds:
        t0 = time.perf_counter()
        ctx.seed = seed
        prog = driver.Program(ctx)
        singles, chain, readback = prog.checked_steps(
            tr["checked_first_steps"], tr["checked_run_steps"])
        readback["chain_losses"] = [float("nan")] * len(chain)
        raws = prog.raw_rows(singles), prog.raw_rows(chain)
        prog.free()
        ref = driver.reference(prog, d, *raws)
        out = {"seed": seed, "compute_dtype": d["compute_dtype"],
               "program": summary(readback, ref)}
        if control:
            for name in ("float8", "int8", "bfloat16"):
                got = driver.reference(prog, d, *raws, prec=Precision(name))
                out["reference_" + name] = summary(got, ref)
            w0 = prog.w0
            prog.w0 = nudged(w0)
            out["reference_one_ulp"] = summary(
                driver.reference(prog, d, *raws), ref)
            prog.w0 = w0
        if faults:
            half = driver.reference(prog, d, *raws,
                                    loss_rows=d["batch_size"] // 2)
            out["half_batch"] = summary(half, ref)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)


def serve_readings(ctx, driver, seeds, control):
    """For each seed, every distinct request body sent once over HTTP at
    the cell's rate, and the gap of the answers (and with ``control``, of
    the reference in 8-bit floats) from the reference's logits."""
    from benchmark.data import sub_seed
    from benchmark.reference import train as ref_train
    tr = ctx.traffic
    for seed in seeds:
        t0 = time.perf_counter()
        ctx.seed = seed
        srv = driver.Server(ctx)
        n = tr["bodies"]
        due = np.arange(n) / tr["rate_per_s"]
        which = np.random.default_rng(sub_seed(seed, "calibrate")
                                      ).permutation(n)
        gen = srv.start_load(due, which, {**tr, "warmup_requests": 0})
        srv.go(gen)
        res = srv.results(gen)
        srv.close()
        ok_rows = res["status"] == 200
        ref = ref_train.serve(srv.w0, ctx.cfg_dict, srv.clouds).cpu()
        out = {"seed": seed, "answered": int(ok_rows.sum()),
               "program": {"logit_gap": compare.logit_gap(
                   torch.from_numpy(res["logits"][ok_rows]),
                   ref[torch.from_numpy(which[ok_rows])])}}
        if control:
            ctl = ref_train.serve(srv.w0, ctx.cfg_dict, srv.clouds,
                                  prec=Precision("float8")).cpu()
            out["control"] = {"logit_gap": compare.logit_gap(ctl, ref)}
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compute_dtype", default=None,
                    help="run the program in this compute dtype instead "
                         "of the configuration's (a witness run)")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    man = harness.load_manifest(ROOT)
    over = ({"config": {"compute_dtype": args.compute_dtype}}
            if args.compute_dtype else None)
    ctx = harness.make_context(man, args.workload, seeds[0], 0.0, False,
                               args.device, time.perf_counter(),
                               overrides=over)
    driver = harness.load_module(
        harness.BENCH_DIR / "drivers" / f"{ctx.traffic['driver']}.py",
        "bench_driver")
    if ctx.traffic["driver"] == "serve_http":
        serve_readings(ctx, driver, seeds, args.control)
    else:
        train_readings(ctx, driver, seeds, args.control, args.faults)
    return 0


if __name__ == "__main__":
    sys.exit(main())
