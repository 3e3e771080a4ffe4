#!/usr/bin/env python3
"""The knee of a serving cell, found once when the cell is defined: its
server set up once, then an open loop at each rate in turn, one JSON line
a rate.  The benchmark's own runs never run this; a cell runs at a fixed
rate (``rate_per_s`` of its traffic file).

    python3 benchmark/sweep.py --workload <cell> --rates 100,150,200 \
        --seconds 8 [--seed 1]

Per rate: requests and answers, the latency's median and 95th percentile
from the due times, the generator's lateness (median, and its growth from
the first third of the schedule to the last), and the answers per second
over the schedule.  The knee is the highest rate whose answers keep up
and whose lateness does not grow.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.traffic import arrivals, lateness_growth, percentile  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    man = harness.load_manifest(ROOT)
    ctx = harness.make_context(man, args.workload, args.seed, args.seconds,
                               False, args.device, time.perf_counter())
    driver = harness.load_module(
        harness.BENCH_DIR / "drivers" / f"{ctx.traffic['driver']}.py",
        "bench_driver")
    srv = driver.Server(ctx)
    tr = ctx.traffic
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            due, which = arrivals(rate, args.seconds, tr["bodies"], args.seed)
            gen = srv.start_load(due, which, tr)
            before = srv.engine.stats()
            srv.go(gen)
            t0 = time.perf_counter()
            res = srv.results(gen)
            waited = time.perf_counter() - t0
            after = srv.engine.stats()
            lat = driver.latencies(due, res, waited)
            ok = res["status"] == 200
            span = np.nanmax(res["done"]) - due[0]
            print(json.dumps({
                "rate_per_s": rate, "requests": len(due),
                "answered": int(ok.sum()),
                "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
                "lateness_p50_ms": float(np.nanmedian(res["sent"] - due) * 1e3),
                "lateness_growth_ms": lateness_growth(due, res["sent"]) * 1e3,
                "answers_per_s": float(ok.sum() / span),
                "clouds_per_dispatch": (after["items"] - before["items"])
                / max(after["dispatches"] - before["dispatches"], 1)}),
                flush=True)
    finally:
        srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
