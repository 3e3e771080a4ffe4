"""Driver ``serve_http``: the program's HTTP daemon (``tasks/serve.py``
``make_server``) around a ``ServingEngine`` with its micro-batcher, under
an open loop of B'=1 requests from a load generator in a process of its
own (``traffic/loadgen.py``).

Set-up makes the clouds of ``bodies`` distinct requests (``points`` of
each raw cloud subsampled, nodes by farthest-point sampling) and the
weights on the card from the seed, builds the engine
(``ServingEngine.from_model`` at batch ``engine_batch``, ``warmup()``
capturing the forward, ``start_microbatch(microbatch_ms)``), serves it on
a free port of localhost from a thread of this process, and starts the
generator, which sends ``warmup_requests`` one by one.  The daemon is
handed a thin proxy of the engine whose ``predict`` is the harness's
span ``engine.predict``.

The window: requests due at the offsets of ``traffic.arrivals`` (a fixed
rate, ``rate_per_s``, for ``--seconds``), each timed from when it was due
to its answer.  A request that got no answer counts as late by the whole
time the generator waited for it.  A traced run records
``traced_seconds`` from one second into the window under the profiler.

After the window the engine is drained and freed, and the reference
computes every distinct cloud's logits; every answer is compared with
its cloud's.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import compare, data, trace as btrace
from benchmark.harness import Result, judge
from benchmark.reference import model as ref_model, train as ref_train
from benchmark.traffic import arrivals, lateness_growth, percentile

LOADGEN = Path(__file__).resolve().parents[1] / "traffic" / "loadgen.py"


class _Proxy:
    """What the daemon sees of the engine: its predict inside a span."""

    def __init__(self, engine, spans):
        self._engine, self._spans = engine, spans
        self.manifest = engine.manifest

    def predict(self, inputs):
        with self._spans("engine.predict"):
            return self._engine.predict(inputs)

    def stats(self):
        return self._engine.stats()

    def stop_microbatch(self):
        self._engine.stop_microbatch()


class Server:
    """The served program on a port of localhost, and the request bodies'
    clouds."""

    def __init__(self, ctx):
        from sonet_torch.models import build_model
        from sonet_torch.serving import ServingEngine
        from sonet_torch.tasks.serve import make_server

        cfg, d, tr = ctx.cfg(), ctx.cfg_dict, ctx.traffic
        dev = self.dev = torch.device(ctx.device)
        spec = ctx.config_file["split"]
        with ctx.phase("request clouds"):
            sp = data.split({**spec, "items": tr["bodies"]}, ctx.seed, dev,
                            tag="requests")
            pick = data.subsample(sp["pc"], cfg.input_pc_num,
                                  data.generator(ctx.seed, "subsample", dev))
            rows = pick[..., None].expand(-1, -1, 3)
            self.clouds = {"pc": torch.gather(sp["pc"], 1, rows),
                           "sn": torch.gather(sp["sn"], 1, rows),
                           "node": sp["node"]}
            del sp
        with ctx.phase("weights"):
            self.w0 = data.weights(ref_model.param_specs(d), ctx.seed, dev)
        with ctx.phase("engine"):
            model = build_model(cfg, device=dev)
            model.load_state_dict(self.w0, strict=True)
            self.engine = ServingEngine.from_model(
                model, cfg, device=dev, batch_size=tr["engine_batch"])
            del model
            self.engine.warmup()
            self.engine.start_microbatch(tr["microbatch_ms"])
        # the load generator gets a core of its own, as a client on another
        # host would; the server's threads, made from here on, the others
        cores = sorted(os.sched_getaffinity(0))
        self.client_cores = set(cores[-1:])
        if len(cores) > 1:
            os.sched_setaffinity(0, set(cores[:-1]))
        self.proxy = _Proxy(self.engine, ctx.spans)
        self.srv = make_server(self.proxy, port=0)
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       name="bench-http", daemon=True)
        self.thread.start()

    def host_clouds(self) -> bytes:
        buf = io.BytesIO()
        np.savez(buf, **{k: v.cpu().numpy() for k, v in self.clouds.items()})
        return buf.getvalue()

    def start_load(self, due, which, tr) -> subprocess.Popen:
        """The generator, warmed up and waiting for ``go``."""
        blob = self.host_clouds()
        head = {"port": self.srv.server_address[1], "due": due.tolist(),
                "which": which.tolist(), "warmup": tr["warmup_requests"],
                "threads": tr["client_threads"],
                "timeout": tr["request_timeout_s"], "npz_bytes": len(blob)}
        gen = subprocess.Popen([sys.executable, str(LOADGEN)],
                               stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        os.sched_setaffinity(gen.pid, self.client_cores)
        gen.stdin.write(json.dumps(head).encode() + b"\n" + blob)
        gen.stdin.flush()
        if gen.stdout.readline().strip() != b"ready":
            gen.kill()
            gen.wait()
            raise RuntimeError("the load generator did not come up")
        return gen

    @staticmethod
    def go(gen: subprocess.Popen) -> None:
        gen.stdin.write(b"go\n")
        gen.stdin.flush()

    @staticmethod
    def results(gen: subprocess.Popen) -> dict:
        out, _ = gen.communicate()
        if gen.returncode != 0:
            raise RuntimeError(f"the load generator exited {gen.returncode}")
        with np.load(io.BytesIO(out)) as z:
            return {k: z[k] for k in z.files}

    def close(self) -> None:
        from sonet_torch.tasks.serve import drain_server
        drain_server(self.srv, self.proxy)
        self.thread.join(timeout=30)
        del self.engine, self.proxy
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def latencies(due, res, waited_s: float):
    """Each request's latency in ms from its due time; one without an
    answer counts the whole ``waited_s`` after its due time."""
    done = res["done"]
    late = np.where(np.isnan(done), waited_s - due, done - due)
    return late * 1e3


def run(ctx) -> Result:
    tr = ctx.traffic
    srv = Server(ctx)
    due, which = arrivals(tr["rate_per_s"], ctx.seconds, tr["bodies"],
                          ctx.seed)
    gen = srv.start_load(due, which, tr)
    setup_s = ctx.setup_s()
    before = srv.engine.stats()
    srv.go(gen)
    t_go = time.perf_counter()
    t = None
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile
        time.sleep(max(0.0, t_go + 1.0 - time.perf_counter()))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with ctx.spans("slice"):
                time.sleep(tr["traced_seconds"])
    res = srv.results(gen)
    waited = time.perf_counter() - t_go
    after = srv.engine.stats()
    if ctx.trace:
        t = btrace.collect(prof)
        del prof
    peak = (torch.cuda.max_memory_allocated(srv.dev)
            if srv.dev.type == "cuda" else 0)
    srv.close()

    ok_rows = res["status"] == 200
    lat = latencies(due, res, waited)
    late = (res["sent"] - due) * 1e3
    print(f"generator lateness: p50 {np.nanmedian(late):.3f} ms, max "
          f"{np.nanmax(late):.3f} ms, growth "
          f"{lateness_growth(due, res['sent']) * 1e3:.3f} ms; answered "
          f"{int(ok_rows.sum())} of {len(due)}", flush=True)
    readings = {"engine": {k: after[k] - before[k]
                           for k in ("items", "dispatches", "requests")},
                "outside_engine_ms": ((res["done"] - res["sent"]) * 1e3
                                      - res["server_ms"])[ok_rows]}
    busy = window = breakdown = None
    if t is not None:
        readings["trace"] = t
        busy, window, breakdown = (btrace.busy_s(t), t.window_s,
                                   btrace.breakdown(t))

    # every answer against the reference's logits for its cloud
    ref = ref_train.serve(srv.w0, ctx.cfg_dict, srv.clouds)
    served = torch.from_numpy(res["logits"][ok_rows])
    numbers = {"logit_gap": compare.logit_gap(
        served, ref.cpu()[torch.from_numpy(which[ok_rows])])}
    print("comparison: " + json.dumps(numbers), flush=True)
    ok, checks = judge(numbers, ctx.limits)
    failed = int((~ok_rows).sum())
    return Result(attempted=len(due), failed=failed,
                  end_to_end={"serve_p95_ms": percentile(lat, 95),
                              "serve_p50_ms": percentile(lat, 50),
                              "setup_s": setup_s},
                  readings=readings, checks=checks,
                  correct=ok and failed == 0, memory_peak_bytes=peak,
                  busy_s=busy, window_s=window, breakdown=breakdown)

