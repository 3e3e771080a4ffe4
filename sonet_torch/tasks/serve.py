"""HTTP model server (port of the JAX package's ``tasks/serve.py``; a
stdlib-only daemon).

Serves a finished run on ``--device`` (``cuda`` unless ``cpu`` is asked
for) over a small JSON/npz HTTP API: its exported artifact (``sonet-torch
export``; loading it needs no model code of this package) or the run
directory itself (``config.json`` + ``ckpt/``, restored in process).  On
a card each dispatch replays a captured CUDA graph.  The reference has no
serving story at all (its closest analogue is re-loading .pth files
inside the training code, shrec16/test.py:31-32).

    sonet-torch serve --run checkpoints/modelnet40 --port 8321
    sonet-torch serve --artifact checkpoints/modelnet40/export --port 8321
    sonet-torch serve --run ... --microbatch_ms 5

API (the JAX package's routes, codes and bodies):
  GET  /healthz       liveness + traffic counters
  GET  /v1/manifest   task, input signature, output meaning
  POST /v1/predict    body = JSON {"pc": [[..]], ...} (input name ->
                      nested list) or an .npz blob (Content-Type
                      application/x-npz) with the same member names.
                      Any request batch size works — the engine chunks
                      and pads onto its batch
                      (sonet_torch.serving.ServingEngine).  Response is
                      JSON {"output", "shape", "dtype", "items", "ms"},
                      or an npz blob with ``?format=npz``.

Bad inputs (wrong names/shapes/dtypes, malformed JSON/npz) return 400
with {"error": ...}; the model is never run on them.  Bodies over
``--max_request_mb`` get a 413 without being read.  The listener queues
up to 128 connections, so a burst of concurrent clients is answered, not
reset (the JAX package's daemon keeps the stdlib's 5).

Graceful shutdown: SIGTERM/SIGINT puts the daemon into DRAIN mode —
/healthz flips to 503 {"status": "draining"} (orchestrator readiness
check), new /v1/predict requests get 503 + Retry-After, in-flight
requests and the micro-batch queue complete normally, then the listener
closes and the process exits 0.  See ``drain_server``.  A device mesh is
not ported yet.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from . import device_parser


class _Server(ThreadingHTTPServer):
    # the stdlib listens with a backlog of 5: in a burst of more clients the
    # kernel drops or resets the connections beyond it, and a dropped one
    # waits a second to retry
    request_queue_size = 128


def make_server(engine, host: str = "127.0.0.1", port: int = 8321,
                quiet: bool = True,
                max_request_mb: float = 256.0) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server around a ServingEngine.

    ``max_request_mb`` bounds the request body read into memory (413 on
    exceed; a daemon must not OOM on one oversized POST)."""
    max_bytes = int(max_request_mb * (1 << 20))

    class Handler(BaseHTTPRequestHandler):
        server_version = "sonet-torch-serve/1.0"
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            if not quiet:
                BaseHTTPRequestHandler.log_message(self, fmt, *args)

        def _send(self, code, payload, content_type="application/json"):
            body = (payload if isinstance(payload, bytes)
                    else json.dumps(payload).encode())
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.partition("?")[0]
            if path in ("/", "/healthz"):
                if srv.draining.is_set():
                    self._send(503, {"status": "draining",
                                     **engine.stats()})
                else:
                    self._send(200, {"status": "ok", **engine.stats()})
            elif path == "/v1/manifest":
                self._send(200, engine.manifest)
            else:
                self._send(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path != "/v1/predict":
                return self._send(404, {"error": f"unknown path {path}"})
            if srv.draining.is_set():
                self.send_response(503)
                body = json.dumps({"error": "server is draining"}).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Retry-After", "1")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            with srv._inflight_cv:
                srv._inflight += 1
            try:
                self._predict(query)
            finally:
                with srv._inflight_cv:
                    srv._inflight -= 1
                    srv._inflight_cv.notify_all()

        def _predict(self, query):
            try:
                n = int(self.headers.get("Content-Length") or 0)
                if n > max_bytes:
                    return self._send(413, {
                        "error": f"request body {n} bytes exceeds the "
                                 f"{max_bytes} byte limit "
                                 f"(--max_request_mb)"})
                body = self.rfile.read(n)
                ctype = (self.headers.get("Content-Type")
                         or "application/json").partition(";")[0].strip()
                if ctype == "application/json":
                    payload = json.loads(body)
                    if not isinstance(payload, dict):
                        raise ValueError("JSON body must be an object "
                                         "mapping input name -> array")
                    inputs = payload.get("inputs", payload)
                else:  # application/x-npz / octet-stream
                    with np.load(io.BytesIO(body), allow_pickle=False) as z:
                        inputs = {k: z[k] for k in z.files}
                t0 = time.perf_counter()
                out = engine.predict(inputs)
                ms = (time.perf_counter() - t0) * 1e3
            except (ValueError, KeyError, json.JSONDecodeError, OSError,
                    EOFError) as e:
                return self._send(400, {"error": str(e)})
            except Exception as e:  # engine/backend failure
                return self._send(500, {"error": f"{type(e).__name__}: {e}"})
            if "format=npz" in query:
                buf = io.BytesIO()
                np.savez(buf, output=out)
                self._send(200, buf.getvalue(), "application/x-npz")
            else:
                self._send(200, {"output": out.tolist(),
                                 "shape": list(out.shape),
                                 "dtype": str(out.dtype),
                                 "items": int(out.shape[0]),
                                 "ms": round(ms, 3)})

    srv = _Server((host, port), Handler)
    srv.draining = threading.Event()
    srv._inflight = 0
    srv._inflight_cv = threading.Condition()
    return srv


def drain_server(srv, engine, timeout_s: float = 30.0) -> bool:
    """Graceful shutdown: refuse new work, finish in-flight, close.

    1. flip DRAIN mode (healthz 503 not-ready; new predicts 503 —
       the accept loop keeps running so clients get answers, not hangs),
    2. wait up to ``timeout_s`` for in-flight requests to complete,
    3. drain + stop the micro-batcher (queued coalesced work completes),
    4. stop the accept loop and close the listening socket.

    Returns True if all in-flight work completed within the timeout.
    Safe to call more than once (subsequent calls are no-ops)."""
    if srv.draining.is_set():
        return True
    srv.draining.set()
    deadline = time.monotonic() + timeout_s
    with srv._inflight_cv:
        while srv._inflight > 0:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            srv._inflight_cv.wait(left)
        clean = srv._inflight == 0
    stop = getattr(engine, "stop_microbatch", None)
    if stop is not None:
        stop()
    srv.shutdown()
    srv.server_close()
    return clean


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sonet-torch serve",
                                 parents=[device_parser()])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--run", help="run directory (config.json + ckpt/)")
    src.add_argument("--artifact", help="exported artifact directory "
                                        "(sonet-torch export's output)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8321)
    ap.add_argument("--batch_size", type=int, default=None,
                    help="serving batch size (--run only; default: the "
                         "run's; an artifact's is fixed at export)")
    ap.add_argument("--checkpoint", default=None, help="--run only")
    ap.add_argument("--mesh_shape", default=None,
                    help="a device mesh, e.g. '4,2' (more than one device "
                         "is not ported yet)")
    ap.add_argument("--microbatch_ms", type=float, default=0.0,
                    help="coalesce concurrent small requests into shared "
                         "dispatches, waiting up to this many ms to fill "
                         "the batch (0 = off); bounds the added "
                         "single-client latency")
    ap.add_argument("--max_request_mb", type=float, default=256.0,
                    help="reject request bodies larger than this (413)")
    ap.add_argument("--drain_timeout_s", type=float, default=30.0,
                    help="max seconds to wait for in-flight requests "
                         "when draining on SIGTERM/SIGINT")
    ap.add_argument("--no_warmup", action="store_true",
                    help="skip the warmup on zeros")
    ap.add_argument("--verbose", action="store_true",
                    help="log every request")
    args = ap.parse_args(argv)

    from ..device import refuse_mesh
    from ..serving import ServingEngine

    if args.artifact:
        if args.batch_size or args.checkpoint or args.mesh_shape:
            raise SystemExit("--batch_size/--checkpoint/--mesh_shape only "
                             "apply to --run (an artifact is fixed at "
                             "export time, on one device)")
        engine = ServingEngine.from_artifact(args.artifact,
                                             device=args.device)
    else:
        refuse_mesh(args.mesh_shape, "serves")
        engine = ServingEngine.from_run(args.run, batch_size=args.batch_size,
                                        checkpoint=args.checkpoint,
                                        device=args.device)
    if not args.no_warmup:
        engine.warmup()
    if args.microbatch_ms > 0:
        engine.start_microbatch(args.microbatch_ms)

    srv = make_server(engine, host=args.host, port=args.port,
                      quiet=not args.verbose,
                      max_request_mb=args.max_request_mb)
    print(json.dumps({"serving": args.artifact or args.run,
                      "task": engine.manifest["task"],
                      "batch_size": engine.batch_size,
                      "device": engine.manifest["device"],
                      "host": srv.server_address[0],
                      "port": srv.server_address[1]}), flush=True)

    # SIGTERM/SIGINT -> drain (healthz not-ready, in-flight completes,
    # exit 0).  The drain runs on its own thread: srv.shutdown() blocks
    # until serve_forever exits, and the signal handler interrupts the
    # main thread INSIDE serve_forever — calling it inline would
    # deadlock.  A second signal force-exits.
    drainer = []

    def handle(signum, frame):
        if drainer:
            os._exit(1)
        print("drain requested: refusing new work, finishing in-flight "
              "requests (signal again to force-quit)", flush=True)
        t = threading.Thread(
            target=drain_server, args=(srv, engine,
                                       args.drain_timeout_s),
            daemon=True, name="sonet-torch-serve-drain")
        drainer.append(t)
        t.start()

    prev = {s: signal.signal(s, handle)
            for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        srv.serve_forever()
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        if drainer:  # signal-initiated: wait for the drain to finish
            drainer[0].join(args.drain_timeout_s + 5)
        else:        # programmatic shutdown (tests): drain inline
            drain_server(srv, engine, args.drain_timeout_s)
        print(json.dumps({"drained": True, **engine.stats()}), flush=True)
    return 0


if __name__ == "__main__":
    main()
