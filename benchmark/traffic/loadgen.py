"""The open-loop HTTP load generator: a process of its own (the standard
library and numpy; it imports neither torch nor the program), so that it
shares no interpreter lock with the server it loads.

Reads from stdin one JSON line (``port``, ``due`` offsets in s, ``which``
body of each request, ``warmup`` requests, ``threads``, ``timeout`` s,
``npz_bytes``) and then that many bytes of an npz holding the clouds
(``pc``, ``sn``, ``node``, one row a distinct request body).  Builds one
B'=1 npz body per cloud, sends the warm-up requests one by one, prints
``ready`` and waits for a line on stdin.  Then it sends request i at
``due[i]`` after that line, each on a new connection, from a pool of
threads; a request whose due time finds every thread busy waits, and the
time it waited counts against it.  Last it writes an npz to stdout:
``sent`` and ``done`` (s after the start; done is NaN for a request that
got no answer), ``status`` (HTTP code, 0 for none), ``server_ms`` (the
answer's own "ms") and ``logits`` (n, classes).

    python3 benchmark/traffic/loadgen.py < request
"""

import concurrent.futures
import http.client
import io
import json
import sys
import time

import numpy as np


def post(port: int, body: bytes, timeout: float):
    """(status, parsed JSON or None) of one predict request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/predict", body=body,
                     headers={"Content-Type": "application/x-npz",
                              "Connection": "close"})
        resp = conn.getresponse()
        payload = resp.read()
        return resp.status, (json.loads(payload) if resp.status == 200
                             else None)
    finally:
        conn.close()


def bodies(clouds) -> list:
    out = []
    for i in range(clouds["pc"].shape[0]):
        buf = io.BytesIO()
        np.savez(buf, pc=clouds["pc"][i:i + 1], sn=clouds["sn"][i:i + 1],
                 node=clouds["node"][i:i + 1])
        out.append(buf.getvalue())
    return out


def main() -> int:
    stdin = sys.stdin.buffer
    head = json.loads(stdin.readline())
    with np.load(io.BytesIO(stdin.read(head["npz_bytes"]))) as z:
        reqs = bodies({k: z[k] for k in ("pc", "sn", "node")})
    port, timeout = head["port"], head["timeout"]
    due = np.asarray(head["due"], np.float64)
    which = np.asarray(head["which"], np.int64)
    for i in range(head["warmup"]):
        status, _ = post(port, reqs[i % len(reqs)], timeout)
        if status != 200:
            print(f"loadgen: warm-up request answered {status}",
                  file=sys.stderr)
            return 1
    print("ready", flush=True)
    stdin.readline()

    n = len(due)
    sent = np.full(n, np.nan)
    done = np.full(n, np.nan)
    status = np.zeros(n, np.int64)
    server_ms = np.full(n, np.nan)
    logits = [None] * n
    t0 = time.perf_counter()

    def send(i):
        sent[i] = time.perf_counter() - t0
        try:
            code, ans = post(port, reqs[which[i]], timeout)
        except OSError as e:
            print(f"loadgen: request {i}: {e}", file=sys.stderr)
            return
        status[i] = code
        if ans is not None:
            done[i] = time.perf_counter() - t0
            server_ms[i] = ans["ms"]
            logits[i] = np.asarray(ans["output"], np.float64)[0]

    with concurrent.futures.ThreadPoolExecutor(head["threads"]) as pool:
        futures = []
        for i in range(n):
            wait = due[i] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(wait)
            futures.append(pool.submit(send, i))
        concurrent.futures.wait(futures)
        for f in futures:
            f.result()
    classes = next((len(x) for x in logits if x is not None), 0)
    out = np.full((n, classes), np.nan)
    for i, x in enumerate(logits):
        if x is not None:
            out[i] = x
    buf = io.BytesIO()
    np.savez(buf, sent=sent, done=done, status=status, server_ms=server_ms,
             logits=out)
    sys.stdout.buffer.write(buf.getvalue())
    sys.stdout.buffer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
