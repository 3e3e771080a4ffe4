"""Live training dashboard (port of the JAX package's ``tasks/monitor.py``;
the reference's ``python -m visdom.server``): SVG charts over the
``train_metrics.jsonl`` of the run directories, which it reads, so it
starts and stops at any time without losing history.

    sonet-torch monitor --root checkpoints/ --port 8322
    sonet-torch monitor --run checkpoints/modelnet40        # one run

It imports the standard library only (``utils.dashboard``): it runs on
any machine that sees the run directories, torch or not.
"""

from __future__ import annotations

import argparse
import os

from ..utils.dashboard import make_dashboard_server


def main(argv=None):
    p = argparse.ArgumentParser(
        description="live SVG charts over run-dir JSONL metrics")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--root", help="directory containing run dirs")
    g.add_argument("--run", help="one run dir")
    p.add_argument("--port", type=int, default=8322)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (0.0.0.0 to expose)")
    p.add_argument("--refresh_ms", type=int, default=3000)
    args = p.parse_args(argv)

    root = args.root or args.run
    if not os.path.isdir(root):
        raise SystemExit(f"sonet-torch monitor: {root!r} is not a directory")
    srv = make_dashboard_server(root, port=args.port,
                                refresh_ms=args.refresh_ms, host=args.host)
    host, port = srv.server_address[:2]
    print(f"sonet-torch monitor on http://{host}:{port}/  (ctrl-c to stop)",
          flush=True)
    try:
        srv._thread.join()
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    main()
