"""Export a finished run as a self-contained serving artifact (port of
the JAX package's ``tasks/export.py``).

The artifact holds the eval forward with its weights and BatchNorm
statistics inside, traced by ``torch.export`` (``model.pt2`` and
``manifest.json``; ``sonet_torch.serving`` gives the layout and the
calling convention), and is served by ``sonet-torch serve --artifact``.

    sonet-torch export --run checkpoints/modelnet40
    sonet-torch export --run ... --batch_size 64 --platforms cpu,cuda
    sonet-torch export --run ... --poly_batch          # any batch size
    sonet-torch export --run ... --check               # reload + verify

``--platforms`` with ``cpu`` (any list containing it) writes a portable
program, on the scatter pooling path, that loads with ``torch`` alone; a
``cuda``-only export keeps the windowed segment-max kernel.  The program
is traced on ``--device`` (``cuda`` unless ``cpu`` is asked for).
"""

from __future__ import annotations

import argparse
import json
import os

from . import device_parser


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sonet-torch export",
                                 parents=[device_parser()])
    ap.add_argument("--run", required=True,
                    help="run directory (config.json + ckpt/)")
    ap.add_argument("--out", default=None,
                    help="artifact directory (default <run>/export)")
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--platforms", default=None,
                    help="comma list, e.g. 'cuda' or 'cpu,cuda' "
                         "(default: the device's type)")
    ap.add_argument("--poly_batch", action="store_true",
                    help="any-batch-size artifact.  Without cpu in the "
                         "platforms: one fixed-shape program per "
                         "power-of-2 bucket, each keeping the kernel; with "
                         "cpu: one symbolic-batch program on the portable "
                         "scatter path")
    ap.add_argument("--buckets", dest="bucketed", default=None,
                    action="store_true",
                    help="with --poly_batch: per-bucket programs also for "
                         "platform lists with cpu (fixed shapes; pooling "
                         "still portable)")
    ap.add_argument("--check", action="store_true",
                    help="reload the artifact on the device and run it on "
                         "zeros")
    args = ap.parse_args(argv)

    from ..serving import export_run, load_exported

    platforms = args.platforms.split(",") if args.platforms else None
    manifest = export_run(args.run, out_dir=args.out,
                          batch_size=args.batch_size,
                          checkpoint=args.checkpoint, platforms=platforms,
                          poly_batch=args.poly_batch, bucketed=args.bucketed,
                          device=args.device)
    out = args.out or os.path.join(args.run, "export")
    if args.check:
        import numpy as np
        fn, m = load_exported(out, device=args.device)
        outs = np.asarray(fn(*(np.zeros([d or 1 for d in i["shape"]],
                                        i["dtype"])
                               for i in m["inputs"])))
        manifest["check"] = {"output_shape": list(outs.shape),
                             "finite": bool(np.isfinite(outs).all())}
    print(json.dumps(manifest))
    return manifest


if __name__ == "__main__":
    main()
