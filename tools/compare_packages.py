#!/usr/bin/env python3
"""The PyTorch port (``sonet_torch``) against the JAX package
(``sonet_tpu``) on one dataset tree, on the CPU: do they train alike, and
do they score one set of weights alike?

    # both packages' Trainers, one process each, side by side
    JAX_PLATFORMS=cpu python3 tools/compare_packages.py train \\
        --dataroot data/mn_small --out runs/cmp [--seeds 0 1] \\
        [--epochs 12] [--<Config field> value ...]

    # a run of the port (e.g. ``tools/torch_soak.py --save``) scored by
    # each package's ``infer`` over the test split, from the same weights
    JAX_PLATFORMS=cpu python3 tools/compare_packages.py eval \\
        --run runs/soak/soak_modelnet40_device_s0 --dataroot data/mn40_scale \\
        --out runs/cross [--input_pc_num 1024]

``train`` builds ``config.<preset>()`` (default modelnet40) with the
``--<Config field> value`` pairs in each package, prints the steps an
epoch of each ``Trainer`` and, after each epoch, the last step's loss,
the epoch's mean train accuracy where the ``Trainer`` gives one (the
port's device pipeline) and the test split's accuracy and loss; each
package's rows go to ``<out>/<pkg>_s<seed>.json``.  ``--epochs 0`` only
counts the steps.

``eval`` writes the run's newest checkpoint as reference ``.pth`` files
(``sonet_torch.compat``), imports them into a run of each package with
the run's config (``--input_pc_num`` / ``--batch_size`` may narrow it),
streams the test split through each package's ``infer`` and prints both
summaries and how many of the predictions agree.  The tree needs its SOM
nodes.  JAX runs on the CPU unless ``JAX_PLATFORMS`` says otherwise.
"""

import argparse
import csv
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("jax", "torch")


def _modules(pkg):
    """(config module, Trainer class, infer module, compat module)."""
    if pkg == "jax":
        from sonet_tpu import compat, config
        from sonet_tpu.tasks import infer
        from sonet_tpu.train.trainer import Trainer
    else:
        from sonet_torch import compat, config
        from sonet_torch.tasks import infer
        from sonet_torch.train.trainer import Trainer
    return config, Trainer, infer, compat


def train(pkg, seed, epochs, root, out, preset="modelnet40", rest=(),
          input_pipeline="device"):
    """One package's run: returns (steps an epoch, rows of (epoch, last
    train loss, mean train accuracy or None, test accuracy, test loss))
    and writes the rows to ``<out>/<pkg>_s<seed>.json``."""
    config, Trainer, _, _ = _modules(pkg)
    cfg = config.parse_args(list(rest), preset=preset).replace(
        dataroot=root, input_pipeline=input_pipeline, seed=seed,
        name=f"{pkg}_s{seed}", checkpoints_dir=out)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    trainer = Trainer(cfg, quiet=True, resume=False, **kw)
    steps = trainer.steps_per_epoch
    print(f"{pkg} s{seed}: {steps} steps an epoch "
          f"(len(train_loader) {len(trainer.train_loader)})", flush=True)
    rows = []
    for epoch in range(epochs):
        t0 = time.time()
        tr = trainer.train_epoch(epoch)
        ev = trainer.evaluate()
        mean = tr.get("mean_accuracy")
        rows.append((epoch, round(float(tr.get("loss", 0)), 4),
                     None if mean is None else round(mean, 4),
                     round(ev["accuracy"], 4), round(ev["loss"], 4)))
        print(pkg, seed, rows[-1], f"{time.time() - t0:.1f}s", flush=True)
    with open(os.path.join(out, f"{pkg}_s{seed}.json"), "w") as f:
        json.dump({"steps_per_epoch": steps, "rows": rows}, f)
    return steps, rows


def cross_eval(run, root, out, input_pc_num=None, batch_size=None):
    """``{pkg: infer summary}`` of the run's weights in each package, and
    the agreement: ``{"items", "same_pred"}``, the items streamed and
    how many of them both packages predict alike."""
    from sonet_torch import compat as tcompat
    files = tcompat.export_reference_checkpoint(
        run, os.path.join(out, "reference"))
    over = {"dataroot": root}
    if input_pc_num:
        over["input_pc_num"] = input_pc_num
    if batch_size:
        over["batch_size"] = batch_size
    summaries, preds = {}, {}
    for pkg in PACKAGES:
        config, _, infer, compat = _modules(pkg)
        cfg = config.load_config(os.path.join(run, "config.json")).replace(
            **over)
        pkg_run = os.path.join(out, pkg)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        compat.import_run(cfg, files, pkg_run, **kw)
        argv = ["--run", pkg_run, "--mode", "test"]
        summaries[pkg] = infer.main(argv + ([] if pkg == "jax"
                                            else ["--device", "cpu"]))
        with open(os.path.join(pkg_run, "infer", "predictions.csv")) as f:
            preds[pkg] = list(csv.DictReader(f))
    a, b = preds["jax"], preds["torch"]
    if [r["index"] for r in a] != [r["index"] for r in b]:
        raise SystemExit("the two packages streamed different items")
    agree = {"items": len(a),
             "same_pred": sum(x["pred"] == y["pred"] for x, y in zip(a, b))}
    return summaries, agree


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train")
    t.add_argument("--dataroot", required=True)
    t.add_argument("--out", required=True)
    t.add_argument("--preset", default="modelnet40")
    t.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    t.add_argument("--epochs", type=int, default=12)
    t.add_argument("--input_pipeline", default="device",
                   choices=("host", "device"))
    t.add_argument("--run", nargs=2, metavar=("PKG", "SEED"),
                   help=argparse.SUPPRESS)   # one package's run
    e = sub.add_parser("eval")
    e.add_argument("--run", required=True, help="a run directory of the "
                   "port (config.json + ckpt/)")
    e.add_argument("--dataroot", required=True)
    e.add_argument("--out", required=True)
    e.add_argument("--input_pc_num", type=int, default=None)
    e.add_argument("--batch_size", type=int, default=None)
    args, rest = p.parse_known_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    os.makedirs(args.out, exist_ok=True)

    if args.cmd == "eval":
        if rest:
            p.error(f"unrecognized arguments: {' '.join(rest)}")
        summaries, agree = cross_eval(args.run, args.dataroot, args.out,
                                      args.input_pc_num, args.batch_size)
        for pkg in PACKAGES:
            print(f"{pkg} infer: {json.dumps(summaries[pkg])}")
        print(f"agreement: {json.dumps(agree)}", flush=True)
        return summaries, agree

    if args.run:
        return train(args.run[0], int(args.run[1]), args.epochs,
                     args.dataroot, args.out, args.preset, rest,
                     args.input_pipeline)
    env = dict(os.environ, PYTHONPATH=REPO)
    for seed in args.seeds:
        runs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "train",
             "--dataroot", args.dataroot, "--out", args.out,
             "--preset", args.preset, "--epochs", str(args.epochs),
             "--input_pipeline", args.input_pipeline,
             "--run", pkg, str(seed)] + rest, env=env) for pkg in PACKAGES]
        for r in runs:
            if r.wait():
                sys.exit(f"a run failed ({r.returncode})")


if __name__ == "__main__":
    main()
