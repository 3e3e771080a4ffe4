#!/usr/bin/env python3
"""Full-scale training soak of the PyTorch port (``sonet_torch``) through
the real dataset stack; counterpart of ``tools/soak.py``.

Trains any preset through its dataset loader (-> ``BatchLoader`` or the
device-resident pipeline -> ``Trainer``) on the card and reports the
sustained, input-pipeline-inclusive throughput a step and the task's
eval metrics; with ``--band`` it holds the final metric to the committed
band of ``tools/soak_bands.json`` and exits 1 outside it.

    python3 tools/torch_soak.py --dataroot data/mn40_scale --epochs 30 \\
        --input_pipeline device --band
    python3 tools/torch_soak.py --preset shapenetpart \\
        --dataroot data/snpart_scale --epochs 30 --input_pipeline device

Each epoch's line gives the last step's metrics and, with the device
pipeline, each metric's mean over the epoch (``mean_accuracy``, ...).
It also names the learning rate of its first step and the number of
times the train step was captured so far (0 on the CPU, where steps run
eagerly): a captured step reads the learning rate and the BatchNorm
momentum at capture, so each change of either shows as one more capture.
``--save`` writes the final state as a checkpoint of the run directory
``<out>/<name>`` (``sonet-torch infer --run`` scores it; so does the JAX
package through ``tools/compare_packages.py eval``).  ``--device``
defaults to ``cuda``; ``cpu`` runs the same steps eagerly, for tests.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sonet_torch.config import PRESETS  # noqa: E402

EVAL_KEY = {"classify": "accuracy", "retrieve": "accuracy",
            "segment": "iou", "autoencode": "loss"}


def load_band(preset):
    """-> "LO,HI" from the committed band table (tools/soak_bands.json:
    the 3-seed metric band measured on the hardness-tuned datasets, wide
    enough for seed noise, narrow enough that a semantics regression
    lands outside it)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "soak_bands.json")
    if not os.path.exists(path):
        sys.exit(f"--band: committed band table missing: {path}")
    with open(path) as f:
        bands = json.load(f)
    if preset not in bands:
        sys.exit(f"no committed band for preset {preset!r} (have: "
                 f"{sorted(k for k in bands if not k.startswith('_'))})")
    b = bands[preset]
    print(f"band: {preset}: [{b['lo']}, {b['hi']}] on {b['dataset']} "
          f"(hardness {b['hardness']}, {b['epochs']} epochs, "
          f"seeds {b['seeds']})", flush=True)
    return f"{b['lo']},{b['hi']}"


def band_check(key, val, assert_band):
    """Print the band line that ``tools/torch_quality.py`` reads; True
    when ``val`` lies inside "LO,HI"."""
    lo, hi = (float(x) for x in assert_band.split(","))
    inside = lo <= val <= hi
    print(f"band check: {key} {val:.4f} "
          f"{'INSIDE' if inside else 'OUTSIDE'} [{lo}, {hi}]", flush=True)
    return inside


def epoch_lr(trainer, epoch):
    """The learning rate of the first parameter group at ``epoch``'s
    first step (the halving schedule of ``lr_decay_step``)."""
    st = trainer.state
    group = st.optimizer.param_groups[0]["name"]
    return st.schedules[group](epoch * trainer.steps_per_epoch)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataroot", required=True)
    p.add_argument("--preset", default="modelnet40",
                   choices=sorted(PRESETS.keys()))
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--input_pipeline", default="host",
                   choices=("host", "device"))
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                   "soak_ckpt"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--save", action="store_true",
                   help="checkpoint the final state under --out")
    p.add_argument("--assert_band", default=None, metavar="LO,HI",
                   help="fail (exit 1) unless the task's headline "
                        "metric lands inside [LO, HI]")
    p.add_argument("--band", action="store_true",
                   help="shorthand: load [LO, HI] for this preset from "
                        "the committed tools/soak_bands.json")
    args, rest = p.parse_known_args(argv)
    if args.band and not args.assert_band:
        args.assert_band = load_band(args.preset)

    from sonet_torch.config import parse_args
    from sonet_torch.train import checkpoints
    from sonet_torch.train.trainer import Trainer

    # further ``--<Config field> value`` pairs narrow the preset (tests)
    cfg = parse_args(rest, preset=args.preset).replace(
        dataroot=args.dataroot,
        input_pipeline=args.input_pipeline,
        seed=args.seed,
        name=f"soak_{args.preset}_{args.input_pipeline}_s{args.seed}",
        checkpoints_dir=args.out)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, quiet=True, resume=False, device=args.device)
    print(f"setup (incl. data load): {time.perf_counter() - t0:.1f}s",
          flush=True)
    for epoch in range(args.epochs):
        lr = epoch_lr(trainer, epoch)
        tr = trainer.train_epoch(epoch)
        sps = tr["sec_per_step"]
        extra = " ".join(f"{k} {v:.4f}" for k, v in sorted(tr.items())
                         if k != "sec_per_step")
        print(f"epoch {epoch}: {sps * 1e3:.2f} ms/step sustained = "
              f"{cfg.batch_size / sps:.1f} clouds/s ({extra}; lr {lr:.6g}, "
              f"captures {trainer.train_graph.captures})", flush=True)
    ev = trainer.evaluate()
    print(f"eval: {ev}", flush=True)
    if args.save:
        path = checkpoints.save_checkpoint(
            os.path.join(trainer.out_dir, "ckpt"), trainer.state,
            trainer.state.step)
        print(f"checkpoint: {path}", flush=True)

    if args.assert_band:
        key = EVAL_KEY[cfg.task]
        if not band_check(key, ev[key], args.assert_band):
            sys.exit(1)


if __name__ == "__main__":
    main()
