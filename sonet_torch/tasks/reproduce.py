"""One-command archive -> gated-verdict reproduction (port of the JAX
package's ``tasks/reproduce.py``).

    sonet-torch reproduce --preset modelnet40 --archive modelnet40.tar.gz
    sonet-torch reproduce --preset shapenetpart --dataroot /prepared/tree

Chains the whole proof path the reference documents as manual steps
(README.md:45-49: download prepared datasets, then run the task's
train.py):

    prep ingest   (idempotent: an already-ingested --dest is reused)
 -> prep som      (only if the tree is missing SOM nodes; on --device)
 -> prep check    (fail-closed tree validation)
 -> training at the preset's reference hyperparameters on --device
                  (auto-resumes from the run dir's latest checkpoint,
                   so an interrupted reproduction continues with the
                   same command)
 -> final eval -> ONE JSON verdict line gated on the reference's own
    checkpoint-save threshold (modelnet/train.py:96-100 0.930/0.918,
    part-seg/train.py:110 0.835), with the paper numbers
    (arXiv 1803.04249) echoed for context.

Exit code: 0 if the gate passed (or the preset has no reference gate),
1 if training finished below the gate, 2 on a broken chain (bad
archive/tree).  Eval pictures of segment and autoencode runs need
matplotlib: without it the command says so and trains without them.
"""

from __future__ import annotations

import json
import os
import sys

from . import device_parser, pictures

# preset -> (dataset layout, gated metric, reference save gate,
#            paper number, citation)
GATES = {
    "modelnet40": ("modelnet", "accuracy", 0.918, 0.934,
                   "modelnet/train.py:98-100"),
    "modelnet10": ("modelnet", "accuracy", 0.930, 0.957,
                   "modelnet/train.py:96-97"),
    "shapenetpart": ("shapenet", "iou", 0.835, 0.846,
                     "part-seg/train.py:110"),
    "shrec16": ("shrec", "accuracy", None, None, "shrec16/train.py"),
    "autoencoder": ("shapenet", "loss", None, None,
                    "autoencoder/train.py"),
}


def _som_missing(dataroot: str, layout: str, cfg) -> bool:
    """True if the tree's first train item lacks SOM nodes."""
    import numpy as np
    if layout == "modelnet":
        from ..data.modelnet import make_dataset_modelnet
        items = make_dataset_modelnet(dataroot, "train", cfg)
        return not (items and os.path.exists(items[0][2]))
    if layout == "shrec":
        from ..data.modelnet import make_dataset_shrec2016
        items = make_dataset_shrec2016(dataroot, "train", cfg)
        if not items:
            return True
        with np.load(items[0][0]) as z:
            return "som_node" not in z.files
    if layout == "shapenet":
        from ..data.shapenet import make_dataset_shapenet
        entries = make_dataset_shapenet(dataroot, "train")
        rows = cfg.rows
        for e in entries:
            file = e[11:]
            path = os.path.join(dataroot, f"{file}_{rows}x{rows}.npz")
            if not os.path.exists(path):
                continue
            with np.load(path) as z:
                return "som_node" not in z.files
        return True
    return False


def _run_prep(argv) -> None:
    from ..data import prep
    prep.main(argv)


def main(argv=None):
    import argparse

    pre = argparse.ArgumentParser(
        prog="sonet-torch reproduce", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
        parents=[device_parser()])
    pre.add_argument("--preset", default="modelnet40",
                     choices=sorted(GATES))
    pre.add_argument("--archive", default=None,
                     help="published prepared-dataset archive "
                          "(.zip/.tar.gz or a pre-extracted dir); "
                          "omit to use an existing --dataroot tree")
    pre.add_argument("--dest", default=None,
                     help="dataroot to ingest into "
                          "(default ./data/<preset>)")
    pre.add_argument("--check_load", type=int, default=16,
                     help="items to fully validate per split "
                          "(-1 = all)")
    pre.add_argument("--som_sample", type=int, default=4096,
                     help="points sampled per shape for SOM fitting "
                          "(save_som.ipynb cell 1)")
    pre.add_argument("--som_batch", type=int, default=64,
                     help="SOM fit batch")
    known, rest = pre.parse_known_args(argv)

    from ..config import parse_args
    layout, metric, gate, paper, cite = GATES[known.preset]
    cfg = parse_args(["--preset", known.preset] + list(rest),
                     preset=known.preset)

    # ---- 1. ingest -------------------------------------------------------
    if known.archive:
        dest = known.dest or os.path.join("data", known.preset)
        manifest = os.path.join(dest, "ingest.json")
        if os.path.exists(manifest):
            # resume path: the archive was already unpacked — trust the
            # manifest, revalidate below with prep check
            with open(manifest) as f:
                print(f"reproduce: reusing ingested tree {dest} "
                      f"(sha256 {json.load(f).get('sha256', '?')[:12]})",
                      flush=True)
        else:
            try:
                _run_prep(["ingest", "--archive", known.archive,
                           "--dest", dest, "--layout", layout,
                           "--classes", str(cfg.classes),
                           "--rows", str(cfg.rows), "--no_check"])
            except SystemExit as e:
                if e.code:
                    print(f"reproduce: ingest failed ({e.code})",
                          file=sys.stderr)
                    return 2
        cfg = cfg.replace(dataroot=dest)
    elif not cfg.dataroot:
        print("reproduce: need --archive or --dataroot", file=sys.stderr)
        return 2

    # ---- 2. SOM nodes (prep som, only if the tree lacks them) ------------
    try:
        need_som = _som_missing(cfg.dataroot, layout, cfg)
    except (FileNotFoundError, OSError, ValueError) as e:
        print(f"reproduce: cannot read the train split under "
              f"{cfg.dataroot}: {e}", file=sys.stderr)
        return 2
    if need_som:
        print(f"reproduce: fitting {cfg.rows}x{cfg.rows} SOM nodes "
              f"(prep som) ...", flush=True)
        try:
            _run_prep(["som", "--root", cfg.dataroot,
                       "--rows", str(cfg.rows),
                       "--som_sample", str(known.som_sample),
                       "--batch", str(known.som_batch),
                       "--device", known.device])
        except SystemExit as e:
            if e.code:
                print(f"reproduce: SOM fitting failed ({e.code})",
                      file=sys.stderr)
                return 2

    # ---- 3. validate (prep check, fail-closed) ---------------------------
    try:
        _run_prep(["check", "--root", cfg.dataroot, "--layout", layout,
                   "--classes", str(cfg.classes),
                   "--rows", str(cfg.rows),
                   "--load", str(known.check_load)])
    except SystemExit as e:
        if e.code:
            print("reproduce: dataset validation failed — not starting "
                  "a multi-day training on a broken tree",
                  file=sys.stderr)
            return 2

    # ---- 4. train (auto-resume) + final eval -----------------------------
    # ModelNet10/40 automation, like tasks/classify.py
    if cfg.dataset == "modelnet" and cfg.classes == 10:
        cfg = cfg.replace(dropout=min(cfg.dropout + 0.1, 0.99),
                          lr_decay_step=40)
    from ..train.trainer import Trainer
    # the JAX package draws eval pictures every 5 epochs for segment and
    # autoencode; they need matplotlib
    viz = (cfg.task in ("segment", "autoencode")
           and pictures("eval pictures"))
    trainer = Trainer(cfg, device=known.device)  # restores the latest ckpt
    # resume trains only the REMAINING epochs of the reference budget
    # (state.step is restored; epoch-dependent lr/BN derive from it)
    done = int(trainer.state.step) // max(trainer.steps_per_epoch, 1)
    remaining = max(cfg.epochs - done, 0)
    if done:
        print(f"reproduce: {done}/{cfg.epochs} epochs already trained "
              f"in {trainer.out_dir}; {remaining} remain", flush=True)
    if remaining:
        final = trainer.fit(epochs=remaining, save_threshold=gate,
                            visualize_every=5 if viz else 0)
    else:
        final = trainer.evaluate()
    best = trainer.best_metric
    value = best if best is not None else (final or {}).get(metric)

    # ---- 5. verdict -------------------------------------------------------
    higher_better = metric != "loss"
    passed = (None if gate is None or value is None
              else bool(value > gate if higher_better else value < gate))
    verdict = {
        "reproduce": known.preset,
        "metric": metric,
        "best": None if value is None else round(float(value), 4),
        "final": {k: round(float(v), 4) for k, v in (final or {}).items()
                  if isinstance(v, (int, float))},
        "gate": gate,
        "pass": passed,
        "paper": paper,
        "reference": cite,
        "run_dir": trainer.out_dir,
    }
    print(json.dumps(verdict))
    return 1 if passed is False else 0


if __name__ == "__main__":
    raise SystemExit(main())
