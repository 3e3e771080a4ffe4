"""Batch inference driver (port of the JAX package's ``tasks/infer.py``).

Loads a finished training run (the directory the ``Trainer`` writes:
``config.json`` + ``ckpt/``) and streams a dataset split through the
eval step on the device, writing per-item predictions and a JSON summary.
The reference has no inference surface beyond the SHREC test script
(shrec16/test.py).

    sonet-torch infer --run checkpoints/modelnet40            # test split
    sonet-torch infer --run ... --mode train --batch_size 64
    sonet-torch infer --run ... --out preds/                  # artifacts
    sonet-torch infer --run ... --checkpoint path/to/step_00000123.pt

Outputs in --out (default <run>/infer), as the JAX package writes them:
  * classify/retrieve: ``predictions.csv`` (index,label,pred,correct)
  * segment:  ``predictions.csv`` (index,label,iou,seg_accuracy) and,
    with --dump_arrays, per-item predicted part labels ``pred_%06d.npy``
  * autoencode: ``predictions.csv`` (index,chamfer,chamfer_fwd,
    chamfer_bwd) and, with --dump_arrays, reconstructed clouds
    ``recon_%06d.npy``
  * ``summary.json`` — metrics weighted over the valid items + sustained
    clouds/s

The last batch is padded (``BatchLoader(pad_last=True)``); only its valid
items give rows and sums.  On a card the eval step is a captured CUDA
graph (``train.graphs.StepGraph``), replayed once a batch, as the JAX
package's is a jitted program.  ``--scan_chunk K`` issues K eval steps
and then fetches their metrics at once: one host sync every K batches.
The first chunk holds the kernels' build at first use and the capture,
so ``clouds_per_sec`` starts after it.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time

import numpy as np
import torch

from . import device_parser

_HEADER = {"classify": ["index", "label", "pred", "correct"],
           "retrieve": ["index", "label", "pred", "correct"],
           "segment": ["index", "label", "iou", "seg_accuracy"],
           "autoencode": ["index", "chamfer", "chamfer_fwd", "chamfer_bwd"]}


def _pipeline(args, cfg) -> str:
    """The input pipeline that streams the split: the flag's, else the
    run's.  ``native`` assembles batches in C++ threads; ``device``, a
    training construct, streams through the host pipeline, as in the JAX
    package (inference streams a batch at a time)."""
    pipeline = args.input_pipeline or cfg.input_pipeline
    return "host" if pipeline == "device" else pipeline


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sonet-torch infer",
                                 parents=[device_parser()])
    ap.add_argument("--run", required=True,
                    help="run directory (config.json + ckpt/)")
    ap.add_argument("--checkpoint", default=None,
                    help="explicit checkpoint path (default: latest in run)")
    ap.add_argument("--mode", default="test",
                    help="split to stream; 'train' streams the training "
                         "split WITH its augmentation (the training-time "
                         "view of the data)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--dataroot", default=None)
    ap.add_argument("--dump_arrays", action="store_true")
    ap.add_argument("--mesh_shape", default=None,
                    help="a device mesh, e.g. '4,2' (more than one device "
                         "is not ported yet)")
    ap.add_argument("--input_pipeline", default=None,
                    choices=["host", "native", "device"],
                    help="batch assembly (default: the run's setting; "
                         "'device' streams through 'host')")
    ap.add_argument("--scan_chunk", type=int, default=16,
                    help="eval steps issued before their metrics are "
                         "fetched (one host sync per chunk); 1 = fetch "
                         "every batch")
    args = ap.parse_args(argv)

    from .. import train
    from ..config import load_config
    from ..data.pipeline import BatchLoader
    from ..device import refuse_mesh, resolve_device
    from ..train.graphs import StepGraph
    from ..train.trainer import build_dataset

    cfg = load_config(os.path.join(args.run, "config.json"))
    if args.batch_size:
        cfg = cfg.replace(batch_size=args.batch_size)
    if args.dataroot:
        cfg = cfg.replace(dataroot=args.dataroot)
    refuse_mesh(args.mesh_shape, "infers")
    cfg = cfg.replace(input_pipeline=_pipeline(args, cfg), mesh_shape=(1, 1))
    dev = resolve_device(args.device)
    out_dir = args.out or os.path.join(args.run, "infer")
    os.makedirs(out_dir, exist_ok=True)

    dataset = build_dataset(cfg, args.mode, dev)
    loader = BatchLoader(dataset, cfg.batch_size, shuffle=False,
                         drop_last=False, pad_last=True)
    # the JAX package draws one batch here as its example input, which
    # moves the loader to its next epoch and so the items' point draws;
    # skipping that pass streams the same points as it does
    loader.skip_epoch()
    state = train.init_state(cfg, device=dev, seed=cfg.seed)
    ckpt = args.checkpoint or train.latest_checkpoint(
        os.path.join(args.run, "ckpt"))
    if ckpt is None:
        raise SystemExit(f"no checkpoint found under {args.run}/ckpt")
    train.restore_checkpoint(ckpt, state)
    _, eval_step = train.make_steps(cfg, 1)
    # small splits still get >= 2 chunks: the first is left out of the time
    K = max(1, min(args.scan_chunk, (len(loader) + 1) // 2))

    def to_device(batch):
        """Host arrays -> tensors for the step: pinned on a card, copied
        into the graph's static buffers on the compute stream."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory() if dev.type == "cuda" else t
        return out

    graph = StepGraph(lambda **batch: eval_step(state, batch), dev)

    rows = []
    sums, seen = {}, 0
    t0 = None
    timed = 0

    def process(batch, m, valid):
        """Per-batch bookkeeping on fetched (host) metrics."""
        nonlocal seen
        base = seen
        seen += valid
        for k, v in m.items():
            if k.endswith("_i"):
                sums[k[:-2]] = sums.get(k[:-2], 0.0) + float(v[:valid].sum())
        if cfg.task in ("classify", "retrieve"):
            pred = np.argmax(m["score"], -1)
            for i in range(valid):
                rows.append([base + i, int(batch["label"][i]), int(pred[i]),
                             int(pred[i] == batch["label"][i])])
        elif cfg.task == "segment":
            pred = np.argmax(m["score"], -1)
            for i in range(valid):
                rows.append([base + i, int(batch["label"][i]),
                             float(m["iou_i"][i]), float(m["correct_i"][i])])
                if args.dump_arrays:
                    np.save(os.path.join(out_dir, f"pred_{base+i:06d}.npy"),
                            pred[i].astype(np.int32))
        else:  # autoencode
            for i in range(valid):
                rows.append([base + i, float(m["loss_i"][i]),
                             float(m["chamfer_fwd_i"][i]),
                             float(m["chamfer_bwd_i"][i])])
                if args.dump_arrays:
                    np.save(os.path.join(out_dir, f"recon_{base+i:06d}.npy"),
                            np.asarray(m["predicted_pc"][i], np.float32))

    pending, valids, results = [], [], []

    def fetch(key):
        t = torch.stack([r[key] for r in results])
        return (t if t.dtype == torch.bool else t.float()).cpu().numpy()

    def flush():
        nonlocal t0, timed
        if not pending:
            return
        ms = {k: fetch(k) for k in results[0]}         # one wait for K steps
        if t0 is None:  # the first chunk holds the build; clock starts here
            t0 = time.perf_counter()
        else:
            timed += sum(valids)
        for j, (b, valid) in enumerate(zip(pending, valids)):
            process(b, {k: v[j] for k, v in ms.items()}, valid)
        pending.clear()
        valids.clear()
        results.clear()

    for batch in loader:
        valids.append(int(batch.pop("valid", cfg.batch_size)))
        pending.append(batch)
        # per-item metrics only, copied: the next replay overwrites them
        results.append({k: v.clone()
                        for k, v in graph(**to_device(batch)).items()
                        if v.dim() > 0})
        if len(pending) == K:
            flush()
    flush()

    dt = time.perf_counter() - t0
    with open(os.path.join(out_dir, "predictions.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(_HEADER[cfg.task])
        w.writerows(rows)

    summary = {k: v / max(seen, 1) for k, v in sums.items()}
    name_map = {"correct": "accuracy", "loss": "loss"}
    summary = {name_map.get(k, k): v for k, v in summary.items()}
    summary["items"] = seen
    summary["checkpoint"] = ckpt
    summary["clouds_per_sec"] = (timed / dt) if dt > 0 and timed else None
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
