#!/usr/bin/env python3
"""SHREC16 retrieval soak of the PyTorch port (``sonet_torch``); the
counterpart of ``tools/soak_retrieval.py``: train the shrec16 preset at
scale on the card, then run the full retrieval evaluation (rank files +
mAP / P@k) over the test split, the reference workflow (shrec16/train.py
+ shrec16/test.py) end to end.

    python3 tools/torch_soak_retrieval.py --dataroot data/shrec_scale \\
        --epochs 20 --band

The test split is scored from a fresh loader, at its first epoch's point
draws, as the JAX tool scores it.  Its labels are not the dataset's (the
test list carries none, so the loader's are placeholders): the
generator (``tools/torch_make_shrec_scale.py``) allocates ids in
per-class blocks, so ground truth is id // ``--per_class_block``.
``--device`` defaults to ``cuda``; ``cpu`` is for tests.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_soak import band_check, epoch_lr, load_band  # noqa: E402


def split_loader(cfg, device):
    """The test split's loader, as the JAX tool builds it after training:
    in order, the last batch padded, at its first epoch."""
    from sonet_torch.data.pipeline import BatchLoader
    from sonet_torch.train.trainer import build_dataset
    return BatchLoader(build_dataset(cfg, "test", device), cfg.batch_size,
                       shuffle=False, drop_last=False, pad_last=True)


def main(argv=None):
    """Returns the ranking's metrics, the test ids and their ground-truth
    labels (for tests); exits 1 outside an asserted band."""
    p = argparse.ArgumentParser()
    p.add_argument("--dataroot", required=True)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--input_pipeline", default="device")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                   "soak_shrec"))
    p.add_argument("--per_class_block", type=int, default=90,
                   help="generator ids per class (torch_make_shrec_scale "
                        "--per_class)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--assert_band", default=None, metavar="LO,HI",
                   help="fail (exit 1) unless test mAP lands inside "
                        "[LO, HI]")
    p.add_argument("--band", action="store_true",
                   help="shorthand: load [LO, HI] from the committed "
                        "tools/soak_bands.json (key 'shrec16')")
    args, rest = p.parse_known_args(argv)
    if args.band and not args.assert_band:
        args.assert_band = load_band("shrec16")

    import torch

    from sonet_torch import retrieval
    from sonet_torch.config import parse_args
    from sonet_torch.train.trainer import Trainer

    # further ``--<Config field> value`` pairs narrow the preset (tests)
    cfg = parse_args(rest, preset="shrec16").replace(
        dataroot=args.dataroot, input_pipeline=args.input_pipeline,
        seed=args.seed, name=f"soak_shrec_s{args.seed}",
        checkpoints_dir=args.out)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, quiet=True, resume=False, device=args.device)
    print(f"setup: {time.perf_counter() - t0:.1f}s", flush=True)
    for epoch in range(args.epochs):
        lr = epoch_lr(trainer, epoch)
        tr = trainer.train_epoch(epoch)
        sps = tr["sec_per_step"]
        print(f"epoch {epoch}: {sps * 1e3:.2f} ms/step = "
              f"{cfg.batch_size / sps:.1f} clouds/s "
              f"(loss {tr.get('loss', float('nan')):.4f} "
              f"acc {tr.get('accuracy', float('nan')):.3f}; lr {lr:.6g}, "
              f"captures {trainer.train_graph.captures})", flush=True)
    ev = trainer.evaluate()
    print(f"val eval: {ev}", flush=True)

    dev = trainer.device

    def device_batch(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()
                if k != "valid"}

    scores, _placeholder_labels, ids = retrieval.extract_scores(
        trainer.eval_step, trainer.state, split_loader(cfg, dev),
        device_batch)
    results = retrieval.rank_all(torch.from_numpy(scores).to(dev))
    true_labels = ids // args.per_class_block
    metrics = retrieval.retrieval_metrics(results, true_labels)
    out_dir = os.path.join(args.out, "rank")
    retrieval.write_rank_files(results, ids, out_dir)
    print(f"wrote {len(results)} rank files to {out_dir}")
    print("retrieval metrics (ground-truth labels):",
          {k: round(v, 4) for k, v in metrics.items()}, flush=True)

    if args.assert_band and not band_check("mAP", metrics["mAP"],
                                           args.assert_band):
        sys.exit(1)
    return metrics, ids, true_labels


if __name__ == "__main__":
    main()
