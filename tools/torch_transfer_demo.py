#!/usr/bin/env python3
"""Encoder transfer with the PyTorch port (``sonet_torch``): autoencoder
pretraining, then part-segmentation fine-tuning, the reference's
cross-task workflow (part-seg/options.py:36 loads an autoencoder
checkpoint through --pretrain with pretrain_lr_ratio); counterpart of
``tools/transfer_demo.py``.

Trains the autoencoder at scale, saves a full checkpoint
(``train.checkpoints.save_checkpoint``), restores its encoder alone into
a fresh segmenter (``Trainer`` with ``pretrain=``, through
``train.checkpoints.restore_encoder``), fine-tunes it, fine-tunes a
segmenter from scratch for the same number of steps, and prints the
difference.

    python3 tools/torch_transfer_demo.py --dataroot data/snpart_scale \\
        --ae_epochs 12 --seg_epochs 3

``--device`` defaults to ``cuda``; ``cpu`` is for tests, which also pass
``--<Config field> value`` pairs that narrow both presets.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_seg(cfg, epochs, tag, device):
    from sonet_torch.train.trainer import Trainer
    trainer = Trainer(cfg, quiet=True, resume=False, device=device)
    for epoch in range(epochs):
        tr = trainer.train_epoch(epoch)
        print(f"  [{tag}] epoch {epoch}: loss {tr.get('loss', 0):.4f} "
              f"seg_acc {tr.get('seg_accuracy', 0):.4f}", flush=True)
    ev = trainer.evaluate()
    print(f"  [{tag}] eval: iou {ev['iou']:.4f} "
          f"seg_acc {ev['seg_accuracy']:.4f} loss {ev['loss']:.4f}",
          flush=True)
    return ev


def main(argv=None):
    """Returns the (pretrained, scratch) evals (for tests)."""
    p = argparse.ArgumentParser()
    p.add_argument("--dataroot", required=True)
    p.add_argument("--ae_epochs", type=int, default=12)
    p.add_argument("--seg_epochs", type=int, default=3)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                   "transfer_demo"))
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args, rest = p.parse_known_args(argv)

    from sonet_torch.config import parse_args
    from sonet_torch.train import checkpoints
    from sonet_torch.train.trainer import Trainer

    # 1) autoencoder pretraining + a full checkpoint
    ae_cfg = parse_args(rest, preset="autoencoder").replace(
        dataroot=args.dataroot, input_pipeline="device", name="ae_pre",
        checkpoints_dir=args.out)
    t0 = time.perf_counter()
    ae = Trainer(ae_cfg, quiet=True, resume=False, device=args.device)
    for epoch in range(args.ae_epochs):
        tr = ae.train_epoch(epoch)
        print(f"[ae] epoch {epoch}: chamfer {tr.get('chamfer', 0):.4f}",
              flush=True)
    ckpt = checkpoints.save_checkpoint(
        os.path.join(args.out, "ae_ckpt"), ae.state, int(ae.state.step))
    print(f"[ae] checkpoint: {ckpt} ({time.perf_counter() - t0:.0f}s)",
          flush=True)

    # 2) part-seg fine-tuning from the autoencoder's encoder vs from scratch
    base = parse_args(rest, preset="shapenetpart").replace(
        dataroot=args.dataroot, input_pipeline="device",
        checkpoints_dir=args.out)
    print("fine-tune WITH AE-pretrained encoder "
          "(restore_encoder, pretrain_lr_ratio=0.1):", flush=True)
    ev_pre = run_seg(base.replace(pretrain=ckpt, pretrain_lr_ratio=0.1,
                                  name="seg_pre"),
                     args.seg_epochs, "pretrained", args.device)
    print("fine-tune FROM SCRATCH (same step budget):", flush=True)
    ev_scr = run_seg(base.replace(name="seg_scratch"),
                     args.seg_epochs, "scratch", args.device)
    print(f"transfer delta: iou {ev_pre['iou'] - ev_scr['iou']:+.4f}, "
          f"seg_acc {ev_pre['seg_accuracy'] - ev_scr['seg_accuracy']:+.4f}")
    return ev_pre, ev_scr


if __name__ == "__main__":
    main()
