#!/usr/bin/env python3
"""How far rounding-sized changes of the weights move the part segmenter's
gradients, with batch statistics and with the running statistics.

    python3 tools/torch_grad_sensitivity.py [--device cuda|cpu] [--draws 6]

A float32 ``tiny_test`` segmenter (dropout off) takes one forward and
backward on a batch of 4 random clouds with random part labels.  Every
weight is then scaled by 1 + 2e-7 x a normal draw, the size of float32
rounding, and the gradients are taken again.  For each of three batches
and each draw the script prints the largest move of any gradient entry as
a share of its tensor's largest entry, once in train mode (BatchNorm on
batch statistics) and once with the running statistics.

With batch statistics BatchNorm centres every pre-activation on zero, so a
change of that size flips ReLUs and pooling winners; a flip reroutes a
row's whole contribution, and the gradient jumps.  This is why a gradient
of this model from two devices, or from two point orders, is compared
with the running statistics.  The last line is a JSON object of all
readings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

SCALE = 2e-7


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--draws", type=int, default=6)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from sonet_torch import config, train
    from sonet_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config.tiny_test().replace(task="segment", classes=50,
                                     batch_size=4, dropout=0.0)
    B, N, M = 4, cfg.input_pc_num, cfg.node_num

    def batch(seed):
        rs = np.random.RandomState(seed)
        pc = rs.randn(B, N, 3).astype(np.float32)
        arrays = {"pc": pc, "sn": rs.randn(B, N, 3).astype(np.float32),
                  "node": pc[:, :M] + 0.1 * rs.randn(B, M, 3).astype(
                      np.float32),
                  "label": rs.randint(0, 16, B).astype(np.int32),
                  "seg": rs.randint(0, cfg.classes, (B, N))}
        return {k: torch.from_numpy(v).to(args.device)
                for k, v in arrays.items()}

    def grads(b, train_mode, draw):
        model = build_model(cfg, device=args.device, seed=0)
        if draw is not None:
            gen = torch.Generator().manual_seed(draw)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_((1 + SCALE * torch.randn(
                        p.shape, generator=gen)).to(p.device))
        model.train(train_mode)
        score, _ = model(b["pc"], b["sn"], b["node"], b["label"], epoch=0)
        train.losses.cross_entropy_seg(score, b["seg"]).backward()
        return {n: p.grad.detach() for n, p in model.named_parameters()
                if p.grad is not None}

    out = {"device": args.device, "scale": SCALE, "cases": []}
    for train_mode in (True, False):
        stats = "batch" if train_mode else "running"
        for seed in range(3):
            b = batch(seed)
            base = grads(b, train_mode, None)
            moves = []
            for draw in range(args.draws):
                got = grads(b, train_mode, draw)
                share = {n: float((got[n] - g).abs().max())
                         / max(float(g.abs().max()), 1e-3)
                         for n, g in base.items()}
                worst = max(share, key=share.get)
                moves.append((share[worst], worst))
            out["cases"].append({"statistics": stats, "batch": seed,
                                 "largest_move": [m for m, _ in moves]})
            top = max(moves)
            print(f"{stats:7s} statistics, batch {seed}: largest move of a "
                  f"gradient entry over {args.draws} draws, as a share of "
                  f"its tensor's largest entry: "
                  + " ".join(f"{m:.1e}" for m, _ in moves)
                  + f"; worst in {top[1]}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
