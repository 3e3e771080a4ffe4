"""SHREC16 retrieval driver (the reference's shrec16/test.py; port of the
JAX package's ``tasks/retrieve.py``): score the test split with a model,
rank it on the device, write one rank file a query, a gallery (with
matplotlib) and the metrics.

    sonet-torch retrieve --preset shrec16 --dataroot /path \\
        --checkpoint run/ckpt/step_00001234.pt [--output_dir ./retrieval]
"""

from __future__ import annotations

import math
import os
import time

import torch

from .. import retrieval, train
from ..config import parse_args
from ..data.pipeline import BatchLoader
from ..device import resolve_device
from ..train.trainer import build_dataset
from . import device_parser, pictures


def main(argv=None):
    pre = device_parser()
    pre.add_argument("--output_dir", default="./retrieval")
    pre.add_argument("--checkpoint", default=None,
                     help="full train-state checkpoint to load")
    known, rest = pre.parse_known_args(argv)
    cfg = parse_args(rest, preset="shrec16")
    if math.prod(cfg.mesh_shape) > 1:
        raise NotImplementedError(
            f"mesh_shape {tuple(cfg.mesh_shape)}: the port ranks on one "
            f"device; meshes are ROADMAP.md §1 item 12")
    dev = resolve_device(known.device)
    gallery = pictures("the retrieval gallery")

    test_set = build_dataset(cfg, "test", dev)
    loader = BatchLoader(test_set, cfg.batch_size, shuffle=False,
                         drop_last=False, pad_last=True)
    state = train.init_state(cfg, device=dev, seed=cfg.seed)
    if known.checkpoint:
        train.restore_checkpoint(known.checkpoint, state)
    _, eval_step = train.make_steps(cfg, 1)

    def device_batch(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()
                if k != "valid"}

    t0 = time.perf_counter()
    scores, labels, ids = retrieval.extract_scores(eval_step, state, loader,
                                                   device_batch)
    t1 = time.perf_counter()
    results = retrieval.rank_all(torch.from_numpy(scores).to(dev))
    t2 = time.perf_counter()
    print(f"scored {len(scores)} shapes in {(t1 - t0) * 1e3:.4f} ms, ranked "
          f"them on {dev} in {(t2 - t1) * 1e3:.4f} ms (host clock)")
    metrics = retrieval.retrieval_metrics(results, labels)
    retrieval.write_rank_files(results, ids, known.output_dir)
    print(f"wrote {len(results)} rank files to {known.output_dir}")
    if gallery:
        path = retrieval.write_retrieval_gallery(
            results, ids, test_set, os.path.join(known.output_dir, "gallery"))
        print(f"gallery at {path}")
    print({k: round(v, 4) for k, v in metrics.items()})
    return metrics


if __name__ == "__main__":
    main()
