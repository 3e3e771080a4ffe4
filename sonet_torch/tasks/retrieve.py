"""SHREC16 retrieval driver (the reference's shrec16/test.py; port of the
JAX package's ``tasks/retrieve.py``): score the test split with a model,
rank it on the device, write one rank file a query, a gallery (with
matplotlib) and the metrics.

    sonet-torch retrieve --preset shrec16 --dataroot /path \\
        --checkpoint run/ckpt/step_00001234.pt [--output_dir ./retrieval]

Over several processes (``--distributed``, ``--mesh_shape``) every rank
scores its block of each batch, the scores are gathered, every rank
ranks them and process 0 writes the files.
"""

from __future__ import annotations

import os
import time

import torch

from .. import retrieval, train
from ..config import parse_args
from ..data.pipeline import BatchLoader
from ..parallel import is_main
from ..parallel.mesh import setup_mesh
from ..train.trainer import build_dataset
from . import device_parser, pictures


def main(argv=None):
    pre = device_parser()
    pre.add_argument("--output_dir", default="./retrieval")
    pre.add_argument("--checkpoint", default=None,
                     help="full train-state checkpoint to load")
    known, rest = pre.parse_known_args(argv)
    cfg = parse_args(rest, preset="shrec16")
    cfg, mesh, dev = setup_mesh(cfg, known.device)
    main_rank = is_main()
    gallery = pictures("the retrieval gallery") if main_rank else False

    test_set = build_dataset(cfg, "test", dev)
    loader = BatchLoader(test_set, cfg.batch_size, shuffle=False,
                         drop_last=False, pad_last=True)
    # the JAX package draws one batch here as its example input, which
    # moves the loader to its next epoch and so the shapes' point draws;
    # skipping that pass scores the same points as it does
    loader.skip_epoch()
    state = train.init_state(cfg, device=dev, seed=cfg.seed, mesh=mesh)
    if known.checkpoint:
        train.restore_checkpoint(known.checkpoint, state)
    _, eval_step = train.make_steps(cfg, 1, mesh=mesh)

    def device_batch(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()
                if k != "valid"}

    t0 = time.perf_counter()
    scores, labels, ids = retrieval.extract_scores(
        eval_step, state, loader, device_batch,
        scan_chunk=max(1, min(16, (len(loader) + 1) // 2)), mesh=mesh)
    t1 = time.perf_counter()
    results = retrieval.rank_all(torch.from_numpy(scores).to(dev))
    t2 = time.perf_counter()
    metrics = retrieval.retrieval_metrics(results, labels)
    if not main_rank:
        return metrics
    print(f"scored {len(scores)} shapes in {(t1 - t0) * 1e3:.4f} ms, ranked "
          f"them on {dev} in {(t2 - t1) * 1e3:.4f} ms (host clock)")
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
