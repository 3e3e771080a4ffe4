"""Metric logging and step timing (port of the JAX package's
``utils/logging.py``; stdlib only).

``MetricLogger`` prints each record and appends it to
``<out_dir>/<name>_metrics.jsonl`` and to one CSV per metric family
(``train_``, ``test_``), in place of the reference's visdom server.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    """Console + JSONL + CSV metric sink."""

    def __init__(self, out_dir: Optional[str] = None, name: str = "train",
                 quiet: bool = False):
        self.quiet = quiet
        self.jsonl = None
        self.out_dir = out_dir
        self.name = name
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self.jsonl = open(os.path.join(out_dir, f"{name}_metrics.jsonl"),
                              "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float], *, epoch=None,
            prefix: str = "") -> None:
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        if epoch is not None:
            rec["epoch"] = int(epoch)
        for k, v in metrics.items():
            try:
                rec[prefix + k] = float(v)
            except (TypeError, ValueError):
                continue
        if not self.quiet:
            parts = [f"{k}: {v:.6g}" if isinstance(v, float) else f"{k}: {v}"
                     for k, v in rec.items()]
            print("  ".join(parts), flush=True)
        if self.jsonl:
            self.jsonl.write(json.dumps(rec) + "\n")
        if self.out_dir:
            # one CSV per metric family (prefix): train_ and test_ rows
            # have different key sets, so sharing a file would misalign
            # columns against the single header
            fam = prefix.rstrip("_") or "misc"
            path = os.path.join(self.out_dir,
                                f"{self.name}_{fam}_metrics.csv")
            exists = os.path.exists(path)
            with open(path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(rec.keys()),
                                   extrasaction="ignore")
                if not exists:
                    w.writeheader()
                w.writerow(rec)

    def close(self):
        if self.jsonl:
            self.jsonl.close()


class StepTimer:
    """Wall-clock time of the steps in its ``with`` blocks, the first
    ``warmup`` left out.

    Torch launches work on a card and returns before it is done, so with a
    CUDA ``device`` the timer waits for the card (``torch.cuda.synchronize``)
    before it reads the clock at either end of a block; without one it
    reads the host clock only."""

    def __init__(self, warmup: int = 2, device=None):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._t = None
        self._sync = None
        if device is not None:
            import torch
            dev = torch.device(device)
            if dev.type == "cuda":
                self._sync = lambda: torch.cuda.synchronize(dev)

    def __enter__(self):
        if self._sync:
            self._sync()
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync:
            self._sync()
        dt = time.perf_counter() - self._t
        self.count += 1
        if self.count > self.warmup:
            self.total += dt

    @property
    def mean(self) -> float:
        n = max(self.count - self.warmup, 1)
        return self.total / n
